"""The dry run's memory and collective schedule: one rank's step on ``meta``
shards over a fake process group (``launch/dryrun.py: rank_step``,
``launch/mesh.py: abstract_rank_mesh``).

  * At (2, 4), for chatglm3-6b's smoke train step, mixtral-8x7b's with
    ``fsdp=True``, zamba2-1.2b's smoke prefill, mamba2-2.7b's smoke decode
    step and the smoke DLRM's full-table step, the dry run's collective
    records for ranks 0 and 7 equal, kind by kind in count and bytes, what
    those ranks record when 8 gloo ranks (spawned as
    ``tests/test_torch_mesh.py`` spawns them) run the same step on real
    tensors.
  * ``launch/hlo_stats.py: LiveBytes`` over ``meta`` tensors equals the
    same tracker over real CPU tensors byte for byte (peak, what lives at
    the end, the outputs), when both take the plain versions.
  * Inside ``ops.kernel_footprint`` the kernels' wrappers allocate on
    ``meta`` what their CUDA wrappers allocate (outputs, ``lse``, the
    backward's workspaces, the sort in front of ``scatter_add``) and no
    plain version runs.
  * Production cells (``run_cell``): ``memory`` has the reference's keys,
    ``argument_size_in_bytes`` equals ``arg_bytes_per_device["total"]``,
    ``flops`` is unchanged (the values the dry run computed before it ran
    the step, in two cells), chatglm3-6b ``train_4k``'s peak at 2x16x16 is
    below its peak at 16x16, and chatglm3-6b ``prefill_32k``'s temp at
    16x16 is below one plain-version score tensor, 2 x 2 x 32768^2 x 4 B.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_lock import cpu_lock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
N_RANKS, SHAPE = 8, (2, 4)
#: cell -> (arch, config overrides, kind, seq, batch)
CELLS = {"chatglm3-6b train": ("chatglm3-6b", {}, "train", 16, 4),
         "mixtral-8x7b fsdp train": ("mixtral-8x7b", {"fsdp": True}, "train", 16, 4),
         "zamba2-1.2b prefill": ("zamba2-1.2b", {}, "prefill", 16, 4),
         "mamba2-2.7b decode": ("mamba2-2.7b", {}, "decode", 16, 4),
         "dlrm full-table": ("dlrm-scratchpipe", {}, "train", 4, 8)}
KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
        "temp_size_in_bytes", "peak_memory_in_bytes"}
#: what the dry run computed before it ran the step (its flops pass is kept)
FLOPS = {("chatglm3-6b", "train_4k"): 54724892737667072,
         ("dlrm-scratchpipe", "dlrm_train"): 25199902720}


def _cell(cell):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec

    arch, over, kind, seq, batch = CELLS[cell]
    return (dataclasses.replace(get_smoke_config(arch), **over),
            ShapeSpec(cell, seq, batch, kind))


def _real_call(cfg, shape, mesh):
    """The step ``dryrun.rank_step`` runs, for this rank of ``mesh``, on
    real tensors: seeded params cut to the rank's shards, its data shard."""
    from repro_torch.configs.base import DLRMConfig
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import api, dlrm
    from repro_torch.parallel.sharding import local_shard, mesh_axes, tree_map_specs

    ax = mesh_axes(mesh)
    gen = torch.Generator().manual_seed(0)

    def own(tree, specs):
        return tree_map_specs(lambda sp, t: local_shard(t, sp, mesh).clone(), specs, tree)

    if isinstance(cfg, DLRMConfig):
        full = dlrm.init_full(cfg, gen, "cpu")
        specs = dlrm.full_specs(cfg, ax)
        params = {"tables": own(full["tables"], specs["tables"]), "mlps": full["mlps"]}
        B, T, L = shape.global_batch, cfg.num_tables, cfg.lookups_per_table
        batch = {"dense": torch.randn((B, cfg.num_dense_features), generator=gen),
                 "label": torch.randint(0, 2, (B,), generator=gen).float(),
                 "sparse_ids": torch.randint(0, min(cfg.table_rows or (cfg.rows_per_table,)),
                                             (B, T, L), generator=gen, dtype=torch.int32)}
        batch = own(batch, dryrun.dlrm_batch_specs(ax))
        return lambda: dryrun.dlrm_full_train_step(params, cfg, batch, mesh)
    params = api.local_params(api.init(cfg, gen, ax=ax), cfg, mesh)
    if shape.kind == "decode":
        dec, sp = steps.make_serve_step(cfg, mesh, shape)
        cache = own(api.init_cache(cfg, shape.global_batch, shape.seq_len, "cpu", ax),
                    sp["cache"])
        tokens = torch.zeros((shape.global_batch // ax.data_size, 1), dtype=torch.int32)
        return lambda: dec(params, cache, tokens, shape.seq_len - 1)
    batch = own(api.synth_batch(cfg, shape, seed=0), api.batch_specs(cfg, shape, ax))
    if shape.kind == "prefill":
        pre, _ = steps.make_prefill_step(cfg, mesh, shape)
        return lambda: pre(params, batch)
    step, opt = steps.make_train_step(cfg, mesh=mesh)
    state = opt.init(params)
    return lambda: step(params, state, batch)


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: each cell's step on real tensors, its collective
    records saved for the test process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import collectives as C

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=("data", "model"))
    out = {}
    for cell in CELLS:
        fn = _real_call(*_cell(cell), mesh)
        C.reset_collective_records()
        with torch.no_grad() if CELLS[cell][2] != "train" else torch.enable_grad():
            fn()
        out[cell] = C.collective_records()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


@pytest.fixture(scope="module")
def gloo_records(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dryrun_memory"))
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[2]); "
                            "import test_torch_dryrun_memory as t; t._spawn(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                           timeout=300, preexec_fn=lambda: os.nice(5))  # yield to other files
    assert r.returncode == 0, r.stderr[-3000:]
    out = []
    for i in range(N_RANKS):
        with open(os.path.join(tmp, f"rank{i}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("rank", [0, 7])
@pytest.mark.parametrize("cell", list(CELLS))
def test_collectives_equal_the_gloo_ranks(gloo_records, cell, rank):
    from repro_torch.launch import dryrun

    got = dryrun.rank_step(*_cell(cell), SHAPE, rank=rank)
    mem = got["memory"]
    assert set(mem) == KEYS
    assert mem["peak_memory_in_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    want = gloo_records[rank][cell]
    assert want, f"{cell}: the gloo rank ran no collective"
    colls = {k: v for k, v in got["collectives"].items() if k != "total"}
    assert colls == want
    assert got["collectives"]["total"]["count"] == sum(v["count"] for v in want.values())


def _one_card(cell, device):
    """(step fn, its arguments) at one card (no mesh) on ``device``: real
    seeded tensors on the CPU, their shapes on ``meta``."""
    from repro_torch.launch import steps
    from repro_torch.models import api

    cfg, shape = _cell(cell)
    meta = device == "meta"
    params = (api.abstract_params(cfg) if meta
              else api.init(cfg, torch.Generator().manual_seed(0)))
    if shape.kind == "decode":
        cache = (api.abstract_cache(cfg, shape.global_batch, shape.seq_len) if meta
                 else api.init_cache(cfg, shape.global_batch, shape.seq_len))
        tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=device)
        dec = api.make_decode_fn(cfg)
        return (lambda p, c, t: dec(p, c, t, shape.seq_len - 1)), (params, cache, tokens)
    batch = api.abstract_batch(cfg, shape) if meta else api.synth_batch(cfg, shape, seed=0)
    if shape.kind == "prefill":
        return api.make_prefill_fn(cfg), (params, batch)
    step, opt = steps.make_train_step(cfg)
    return step, (params, opt.init(params), batch)


@pytest.mark.parametrize("cell", ["chatglm3-6b train", "mixtral-8x7b fsdp train",
                                  "zamba2-1.2b prefill", "mamba2-2.7b decode"])
def test_live_bytes_on_meta_equal_the_cpu_s(cell):
    """The tracker over a one-card step on ``meta`` tensors and over the same
    step on real CPU tensors, both through the plain versions: the same
    peak, the same bytes alive at the end and the same outputs."""
    from repro_torch.launch.dryrun import tensors
    from repro_torch.launch.hlo_stats import LiveBytes

    seen = []
    for device in ("meta", "cpu"):
        fn, args = _one_card(cell, device)
        tracker = LiveBytes(device)
        held = tracker.hold(tensors(args))
        with torch.enable_grad(), tracker:
            out = fn(*args)
        del fn, args
        outs = {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in tensors(out)
                if t.device.type == device}
        seen.append((held, tracker.peak, tracker.live, sum(outs.values())))
        del out
    assert seen[0] == seen[1]
    assert seen[0][1] > seen[0][0]


def test_kernel_footprint_allocates_what_the_cuda_wrappers_do(monkeypatch):
    """Inside ``kernel_footprint`` a ``meta`` call of each kernel allocates
    its CUDA wrapper's tensors — the flash forward's output and ``lse``, the
    backward's dq, dk, dv, D and its split workspace; the SSD scan's y, h
    and bf16 workspace; the gather's bags; the scatter's sort and worklist
    — launches nothing and runs no plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.launch.hlo_stats import LiveBytes

    def never(*a, **k):
        raise AssertionError("a plain version ran in the footprint pass")

    for name in ("flash_attention_ref", "ssd_chunk_scan_ref", "ssd_chunk_scan_bwd_ref",
                 "gather_reduce_ref", "scatter_add_ref"):
        monkeypatch.setattr(ref, name, never)
    ops.reset_launch_counts()
    m = dict(device="meta")
    B, S, H, K, hd = 2, 256, 8, 2, 64
    q = torch.empty((B, S, H, hd), dtype=torch.bfloat16, requires_grad=True, **m)
    k = torch.empty((B, S, K, hd), dtype=torch.bfloat16, requires_grad=True, **m)
    v = torch.empty((B, S, K, hd), dtype=torch.bfloat16, requires_grad=True, **m)
    with ops.kernel_footprint():
        tracker = LiveBytes()
        tracker.hold([q, k, v])
        with torch.enable_grad(), tracker:
            o = ops.flash_attention(q, k, v, causal=True)
            fwd = tracker.live - (q.nbytes + k.nbytes + v.nbytes)
            g = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
        assert fwd == o.nbytes + B * H * S * 4  # the output and lse
        ws = fa.bwd_workspace_shape(B, S, H, K, hd)
        extra = 0 if ws is None else int(np.prod(ws)) * 4
        # at the backward launch: the forward's output, lse and the
        # cotangent, then dq, dk, dv, D and the workspace
        assert tracker.peak >= (q.nbytes + k.nbytes + v.nbytes + 2 * o.nbytes + B * H * S * 4
                                + sum(t.nbytes for t in g) + B * H * S * 4 + extra)
        x = torch.empty((1, 512, 4, 64), dtype=torch.bfloat16, **m)
        dt = torch.empty((1, 512, 4), **m)
        A = torch.empty((4,), **m)
        Bm = torch.empty((1, 512, 1, 64), **m)
        tracker = LiveBytes()
        with tracker:
            y, h = ops.ssd_chunk_scan(x, dt, A, Bm, Bm, 256)
        work = int(np.prod(ssd.workspace_shape(1, 512, 1, 64, 256))) * 4
        assert tracker.peak == y.nbytes + h.nbytes + work
        storage = torch.empty((100, 16), **m)
        ids = torch.empty((8, 4), dtype=torch.int32, **m)
        tracker = LiveBytes()
        with tracker:
            bags = ops.gather_reduce(storage, ids)
            assert tracker.live == bags.nbytes == 8 * 16 * 4
            ops.coalesce_apply(storage, ids, bags, 0.1)
        # the deltas, then the sort's keys (int32) and positions (int64)
        # and the worklist (2 + n // 65 int64)
        assert tracker.peak >= bags.nbytes * 2 + 32 * 4 + 32 * 8 + 2 * 8
    assert sum(ops.launch_counts().values()) == 0
    # outside the footprint pass meta tensors take the plain versions again
    assert ops._route(storage) == "cpu"


@pytest.fixture(scope="module")
def cells():
    from repro_torch.launch import dryrun

    out = {}
    for arch, shape, mp in (("chatglm3-6b", "train_4k", False),
                            ("chatglm3-6b", "train_4k", True),
                            ("chatglm3-6b", "prefill_32k", False),
                            ("chatglm3-6b", "decode_32k", True),
                            ("dlrm-scratchpipe", "dlrm_train", False)):
        out[(arch, shape, mp)] = dryrun.run_cell(arch, shape, mp)
    return out


def test_cells_record_the_reference_keys(cells):
    from repro_torch.launch import dryrun

    for (arch, shape, mp), rec in cells.items():
        mem = rec["memory"]
        assert set(mem) == KEYS, (arch, shape)
        assert mem["argument_size_in_bytes"] == rec["arg_bytes_per_device"]["total"]
        assert mem["temp_size_in_bytes"] == (mem["peak_memory_in_bytes"]
                                             - mem["argument_size_in_bytes"]) > 0
        assert rec["peak_fits_card"] == (mem["peak_memory_in_bytes"] <= dryrun.CARD_BYTES)
        assert rec["rank"] == 0 and "computed_not_measured" not in rec
        assert "fake process group of %d ranks" % rec["devices"] in rec["method"]["memory"]
        total = rec["collectives"]["total"]
        assert total["count"] == sum(v["count"] for k, v in rec["collectives"].items()
                                     if k != "total")
    train = cells[("chatglm3-6b", "train_4k", False)]
    # a train step writes its params and AdamW state in place
    assert train["memory"]["alias_size_in_bytes"] == (train["arg_bytes_per_device"]["total"]
                                                      - train["arg_bytes_per_device"]["batch"])
    assert train["collectives"]["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch,shape", sorted(FLOPS))
def test_flops_are_unchanged(cells, arch, shape):
    assert cells[(arch, shape, False)]["flops"] == FLOPS[(arch, shape)]


def test_more_data_ranks_lower_the_peak(cells):
    single = cells[("chatglm3-6b", "train_4k", False)]["memory"]["peak_memory_in_bytes"]
    multi = cells[("chatglm3-6b", "train_4k", True)]["memory"]["peak_memory_in_bytes"]
    assert multi < single


def test_prefill_temp_is_the_kernels_footprint(cells):
    """At 32k tokens one plain-version score tensor, (B, H, Sq, Skv) fp32 for
    a rank's 2 sequences and 2 heads, is 2 x 2 x 32768^2 x 4 B: the step's
    whole temp stays below it, so the flash kernel's footprint was counted."""
    temp = cells[("chatglm3-6b", "prefill_32k", False)]["memory"]["temp_size_in_bytes"]
    assert 0 < temp < 2 * 2 * 32768 ** 2 * 4


def test_abstract_rank_mesh_is_torn_down_and_named(monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch.mesh import abstract_rank_mesh

    with abstract_rank_mesh((2, 16, 16), rank=511) as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert list(mesh.get_coordinate()) == [1, 15, 15]
        with pytest.raises(RuntimeError, match="a process group is running"):
            with abstract_rank_mesh((1, 1)):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank 8"):
        with abstract_rank_mesh((2, 4), rank=8):
            pass
    monkeypatch.setitem(sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        with abstract_rank_mesh((1, 1)):
            pass
    assert not dist.is_initialized()
