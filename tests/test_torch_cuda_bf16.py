"""The bf16 forms of the embedding kernels against their plain PyTorch
versions, on the card: ``gather_reduce_bf16``, the converting ``fill_bf16``
(fp32 rows rounded into bf16 slots), ``fill_gather_reduce_bf16`` and
``scatter_add_bf16`` (each add rounded to bf16), and the bf16 scratchpad's
runtimes through them.

Every test carries the ``cuda`` marker and skips where no CUDA device is
visible (decided in a fixture, at run time). The file imports neither JAX
nor the JAX package (tests/test_torch_bf16_storage.py holds the plain
versions against the reference on the CPU), so on the card run it with the
repository's conftest skipped:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda_bf16.py

Comparisons are bitwise (``torch.equal`` on the 16 bits): the kernels add in
fp32 in the plain versions' order and round where they round (the bag once,
the fill's values once each, every add of the scatter), NaN included (the
card's 0x7FFF on both sides).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import scratchpad as tsp
from repro_torch.kernels import gather_reduce as tgr
from repro_torch.kernels import grad_coalesce as tgc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(0)
T = tgc.LONG_SEGMENT


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where none is visible (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m cuda")
    tops.reset_launch_counts()
    return torch.device("cuda")


def _bf16(N, D, dev, offset=0):
    """(N, D) bf16 storage on ``dev``; ``offset`` elements in, a view whose
    start breaks the 8- and 16-byte alignment of the vector paths."""
    flat = torch.from_numpy(RNG.standard_normal(N * D + offset).astype(np.float32))
    return flat.to(dev).to(torch.bfloat16)[offset:].view(N, D)


def _f32(shape, dev, offset=0):
    n = int(np.prod(shape))
    flat = torch.from_numpy(RNG.standard_normal(n + offset).astype(np.float32)).to(dev)
    return flat[offset:].view(*shape)


def _ids(shape, hi, dev):
    return torch.from_numpy(RNG.integers(0, hi, shape).astype(np.int32)).to(dev)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20, 40])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_gather_reduce_bf16_bitwise(cuda, D, L, offset):
    st = _bf16(500, D, cuda, offset)
    ids = _ids((37, L), 50, cuda)
    ids[5, 0] = -1  # a masked lookup: a zero row in its place
    out = tops.gather_reduce(st, ids)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _same(out, tref.gather_reduce_ref(st, ids))
    assert tops.launch_counts()["gather_reduce_bf16"] == 1
    assert tops.launch_counts()["gather_reduce"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 8, 40, 128, 192])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_fill_bf16_bitwise(cuda, D, offset):
    N, F = 300, 64
    st = _bf16(N, D, cuda)
    slots = torch.from_numpy(RNG.permutation(N)[:F].astype(np.int32)).to(cuda)
    slots[::7] = N  # drop sentinels
    rows = _f32((F, D), cuda, offset)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                            1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1e-40, -1e-45, 3.4e38],
                           device=cuda)
    rows[1].view(-1)[: min(D, special.numel())] = special[:D]
    want = tref.fill_ref(st.clone(), slots, rows)
    tops.fill(st, slots, rows)
    torch.cuda.synchronize()
    _same(st, want)
    assert tops.launch_counts()["fill_bf16"] == 1 and tops.launch_counts()["fill"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20])
def test_cuda_fill_gather_reduce_bf16_bitwise(cuda, D, L):
    N, F = 400, 96
    st = _bf16(N, D, cuda)
    slots = torch.from_numpy(RNG.permutation(N)[:F].astype(np.int32)).to(cuda)
    slots[-3:] = N
    rows = _f32((F, D), cuda)
    ids = _ids((45, L), N, cuda)
    ids[0, :] = slots[0]  # bags that read a row filled in the same launch
    ids[1, 0] = slots[1]
    want_st, want_bags = tref.fill_gather_reduce_ref(st.clone(), slots, rows, ids)
    got_st, bags = tops.fill_gather_reduce(st, slots, rows, ids)
    torch.cuda.synchronize()
    _same(got_st, want_st)
    _same(bags, want_bags)
    assert tops.launch_counts()["fill_gather_reduce_bf16"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 6, 8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20])
@pytest.mark.parametrize("id_hi", [8, 64, 500])
def test_cuda_scatter_add_bf16_bitwise(cuda, D, L, id_hi):
    st = _bf16(500, D, cuda)
    ids = _ids((200, L), id_hi, cuda)
    g = _f32((200, D), cuda).to(torch.bfloat16)
    want = tref.coalesce_apply_ref(st.clone(), ids, g, 0.05)
    tops.coalesce_apply(st, ids, g, 0.05)
    torch.cuda.synchronize()
    _same(st, want)
    assert tops.launch_counts()["scatter_add_bf16"] == 1
    assert tops.launch_counts()["scatter_add"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3, 6, 40, 128, 192])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("lens", [(T - 1,), (T,), (T + 1,), (65, 200, 64, 3000), (4000,)])
def test_cuda_scatter_add_bf16_segment_classes(cuda, D, offset, lens):
    """Segments at and around the long-segment threshold, several long ones,
    and a hot row among short ones; deltas ``offset`` elements into their
    buffer, so the long kernel's ring takes its 16-, 4- and 2-byte copies."""
    n_short = 2000
    ids = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)]
                         + [RNG.integers(len(lens), 900, n_short).astype(np.int32)])
    ids = torch.from_numpy(RNG.permutation(ids)[:, None].copy()).to(cuda)
    st = _bf16(1000, D, cuda)
    deltas = (_f32((ids.shape[0], D), cuda, offset) * 1e-2).to(torch.bfloat16)
    want = tref.scatter_add_ref(st.clone(), ids, deltas)
    tgc.scatter_add(st, ids, deltas)
    torch.cuda.synchronize()
    _same(st, want)


@pytest.mark.cuda
def test_cuda_scatter_add_bf16_rounds_every_add(cuda):
    """1,000 adds of 2^-9 to a row of 1.0 (below half a bf16 step): rounded
    add by add the row stays 1.0, in both segment classes."""
    st = torch.ones((4, 128), dtype=torch.bfloat16, device=cuda)
    ids = torch.zeros((1000, 1), dtype=torch.int32, device=cuda)
    ids[:30] = 1  # a short segment too
    deltas = torch.full((1000, 128), 2.0 ** -9, dtype=torch.bfloat16, device=cuda)
    want = tref.scatter_add_ref(st.clone(), ids, deltas)
    tgc.scatter_add(st, ids, deltas)
    torch.cuda.synchronize()
    _same(st, want)
    assert float(st[0, 0]) == 1.0


@pytest.mark.cuda
def test_cuda_bf16_launchers_check_operands(cuda):
    st = _bf16(16, 8, cuda)
    slots = torch.zeros(2, dtype=torch.int32, device=cuda)
    ids = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # a bf16 storage's fill rows are fp32
        tgr.fill(st, slots, torch.zeros((2, 8), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(TypeError):
        tgr.fill_gather_reduce(st, slots, torch.zeros((2, 8), dtype=torch.bfloat16,
                                                      device=cuda), ids)
    with pytest.raises(TypeError):  # the deltas are of the storage's dtype
        tgc.scatter_add(st, ids, torch.zeros((2, 8), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        tgr.gather_reduce(st.cpu(), ids)
    assert not any(tops.launch_counts().values())


@pytest.mark.cuda
def test_cuda_bf16_scratchpipe_split_fused_and_fast_path_bitwise(cuda):
    """A bf16 ScratchPipe on the card: split, fused and device+overlapped
    fused give bitwise-equal losses, scratchpads and flushed host tables,
    through the bf16 kernels only."""
    from repro_torch.configs import dlrm_scratchpipe as cfgs
    from repro_torch.core.dlrm_runtime import DLRMTrainer
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.pipeline import ScratchPipe
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.data.synthetic import TraceConfig, dlrm_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfgs.smoke_config()
    runs = []
    for fused, planner, executor in [(False, "host", "sync"), (True, "host", "sync"),
                                     (True, "device", "overlapped")]:
        host = HostEmbeddingTable(cfg.total_rows, cfg.embed_dim, seed=0)
        trainer = DLRMTrainer(cfg, seed=0, lr=0.05, device=cuda)
        pipe = ScratchPipe(host, 1024, trainer.train_fn, storage_dtype=torch.bfloat16,
                           past_window=cfg.past_window, future_window=cfg.future_window,
                           planner=planner, executor=executor, device=cuda,
                           fused_train_fn=trainer.fused_train_fn if fused else None)
        tc = TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                         lookups_per_table=cfg.lookups_per_table,
                         batch_size=cfg.batch_size, seed=0)
        stream = LookaheadStream(dlrm_batches(tc, 12))
        tops.reset_launch_counts()
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        pipe.close()
        counts = tops.launch_counts()
        assert sum(s.n_evict for s in stats) > 0  # the bf16 victims cross d2h
        assert counts["scatter_add_bf16"] == 12 and counts["scatter_add"] == 0
        assert counts["gather_reduce"] == counts["fill"] == counts["fill_gather_reduce"] == 0
        assert counts["gather_reduce_bf16"] + counts["fill_gather_reduce_bf16"] == 12
        assert (counts["fill_gather_reduce_bf16"] > 0) == fused
        assert pipe.storage.dtype == torch.bfloat16
        runs.append((torch.stack([s.aux["loss"] for s in stats]).cpu(),
                     pipe.storage.clone(), host.data.copy()))
    for losses, storage, table in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        _same(storage, runs[0][1])
        assert np.array_equal(table, runs[0][2])
    assert torch.isfinite(runs[0][0]).all()


@pytest.mark.cuda
def test_cuda_bf16_server_matches_the_cpu_server(cuda):
    """A bf16 ReadOnlyCacheServer on the card serves the bags its CPU twin
    (the plain versions) serves, bit for bit: serving has no MLP."""
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.serving_cache import ReadOnlyCacheServer
    from repro_torch.core.table_group import TableGroup
    from repro_torch.serving import replay_serving
    from repro_torch.traces import scenarios

    group = TableGroup.uniform(2, 400, 128)
    batches = [g for g, _ in scenarios.scenario_batches(
        "flash_crowd", group, 14, batch_size=16, lookups_per_table=5, seed=7)]
    res, counts = [], []
    for dev in (cuda, "cpu"):
        srv = ReadOnlyCacheServer(HostEmbeddingTable(800, 128, seed=7), 512, window=2,
                                  storage_dtype=torch.bfloat16, device=dev)
        tops.reset_launch_counts()
        res.append(replay_serving(srv, batches, depth=1, collect_bags=True))
        counts.append(tops.launch_counts())
        assert tsp.storage_precision(srv.storage) == "fp32"
    assert len(res[0]["bags"]) == len(batches)
    assert all(np.array_equal(a, b) for a, b in zip(res[0]["bags"], res[1]["bags"]))
    card, cpu = counts
    assert card["gather_reduce_bf16"] == len(batches) and card["fill_bf16"] > 0
    assert card["gather_reduce"] == card["fill"] == 0
    assert not any(cpu.values())
