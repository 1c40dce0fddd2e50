"""The look-forward cache on an LM's token embedding over a (data, model)
mesh: the port's ``CachedEmbeddingLM(cfg, mesh=...)`` on 8 gloo ranks
against the reference's ``CachedEmbeddingLM(cfg, mesh, ...)`` on 8 forced
host devices.

A jax subprocess with ``--xla_force_host_platform_device_count=8``
(XLA's CPU thread pool cut to one thread: it shares the CPU with the
suite's other files) and the mesh's axes
``AxisType.Auto`` (the reference's scan fails on a carry sharded over
"data" under ``AxisType.Explicit``) runs two cells, each the reference's
``ScratchPipe`` over its ``CachedEmbeddingLM`` (params from
``jax.random.key(1)``, the model padded for the mesh), a host table of
``HostEmbeddingTable(V, D, seed=0)`` and STEPS batches of tokens drawn
from ``np.random.default_rng(0)`` (``tokens``: a fixed count of distinct
tokens a batch, repeated within it; labels: the tokens rolled by one),
with a scratchpad that evicts:

  (a) llama4-scout-17b-a16e smoke (V 256, D 64, 2 MoE layers) on (2, 4),
      4 x 16 tokens a step (40 distinct), 144 slots;
  (b) chatglm3-6b smoke (V 128, 4 heads padded to 8) on (1, 8), 4 x 8
      tokens a step (24 distinct), 76 slots.

It writes each cell's initial params, each step's loss, the final params
and the flushed host table. Then 8 gloo ranks of the port (``torch.multiprocessing``,
a ``FileStore`` in the test's own directory) run the same cells from the
reference's initial params cut to each rank's shards
(``convert.lm_params_to_rank``), each rank's ``ScratchPipe`` planning the
global batches. The limits are those of
``tests/test_torch_cached_embedding.py`` (the reference's own
``test_hlo_and_launch.py::test_cached_embedding_lm_matches_full_embedding``
bound for the losses):

  * each step's loss within rtol 1e-4 of the reference's, on every rank;
  * the params (the ranks' shards put back together,
    ``convert.lm_tree_from_ranks``) within 2e-4, the flushed host table
    within 2e-5;
  * every rank's scratchpad storage and flushed host table bitwise equal to
    rank 0's, and the params of ranks that differ only in their data
    coordinate bitwise equal;
  * the cache evicts, the same rows on every rank.

Last, a world-1 ``(1, 1)`` gloo run is bitwise the run without a mesh (the
losses, the params, the flushed table).
"""
import inspect
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_lock import cpu_lock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
N_RANKS, STEPS, LR = 8, 6, 1e-2
LOSS_RTOL, TABLE_ATOL, PARAM_ATOL = 1e-4, 2e-5, 2e-4
#: cell -> (arch, mesh shape, batch, seq, slots, distinct tokens a batch)
CELLS = {"a": ("llama4-scout-17b-a16e", (2, 4), 4, 16, 144, 40),
         "b": ("chatglm3-6b", (1, 8), 4, 8, 76, 24)}


def tokens(V, steps, B, S, n):
    """The batches' tokens, the same in the reference's subprocess (this
    function's source) and in the port: each batch holds ``n`` distinct
    tokens, every one at least once, so the reference's jitted step (shaped
    by the batch's unique slots) compiles once."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(steps):
        u = rng.choice(V, n, replace=False)
        t = np.concatenate([u, rng.choice(u, B * S - n)])
        out.append(rng.permutation(t).reshape(B, S))
    return np.stack(out).astype(np.int64)


REF_SCRIPT = inspect.getsource(tokens) + r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.core.cached_embedding import CachedEmbeddingLM
from repro.core.host_table import HostEmbeddingTable
from repro.core.pipeline import ScratchPipe
from repro.data.lookahead import LookaheadStream

out_path, steps, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
res = {}

def put(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{prefix}|{jax.tree_util.keystr(kp)}"] = np.asarray(v)

for cell, (arch, shape, B, S, slots, n) in json.loads(sys.argv[4]).items():
    cfg = get_smoke_config(arch)
    toks = tokens(cfg.vocab_size, steps, B, S, n)
    labels = np.roll(toks, -1, axis=2).astype(np.int32)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.set_mesh(mesh):
        lm = CachedEmbeddingLM(cfg, mesh, jax.random.key(1), lr=lr, emb_lr=lr)
        put(f"{cell}|params0", lm.params)
        host = HostEmbeddingTable(cfg.vocab_size, cfg.d_model, seed=0)
        pipe = ScratchPipe(host, num_slots=slots, train_fn=lm.train_fn)
        stream = LookaheadStream(iter([(toks[i], {"labels": jnp.asarray(labels[i])})
                                       for i in range(steps)]))
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        res[f"{cell}|losses"] = np.array([float(s.aux["loss"]) for s in stats])
        res[f"{cell}|evictions"] = np.array([s.n_evict for s in stats])
        res[f"{cell}|table"] = host.data.copy()
        put(f"{cell}|params", lm.params)
np.savez(out_path, **res)
print("REF-OK")
"""


def _nested(flat: dict, prefix: str) -> dict:
    """The arrays saved under ``prefix|<jax keystr>`` as a nested dict."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "|"):
            continue
        path = re.findall(r"\['([^']+)'\]", key[len(prefix) + 1:])
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _data(cell):
    from repro_torch.configs import get_smoke_config

    arch, _, B, S, _, n = CELLS[cell]
    cfg = get_smoke_config(arch)
    toks = tokens(cfg.vocab_size, STEPS, B, S, n)
    return cfg, toks, np.roll(toks, -1, axis=2).astype(np.int32)


def _run(cfg, toks, labels, slots, mesh=None, params=None, seed=None):
    """The port's ScratchPipe over ``CachedEmbeddingLM.train_fn`` -> (losses,
    evictions, flushed table, storage, params)."""
    from repro_torch.core.cached_embedding import CachedEmbeddingLM
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.pipeline import ScratchPipe
    from repro_torch.data.lookahead import LookaheadStream

    lm = CachedEmbeddingLM(cfg, lr=LR, emb_lr=LR, device="cpu", mesh=mesh, params=params,
                           seed=seed)
    host = HostEmbeddingTable(cfg.vocab_size, cfg.d_model, seed=0)
    pipe = ScratchPipe(host, slots, lm.train_fn, device="cpu")
    stream = LookaheadStream(iter([(toks[i], {"labels": labels[i]}) for i in range(STEPS)]))
    try:
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        storage = pipe.storage.clone()
        pipe.flush_to_host()
    finally:
        pipe.close()
    return ([float(s.aux["loss"]) for s in stats], [s.n_evict for s in stats],
            host.data.copy(), storage, lm.params)


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: both cells from the reference's params, saved for the
    test process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.optim.optimizers import tree_leaves

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    out = {}
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    for cell, (_, shape, _, _, slots, _) in CELLS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        cfg, toks, labels = _data(cell)
        params = convert.lm_params_to_rank(_nested(ref, f"{cell}|params0"), cfg, mesh,
                                           without=("embed",))
        losses, evictions, table, storage, params = _run(cfg, toks, labels, slots, mesh,
                                                          params=params)
        out[f"{cell}|losses"] = np.array(losses)
        out[f"{cell}|evictions"] = np.array(evictions)
        out[f"{cell}|table"] = table
        out[f"{cell}|storage"] = storage.numpy()
        for j, t in enumerate(tree_leaves(params)):
            out[f"{cell}|params|{j}"] = t.detach().float().numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


def _lower_priority() -> None:
    """The gloo ranks yield the CPU to the suite's other files, whose
    reference subprocesses run under a time limit (as this file's does)."""
    os.nice(5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's arrays per cell and each port rank's, as dicts."""
    tmp = str(tmp_path_factory.mktemp("mesh_cached"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c", REF_SCRIPT, os.path.join(tmp, "ref.npz"),
                            str(STEPS), str(LR), json.dumps(CELLS)], capture_output=True,
                           text=True, env=env, timeout=120)
    assert r.returncode == 0 and "REF-OK" in r.stdout, r.stderr[-3000:]
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[2]); "
                            "import test_torch_mesh_cached_embedding as t; t._spawn(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=SRC),
                           timeout=300, preexec_fn=_lower_priority)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    ref = {c: {k[len(c) + 1:]: v for k, v in ref.items() if k.startswith(c + "|")}
           for c in CELLS}
    ranks = [dict(np.load(os.path.join(tmp, f"rank{i}.npz"))) for i in range(N_RANKS)]
    return {"ref": ref, "ranks": ranks}


def _gathered(runs, cell):
    """The ranks' param shards put back together in the reference's layout,
    without the embedding (the host table holds it)."""
    from repro_torch import convert
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import mesh_axes, shard_slices, spec_leaves

    shape = CELLS[cell][1]
    cfg, names = _data(cell)[0], ("data", "model")
    ax = mesh_axes(AbstractMesh(shape, names))
    specs = spec_leaves(api.param_specs(cfg, ax))
    ranks = []
    for r, got in enumerate(runs["ranks"]):
        coords = dict(zip(names, (int(c) for c in np.unravel_index(r, shape))))
        leaves = [got[f"{cell}|params|{j}"] for j in range(len(specs) - 1)]
        # the embedding's slot (the first leaf, in sorted key order): zeros
        (path, spec), = [s for s in specs if s[0] == ("embed",)]
        assert specs.index((path, spec)) == 0
        shp = api.abstract_params(cfg, ax)["embed"].shape
        block = tuple(sl.stop - sl.start for sl in shard_slices(spec, shp, ax, coords))
        ranks.append([np.zeros(block, np.float32)] + leaves)
    tree = convert.lm_tree_from_ranks(ranks, cfg, shape, names)
    tree.pop("embed")
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_losses_match_the_reference(runs, cell):
    want = runs["ref"][cell]["losses"]
    assert int(runs["ref"][cell]["evictions"].sum()) > 0
    for rank, got in enumerate(runs["ranks"]):
        np.testing.assert_allclose(got[f"{cell}|losses"], want, rtol=LOSS_RTOL,
                                   err_msg=f"rank {rank}")
        assert np.array_equal(got[f"{cell}|evictions"], runs["ref"][cell]["evictions"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_params_and_table_match_the_reference(runs, cell):
    ref = runs["ref"][cell]
    np.testing.assert_allclose(runs["ranks"][0][f"{cell}|table"], ref["table"],
                               atol=TABLE_ATOL)
    got, want = _flat(_gathered(runs, cell)), _flat(_nested(ref, "params"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replicas_are_bitwise_equal(runs, cell):
    """Every rank's scratchpad and flushed host table equal rank 0's, bit
    for bit (the row gradients are summed in rank order, the same bits on
    every rank), and ranks that differ only in their data coordinate hold
    the same params in every leaf replicated over "data" (an FSDP leaf
    holds another block on each data rank)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import data_dims, mesh_axes, spec_leaves

    shape = CELLS[cell][1]
    ax = mesh_axes(AbstractMesh(shape, ("data", "model")))
    specs = api.param_specs(_data(cell)[0], ax)
    specs.pop("embed")
    keys = [f"{cell}|params|{j}" for j, (_, sp) in enumerate(spec_leaves(specs))
            if not data_dims(sp, ax)]
    ranks, tp = runs["ranks"], shape[-1]
    assert keys
    for rank, got in enumerate(ranks):
        for k in ("storage", "table"):
            assert np.array_equal(got[f"{cell}|{k}"], ranks[0][f"{cell}|{k}"]), (rank, k)
        first = ranks[rank % tp]  # the data-rank-0 replica of this model rank
        for k in keys:
            assert np.array_equal(got[k], first[k]), (rank, k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_world_1_mesh_is_the_one_card_run(cell):
    """A world-1 (1, 1) gloo group: the losses, the flushed table, the
    scratchpad and the params bitwise those of the run without a mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizers import tree_leaves

    cfg, toks, labels = _data(cell)
    slots = CELLS[cell][4]
    one = _run(cfg, toks, labels, slots, seed=3)
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        meshed = _run(cfg, toks, labels, slots, mesh, seed=3)
    finally:
        dist.destroy_process_group()
    assert one[0] == meshed[0] and one[1] == meshed[1] and sum(one[1]) > 0
    assert np.array_equal(one[2], meshed[2]) and torch.equal(one[3], meshed[3])
    a, b = tree_leaves(one[4]), tree_leaves(meshed[4])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_mesh_of_another_backend_is_refused():
    """The mesh's group must be the device's: gloo for ``device="cpu"``."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cached_embedding import CachedEmbeddingLM
    from repro_torch.launch.mesh import abstract_rank_mesh

    with abstract_rank_mesh((1, 1)) as mesh:  # a fake group, not gloo
        with pytest.raises(ValueError, match="needs gloo"):
            CachedEmbeddingLM(get_smoke_config("llama4-scout-17b-a16e"), seed=0,
                              device="cpu", mesh=mesh)
    assert not dist.is_initialized()


def test_local_params_cuts_only_the_params_it_is_told_the_tree_lacks():
    """``api.local_params`` cuts a tree without ``embed`` (the cached LM's)
    only when told so (``without=``); a tree that lacks a param by mistake
    raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import abstract_rank_mesh
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel.sharding import mesh_axes

    cfg = get_smoke_config("llama4-scout-17b-a16e")
    with abstract_rank_mesh((2, 4), rank=5) as mesh:
        params = api.init(cfg, torch.Generator().manual_seed(0), ax=mesh_axes(mesh))
        whole = api.local_params(params, cfg, mesh)
        params.pop("embed")
        with pytest.raises(KeyError):
            api.local_params(params, cfg, mesh)
        cut = api.local_params(params, cfg, mesh, without=("embed",))
    assert set(cut) == set(whole) - {"embed"}
    for k in cut:
        a, b = tree_leaves(cut[k]), tree_leaves(whole[k])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
