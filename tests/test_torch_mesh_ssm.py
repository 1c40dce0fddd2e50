"""The hybrid and ssm LMs' training step partitioned over a mesh, on 8 gloo
ranks, against the reference's step on 8 forced host devices; and the
pieces it is built of, on 4 gloo ranks, against one-rank computations.

The harness is ``tests/test_torch_mesh_lm.py``'s (its reference script,
its limits, its conversions): jax subprocesses with
``--xla_force_host_platform_device_count=8`` run the reference's
``launch/steps.py: make_train_step`` jitted under ``NamedSharding`` for two
steps at batch 4 x 16 in each cell, two cells a subprocess, each under a
120 s timeout; then 8 gloo ranks of the port run ``make_train_step(cfg,
mesh=...)`` from the reference's initial params cut to each rank's shards.
The cells:

  (a) zamba2-1.2b smoke on (2, 4): d_inner 128 and 8 SSD heads over a
      model axis of 4, the shared block's 4 heads and d_ff over it too;
      ZeRO-1 splits the groups' state over their first stacked dim G;
  (b) mamba2-2.7b smoke on (2, 4): the tied head vocab-parallel, the
      layers' state split by layer over "data";
  (c) zamba2-1.2b smoke on (2, 2, 2) ("pod", "data", "model");
  (d) mamba2-2.7b smoke on (1, 8) with ``ssm_headdim=32``: 4 heads do not
      divide 8, d_inner does: the mixed layout (x's block gathered, every
      head on every rank, the output cut back to the block);
  (e) zamba2-1.2b smoke on (4, 2): G = 2 and m = 2 too few for 4 data
      ranks, so ZeRO-1 splits a real dim;
  (f) mamba2-2.7b smoke on (2, 4) with ``ssm_ngroups=2``: each rank's scan
      reads the one B / C group its 2 heads fall in.

The limits are ``tests/test_torch_mesh_lm.py``'s: losses and grad norms
rtol 1e-5; step 1's raw gradients within 1e-4 of each leaf's largest
|value|; after two steps ``m`` within 1e-4, ``v`` within 1e-3, params and
``master`` within 1e-3 x lr with under 0.1% of entries outside and none
past 2 x steps x lr; data replicas bitwise equal; each rank's AdamW bytes
those of the dry run; the plain SSD (and, for zamba2, flash) versions
ran. Then the launcher's drill over (2, 4) at zamba2's smoke config
resumes bitwise.

The unit checks, on 4 gloo ranks of a (1, 4) mesh: ``collectives.psum``
and ``gather_from_axis`` forward and backward, ``layers.sharded_rms_norm``
and ``mamba2.train_stack`` in each layout (heads over "model", groups
split over the ranks two ways, the mixed layout) against the whole
computation on one rank; and on a (4, 1) mesh, ``Zero1`` split along the
hybrid's first stacked dim, its second, and a real dim, each AdamW step
bitwise equal to the one-card step.
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
from test_torch_mesh_lm import (B1, BATCH, LR, REF_SCRIPT, SEQ, SRC, STEPS, _flat,
                                _leaves_close, _nested, _zeros_like)

N_RANKS = 8
#: cell -> (arch, mesh shape, config overrides)
CELLS = {"a": ("zamba2-1.2b", (2, 4), {}), "b": ("mamba2-2.7b", (2, 4), {}),
         "c": ("zamba2-1.2b", (2, 2, 2), {}), "d": ("mamba2-2.7b", (1, 8), {"ssm_headdim": 32}),
         "e": ("zamba2-1.2b", (4, 2), {}), "f": ("mamba2-2.7b", (2, 4), {"ssm_ngroups": 2})}
#: the cells of each reference subprocess (each well inside its 120 s)
REF_GROUPS = ("ab", "cd", "ef")


def _cfg(cell):
    from repro_torch.configs import get_smoke_config

    arch, shape, over = CELLS[cell]
    return dataclasses.replace(get_smoke_config(arch), **over)


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _cell_rank(cell, mesh, ref, out) -> None:
    """One cell's two steps on this rank; what it got goes into ``out``."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import tree_bytes_per_device
    from repro_torch.models import api
    from repro_torch.optim import AdamW
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel.sharding import data_index, mesh_axes

    cfg, ax = _cfg(cell), mesh_axes(mesh)
    params0 = _nested(ref, f"{cell}|params0")
    step, opt = S.make_train_step(cfg, lr=LR, mesh=mesh)
    params, want = convert.lm_train_state_to_rank(
        params0, {"m": _zeros_like(params0), "v": _zeros_like(params0), "master": params0,
                  "t": np.zeros((), np.int32)}, cfg, mesh)
    state = opt.init(params)
    out[f"{cell}|init_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(want))))
    spec = S.train_step_specs(cfg, mesh)
    _, abs_state = S.abstract_state(cfg, mesh, AdamW())
    out[f"{cell}|opt_bytes"] = np.array(sum(t.numel() * t.element_size()
                                            for t in tree_leaves(state)))
    out[f"{cell}|opt_bytes_dryrun"] = np.array(tree_bytes_per_device(spec["opt"], abs_state, ax))

    grads, real_clip = [], S.clip_by_global_norm
    plain = {"ssd_chunk_scan_ref": [], "flash_attention_ref": []}
    real = {n: getattr(kref, n) for n in plain}

    def spy_clip(g, *a, **k):
        if not grads:
            grads.extend(t.clone() for t in g)
        return real_clip(g, *a, **k)

    def spy(name):
        def call(*a, **k):
            plain[name].append(1)
            return real[name](*a, **k)
        return call

    S.clip_by_global_norm = spy_clip
    for n in plain:
        setattr(kref, n, spy(n))
    ops.reset_launch_counts()
    b = BATCH // ax.data_size
    lo = data_index(mesh) * b
    try:
        for i in range(STEPS):
            batch = api.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=i)
            params, state, m = step(params, state, {k: v[lo:lo + b] for k, v in batch.items()})
            out[f"{cell}|loss{i}"] = m["loss"].numpy()
            out[f"{cell}|gnorm{i}"] = m["grad_norm"].numpy()
    finally:
        S.clip_by_global_norm = real_clip
        for n, fn in real.items():
            setattr(kref, n, fn)
    out[f"{cell}|launches"] = np.array(sum(ops.launch_counts().values()))
    for n, calls in plain.items():
        out[f"{cell}|{n}_calls"] = np.array(len(calls))
    for name, leaves in (("grads1", grads), ("params", tree_leaves(params)),
                         ("m", tree_leaves(state["m"])), ("v", tree_leaves(state["v"])),
                         ("master", tree_leaves(state["master"]))):
        for j, t in enumerate(leaves):
            out[f"{cell}|{name}|{j}"] = t.detach().float().numpy()
    out[f"{cell}|t"] = state["t"].numpy()


def _init_gloo(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every cell's port side, saved for the test process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _init_gloo(rank, world, tmp)
    ref = {}
    for g in REF_GROUPS:
        ref.update(dict(np.load(os.path.join(tmp, f"ref_{g}.npz"))))
    out = {}
    for cell, (_, shape, _) in CELLS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=_names(shape))
        _cell_rank(cell, mesh, ref, out)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


def _run_spawned(fn: str, tmp: str) -> None:
    env = dict(os.environ, PYTHONPATH=SRC)
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[2]); "
                            f"import test_torch_mesh_ssm as t; t.{fn}(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=env, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's arrays and each port rank's, as dicts."""
    tmp = str(tmp_path_factory.mktemp("mesh_ssm"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    for g in REF_GROUPS:
        cells = json.dumps({c: CELLS[c] for c in g})
        with cpu_lock(tmp):
            r = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                                os.path.join(tmp, f"ref_{g}.npz"), str(LR), str(BATCH),
                                str(SEQ), str(STEPS), cells],
                               capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0 and "REF-OK" in r.stdout, r.stderr[-3000:]
    _run_spawned("_spawn", tmp)
    ref = {}
    for g in REF_GROUPS:
        ref.update(dict(np.load(os.path.join(tmp, f"ref_{g}.npz"))))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{i}.npz"))) for i in range(N_RANKS)]
    return {"ref": ref, "ranks": ranks}


def _gathered(runs, cell, name, zero1=False):
    """The ranks' shards of one tree, put back together in the reference's
    layout (``convert.lm_tree_from_ranks``)."""
    from repro_torch import convert

    _, shape, _ = CELLS[cell]
    leaves = []
    for got in runs["ranks"]:
        n = sum(1 for k in got if k.startswith(f"{cell}|{name}|"))
        leaves.append([got[f"{cell}|{name}|{j}"] for j in range(n)])
    return convert.lm_tree_from_ranks(leaves, _cfg(cell), shape, _names(shape), zero1=zero1)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_losses_and_grad_norms_match_the_reference(runs, cell):
    ref = runs["ref"]
    for rank, got in enumerate(runs["ranks"]):
        for i in range(STEPS):
            np.testing.assert_allclose(got[f"{cell}|loss{i}"], ref[f"{cell}|loss{i}"],
                                       rtol=1e-5, err_msg=f"rank {rank} step {i}")
            np.testing.assert_allclose(got[f"{cell}|gnorm{i}"], ref[f"{cell}|gnorm{i}"],
                                       rtol=1e-5, err_msg=f"rank {rank} step {i}")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_step1_gradients_match_the_reference(runs, cell):
    """Leaf by leaf: a replicated B / C weight whose gradient were only its
    rank's heads' share, or a normed input counted once per model rank,
    shows here."""
    ref = runs["ref"]
    scale = min(1.0, 1.0 / max(float(ref[f"{cell}|gnorm0"]), 1e-12))
    m1 = _nested(ref, f"{cell}|state1")["m"]

    def raw(tree):
        if isinstance(tree, dict):
            return {k: raw(v) for k, v in tree.items()}
        return np.asarray(tree, np.float64) / ((1 - B1) * scale)

    _leaves_close(_gathered(runs, cell, "grads1"), raw(m1), 1e-4, f"{cell} step-1 gradients")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_params_and_adamw_state_after_two_steps(runs, cell):
    ref = runs["ref"]
    want = _nested(ref, f"{cell}|state{STEPS}")
    assert all(int(got[f"{cell}|t"]) == int(want["t"]) == STEPS for got in runs["ranks"])
    _leaves_close(_gathered(runs, cell, "m", zero1=True), want["m"], 1e-4, f"{cell} m")
    _leaves_close(_gathered(runs, cell, "v", zero1=True), want["v"], 1e-3, f"{cell} v")
    flips = total = 0
    for name, got, wtree in (
            ("params", _gathered(runs, cell, "params"), _nested(ref, f"{cell}|params{STEPS}")),
            ("master", _gathered(runs, cell, "master", zero1=True), want["master"])):
        g, w = _flat(got), _flat(wtree)
        assert set(g) == set(w)
        for k in w:
            diff = np.abs(g[k] - w[k])
            assert (diff <= 2 * STEPS * LR + 1e-6).all(), (cell, name, k)
            flips += int((diff > 1e-3 * LR + 1e-6 * np.abs(w[k])).sum())
            total += diff.size
    assert flips <= 1e-3 * total, (cell, flips, total)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_data_replicas_are_bitwise_equal(runs, cell):
    """Ranks that differ only in their data coordinates hold the same
    params, bit for bit (no leaf of these families is sharded over data)."""
    _, shape, _ = CELLS[cell]
    tp, ranks = shape[-1], runs["ranks"]
    keys = [k for k in ranks[0] if k.startswith(f"{cell}|params|")]
    assert keys
    for rank, got in enumerate(ranks):
        first = ranks[rank % tp]  # the data-rank-0 replica of this model rank
        for k in keys:
            assert np.array_equal(got[k], first[k]), (cell, rank, k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_zero1_bytes_and_the_plain_path(runs, cell):
    """Each rank's AdamW state takes the bytes the dry run computes for it
    (``launch/dryrun.py: tree_bytes_per_device`` of the ZeRO-1 specs, whose
    ``lead`` splits the hybrid's groups by G in (a) and by layer in (b) and
    (f)); the state ``opt.init`` gives equals the reference's initial state
    cut by ``convert.lm_train_state_to_rank``; on the CPU the plain SSD
    versions (and zamba2's plain flash versions) ran and no kernel
    launched."""
    for got in runs["ranks"]:
        assert int(got[f"{cell}|opt_bytes"]) == int(got[f"{cell}|opt_bytes_dryrun"])
        assert bool(got[f"{cell}|init_equal"])
        assert int(got[f"{cell}|launches"]) == 0
        assert int(got[f"{cell}|ssd_chunk_scan_ref_calls"]) > 0
        assert (int(got[f"{cell}|flash_attention_ref_calls"]) > 0) == (
            CELLS[cell][0] == "zamba2-1.2b")


def test_zero1_specs_split_the_stacked_dims_as_the_reference():
    """The ZeRO-1 specs of the cells, restacked (``convert.specs_to_reference``),
    are the reference's: at (2, 4) every groups leaf splits its first
    stacked dim G over "data" (``wx`` ('data', None, None, 'model')); at
    (4, 2) G = 2 and m = 2 are too few, so ``wx`` splits d_model and the
    shared block's ``attn.wo`` its free dim; at (1, 8) with 4 heads ``wx``
    stays over "model" while ``wdt`` is whole."""
    from repro_torch.convert import specs_to_reference
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import train_step_specs

    def opt(cell):
        _, shape, _ = CELLS[cell]
        return specs_to_reference(train_step_specs(_cfg(cell), AbstractMesh(
            shape, _names(shape)))["opt"]["m"])

    a, e, d = opt("a"), opt("e"), opt("d")
    assert a["groups"]["wx"] == ("data", None, None, "model")
    assert a["tail"]["wx"] == (None, "data", "model")
    assert e["groups"]["wx"] == (None, None, "data", "model")
    assert e["shared"]["attn"]["wo"] == ("model", "data")
    assert d["layers"]["wx"] == ("data", None, "model") and d["layers"]["wdt"][-1] is None


# --------------------------------------------------------------------------- #
# the pieces, on 4 gloo ranks against one rank
# --------------------------------------------------------------------------- #
UNIT_RANKS = 4
#: mamba2's smoke layer at a model axis of 4: (config overrides, what it shows)
LAYERS = {"heads": ({}, "8 heads, 2 a rank; one B / C group, read whole"),
          "groups2": ({"ssm_ngroups": 2}, "2 groups of 4 heads: 2 ranks read each"),
          "groups4": ({"ssm_ngroups": 4}, "4 groups of 2 heads: one group a rank"),
          "mixed": ({"ssm_headdim": 64}, "2 heads do not divide 4: the mixed layout")}
#: ZeRO-1 over 4 data ranks: (G, m, the hybrid groups' leaf w's shape)
ZERO1 = {"G": (4, 2, (6, 3)), "m": (2, 4, (6, 3)), "dim": (2, 2, (8, 3))}


def _close(got, want, what, tol=1e-5, scale=None):
    """max |got - want| within ``tol`` of ``scale`` (want's largest |value|
    by default)."""
    if scale is None:
        scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    return {"what": what, "err": err, "scale": scale, "ok": err <= tol * max(scale, 1e-30)}


def _unit_collectives(mesh, r, out):
    from repro_torch.parallel import collectives as C

    g = torch.Generator().manual_seed(1)
    ts = torch.randn(UNIT_RANKS, 3, 5, generator=g, dtype=torch.float64)
    ws = torch.randn(UNIT_RANKS, 3, 5, generator=g, dtype=torch.float64)
    # psum: every rank's loss sum(w_r * sum_r' t_r'), on one rank
    whole = ts.clone().requires_grad_(True)
    want_y = whole.sum(0)
    (want_g,) = torch.autograd.grad((ws * want_y).sum(), whole)
    t = ts[r].clone().requires_grad_(True)
    y = C.psum(t, mesh)
    (got_g,) = torch.autograd.grad((ws[r] * y).sum(), t)
    out["psum_forward"] = _close(y.detach(), want_y.detach(), "psum forward", 1e-12)
    out["psum_backward"] = _close(got_g, want_g[r], "psum backward", 1e-12)
    # gather_from_axis: the same work on the gathered tensor on every rank
    whole = ts.clone().requires_grad_(True)
    want_y = torch.cat(whole.unbind(0), dim=-1)
    w = torch.randn(want_y.shape, generator=g, dtype=torch.float64)
    (want_g,) = torch.autograd.grad((w * want_y).sum(), whole)
    t = ts[r].clone().requires_grad_(True)
    y = C.gather_from_axis(t, mesh, dim=-1)
    (got_g,) = torch.autograd.grad((w * y).sum(), t)
    out["gather_forward"] = _close(y.detach(), want_y.detach(), "gather forward", 0.0)
    out["gather_backward"] = _close(got_g, want_g[r], "gather backward", 0.0)


def _unit_norm(mesh, r, out):
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(2)
    n = 16
    x = torch.randn(2, 3, n, generator=g)
    w = 1.0 + 0.1 * torch.randn(n, generator=g)
    gy = torch.randn(2, 3, n, generator=g)
    xw, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = L.rms_norm(xw, ww, 1e-5)
    want_dx, want_dw = torch.autograd.grad((want * gy).sum(), (xw, ww))
    b = n // UNIT_RANKS
    sl = slice(r * b, (r + 1) * b)
    xr, wr = x[..., sl].clone().requires_grad_(True), w[sl].clone().requires_grad_(True)
    got = L.sharded_rms_norm(xr, wr, 1e-5, n, mesh)
    dx, dw = torch.autograd.grad((got * gy[..., sl]).sum(), (xr, wr))
    out["norm_forward"] = _close(got.detach(), want.detach()[..., sl], "norm forward")
    out["norm_dx"] = _close(dx, want_dx[..., sl], "norm dx")
    out["norm_dw"] = _close(dw, want_dw[sl], "norm dw")


def _unit_layers(mesh, r, out):
    """Two mamba2 smoke layers (``train_stack``, each checkpointed) on this
    rank's shards against the whole layers on one rank: the output, dx and
    every leaf's gradient (the rank's block of a sharded leaf, the whole of
    a replicated one)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import mamba2 as M
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel.sharding import local_shard, mesh_axes, spec_leaves

    for name, (over, _) in LAYERS.items():
        cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"), **over)
        g = torch.Generator().manual_seed(3)
        layers = [M.init_mamba_layer(g, cfg, torch.device("cpu")) for _ in range(2)]
        x = torch.randn(2, 32, cfg.d_model, generator=g)
        gy = torch.randn(2, 32, cfg.d_model, generator=g)
        whole = [{k: v.clone().requires_grad_(True) for k, v in lp.items()} for lp in layers]
        xw = x.clone().requires_grad_(True)
        want = M.train_stack(cfg, whole, xw)
        want_g = torch.autograd.grad((want * gy).sum(), [xw] + tree_leaves(whole))
        spec = M.mamba_layer_specs(cfg, mesh_axes(mesh))
        specs = [s for _, s in spec_leaves([spec, spec])]
        mine = [{k: local_shard(v, spec[k], mesh).clone().requires_grad_(True)
                 for k, v in lp.items()} for lp in layers]
        xr = x.clone().requires_grad_(True)
        got = M.train_stack(cfg, mine, xr, mesh)
        got_g = torch.autograd.grad((got * gy).sum(), [xr] + tree_leaves(mine))
        res = [_close(got.detach(), want.detach(), f"{name} output"),
               _close(got_g[0], want_g[0], f"{name} dx")]
        for j, (a, b, s) in enumerate(zip(got_g[1:], want_g[1:], specs)):
            res.append(_close(a, local_shard(b, s, mesh), f"{name} grad {j} {tuple(s)}", 1e-4,
                              float(b.abs().max())))
        out[f"layer_{name}"] = res


def _unit_zero1(mesh, r, out):
    """AdamW with ``Zero1`` over 4 data ranks, 2 steps, against the one-card
    AdamW on the same gradients: the params bitwise equal, each state leaf
    this rank's block of the one-card leaf (empty for a layer another rank
    holds)."""
    from repro_torch.launch.steps import opt_state_specs
    from repro_torch.optim import AdamW
    from repro_torch.optim.optimizers import Zero1, tree_leaves, tree_map
    from repro_torch.parallel.sharding import P, mesh_axes

    for name, (G, m, shape) in ZERO1.items():
        g = torch.Generator().manual_seed(4)

        def layer():
            return {"w": torch.randn(shape, generator=g), "b": torch.randn(5, generator=g)}

        params = {"groups": [[layer() for _ in range(m)] for _ in range(G)],
                  "tail": [layer() for _ in range(4)], "norm": torch.randn(7, generator=g)}
        grads = [tree_map(lambda t: torch.randn(t.shape, generator=g), params)
                 for _ in range(2)]
        lspec = {"w": P(None, None), "b": P(None)}
        pspecs = {"groups": [[lspec] * m for _ in range(G)], "tail": [lspec] * 4,
                  "norm": P(None)}
        ospecs = opt_state_specs(None, mesh_axes(mesh), params, pspecs)["m"]
        z = Zero1(mesh, pspecs, ospecs)
        one, zero = AdamW(), AdamW(zero1=z)
        p1 = tree_map(torch.clone, params)
        pz = tree_map(torch.clone, params)
        s1, sz = one.init(p1), zero.init(pz)
        for gr in grads:
            one.step(p1, tree_map(torch.clone, gr), s1, 1e-2)
            zero.step(pz, tree_map(torch.clone, gr), sz, 1e-2)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(pz)))
        blocks = all(
            (z.block(a, e) is None and b.numel() == 0) or torch.equal(z.block(a, e), b)
            for k in ("m", "v", "master")
            for a, b, e in zip(tree_leaves(s1[k]), tree_leaves(sz[k]), z.plan))
        owned = [[bool(e[2]) for e in z.plan[j * 2:j * 2 + 2]]
                 for j in range(G * m)]  # per groups layer: its (b, w) leaves
        out[f"zero1_{name}"] = {
            "params_equal": same, "state_blocks": blocks,
            "kinds": sorted({e[0] for e in z.plan[:2 * G * m]}),
            "groups_lead": list(ospecs["groups"][0][0]["w"].lead),
            "owned_groups_layers": [all(o) for o in owned]}


def _unit_rank(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _init_gloo(rank, world, tmp)
    out = {}
    tp = init_device_mesh("cpu", (1, UNIT_RANKS), mesh_dim_names=("data", "model"))
    _unit_collectives(tp, rank, out)
    _unit_norm(tp, rank, out)
    _unit_layers(tp, rank, out)
    dp = init_device_mesh("cpu", (UNIT_RANKS, 1), mesh_dim_names=("data", "model"))
    _unit_zero1(dp, rank, out)
    with open(os.path.join(tmp, f"unit{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_units(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_unit_rank, args=(UNIT_RANKS, tmp), nprocs=UNIT_RANKS, join=True)


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_ssm_units"))
    _run_spawned("_spawn_units", tmp)
    out = []
    for r in range(UNIT_RANKS):
        with open(os.path.join(tmp, f"unit{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("check", ["psum_forward", "psum_backward", "gather_forward",
                                   "gather_backward"])
def test_psum_and_gather_from_axis_against_one_rank(units, check):
    """``psum``'s backward sums each rank's gradient over "model" (the
    gradient of every rank's loss, as on one rank); ``gather_from_axis``'s
    keeps the rank's block of a gradient every rank computed whole."""
    for r, got in enumerate(units):
        assert got[check]["ok"], (r, got[check])


@pytest.mark.parametrize("check", ["norm_forward", "norm_dx", "norm_dw"])
def test_sharded_rms_norm_against_one_rank(units, check):
    """The gated RMSNorm over a d_inner sharded 4 ways: the mean of squares
    over the whole dim, and its gradient through ``psum``, as
    ``layers.rms_norm`` on the whole tensor."""
    for r, got in enumerate(units):
        assert got[check]["ok"], (r, got[check])


@pytest.mark.parametrize("layout", sorted(LAYERS))
def test_sharded_mamba_layers_against_one_rank(units, layout):
    """Two checkpointed mamba2 layers at a model axis of 4 in each layout:
    the output and dx within 1e-5 of their largest |value| on one rank;
    every leaf's gradient (the rank's block, the replicated B / C weights'
    whole) within 1e-4 of the whole leaf's largest |value| (the one-card
    tier of the step-1 gradients: ``A_log``'s gradient sums terms of both
    signs, ~3e-5 apart in fp32 from fp64 already at one card)."""
    for r, got in enumerate(units):
        bad = [c for c in got[f"layer_{layout}"] if not c["ok"]]
        assert not bad, (r, bad)


@pytest.mark.parametrize("split", sorted(ZERO1))
def test_zero1_over_each_stacked_dim(units, split):
    """``Zero1`` over 4 data ranks splits the hybrid's ``groups[G][m]``
    along G (G = 4: a rank owns one group), along m (G = 2, m = 4: a rank
    owns one layer of each group) or, where neither divides, along a real
    dim; the ``tail`` list of 4 by layer. Two AdamW steps leave the params
    bitwise equal to the one-card step's, and each state leaf this rank's
    block of the one-card leaf."""
    G, m, _ = ZERO1[split]
    lead = {"G": ["data", None], "m": [None, "data"], "dim": [None, None]}[split]
    for r, got in enumerate(units):
        z = got[f"zero1_{split}"]
        assert z["params_equal"] and z["state_blocks"], (r, z)
        assert z["groups_lead"] == lead, (r, z)
        owned = z["owned_groups_layers"]
        if split == "G":
            assert z["kinds"] == ["lead"] and owned == [g == r for g in range(G)
                                                      for _ in range(m)]
        elif split == "m":
            assert z["kinds"] == ["lead"] and owned == [i == r for _ in range(G)
                                                      for i in range(m)]
        else:
            assert z["kinds"] == ["dim", "same"] and all(owned)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
DRILL = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--mesh", "2,4",
         "--steps", "4", "--batch", "4", "--seq-len", "16", "--ckpt-every", "2"]


def _drill_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the drill: the clean run, then the one with a failure at
    the 3rd step call; the rank writes whether they ended bitwise equal."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import FailureInjector

    _init_gloo(rank, world, tmp)
    res, printed = {}, {}
    for name, hook in (("clean", None), ("drill", FailureInjector(fail_at=[3]).maybe_fail)):
        args = train.build_parser().parse_args(DRILL + ["--ckpt-dir", os.path.join(tmp, name)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res[name] = train.train_lm(args, step_hook=hook)
        printed[name] = buf.getvalue()
    clean, drill = res["clean"], res["drill"]
    out = {"equal": all(torch.equal(a, b) for a, b in zip(
        tree_leaves((clean["params"], clean["opt_state"])),
        tree_leaves((drill["params"], drill["opt_state"])))),
        "restarts": [clean["report"].restarts, drill["report"].restarts],
        "causes": drill["report"].causes, "losses": [clean["losses"], drill["losses"]],
        "printed": printed, "rank_ckpt": sorted(os.listdir(os.path.join(tmp, "drill",
                                                                         f"rank{rank}")))}
    with open(os.path.join(tmp, f"drill{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn_drill(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_drill_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


def test_launcher_mesh_drill_resumes_bitwise(tmp_path):
    """``train_lm --arch zamba2-1.2b --mesh 2,4`` on 8 gloo ranks (the smoke
    config, 4 steps, checkpoints every 2 steps, each rank into
    ``rank{r}/``, the groups' AdamW state split over the data ranks): a
    failure at the 3rd step call restores every rank from its own step-2
    checkpoint, and each rank's params and AdamW state end bitwise equal to
    an uninterrupted run's; rank 0 alone prints ``done:``."""
    _run_spawned("_spawn_drill", str(tmp_path))
    for rank in range(N_RANKS):
        with open(tmp_path / f"drill{rank}.json") as f:
            got = json.load(f)
        assert got["equal"], rank
        assert got["restarts"] == [0, 1] and got["causes"] == [[2, "RuntimeError"]]
        clean, drill = got["losses"]
        assert len(clean) == 4 and all(np.isfinite(clean))
        assert drill[:2] + drill[-2:] == clean
        assert got["rank_ckpt"] == ["step_2", "step_4"]
        for name in ("clean", "drill"):
            assert ("done: steps=4" in got["printed"][name]) == (rank == 0), (rank, name)
