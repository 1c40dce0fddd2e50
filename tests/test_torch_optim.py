"""The port's optimizers (``repro_torch/optim``) against the JAX package's
(``repro/optim``) on the same arrays, on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerances: fp32
results within rtol 1e-6 / atol 1e-7 of the reference's (the same
operations in the same order; ``pow`` and ``sqrt`` may differ in the last
place between XLA and torch), AdamW over several steps within rtol 1e-5 /
atol 1e-7 (those last places feed back through ``m`` and ``v``); bf16
params equal to the reference's or one bf16 step (2^-8 relative) apart,
where the fp32 masters they are rounded from straddle a rounding boundary.
The port updates in place; the reference returns new arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ropt
from repro_torch import optim as topt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim.optimizers import tree_leaves

RTOL, ATOL = 1e-6, 1e-7
STEPS_RTOL = 1e-5


def _arrays(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((6, 5)) * scale).astype(dtype),
        "layers": [{"a": (rng.standard_normal((4,)) * scale).astype(dtype),
                    "b": (rng.standard_normal((3, 2)) * scale).astype(dtype)}
                   for _ in range(2)],
    }


def _jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    return t if dtype is None else t.to(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    g = [t.float().numpy() for t in tree_leaves(got)]
    w = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (1e-3, 1.0), (1.0, 100.0)])
def test_global_norm_and_clip(scale, max_norm):
    """The norm, and the clipped grads: scaled when the norm is above
    ``max_norm``, unchanged below it."""
    g = _arrays(0, scale=scale)
    want_norm = ropt.global_norm(_jax(g))
    want, want_n = ropt.clip_by_global_norm(_jax(g), max_norm)
    got_t = _torch(g)
    np.testing.assert_allclose(float(topt.global_norm(got_t)), float(want_norm), rtol=RTOL)
    got, got_n = topt.clip_by_global_norm(got_t, max_norm)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=RTOL)
    _close(got, want)
    assert got is got_t  # in place


def test_clip_keeps_bf16_leaves_bf16():
    g = _arrays(1, scale=4.0)
    want, _ = ropt.clip_by_global_norm(_jax(g, jnp.bfloat16), 1.0)
    got, _ = topt.clip_by_global_norm(_torch(g, torch.bfloat16), 1.0)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(got))
    _close(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    p, ropt_sgd, topt_sgd = _arrays(2), ropt.SGD(momentum), topt.SGD(momentum)
    rp, tp = _jax(p), _torch(p)
    rs, ts = ropt_sgd.init(rp), topt_sgd.init(tp)
    for i in range(3):
        g = _arrays(10 + i)
        rp, rs = ropt_sgd.step(rp, _jax(g), rs, 0.1)
        tp, ts = topt_sgd.step(tp, _torch(g), ts, 0.1)
    _close(tp, rp)
    if momentum:
        _close(ts, rs)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("master_fp32", [True, False])
def test_adamw_matches_reference_fp32(weight_decay, master_fp32):
    """Five steps at fp32: params, m, v, master and t."""
    kw = dict(weight_decay=weight_decay, master_fp32=master_fp32)
    ro, to = ropt.AdamW(**kw), topt.AdamW(**kw)
    p = _arrays(3)
    rp, tp = _jax(p), _torch(p)
    rs, ts = ro.init(rp), to.init(tp)
    assert set(ts) == set(rs)
    leaves = tree_leaves(tp)
    for i in range(5):
        g = _arrays(20 + i)
        rp, rs = ro.step(rp, _jax(g), rs, 3e-3)
        tp2, ts2 = to.step(tp, _torch(g), ts, 3e-3)
        assert tp2 is tp and ts2 is ts  # in place
    assert all(a is b for a, b in zip(tree_leaves(tp), leaves))
    _close(tp, rp, rtol=STEPS_RTOL)
    for k in ("m", "v") + (("master",) if master_fp32 else ()):
        _close(ts[k], rs[k], rtol=STEPS_RTOL)
    assert int(ts["t"]) == int(rs["t"]) == 5 and ts["t"].dtype == torch.int32


def test_adamw_bf16_params_accumulate_in_the_fp32_master():
    """bf16 params, fp32 master: updates far below a bf16 step accumulate
    in the master (the params move once the master has moved a step), as
    in the reference."""
    ro, to = ropt.AdamW(), topt.AdamW()
    p = _arrays(4)
    rp, tp = _jax(p, jnp.bfloat16), _torch(p, torch.bfloat16)
    rs, ts = ro.init(rp), to.init(tp)
    p0 = [t.clone() for t in tree_leaves(tp)]
    for i in range(8):
        g = _arrays(30 + i)
        rp, rs = ro.step(rp, _jax(g, jnp.bfloat16), rs, 1e-4)
        to.step(tp, _torch(g, torch.bfloat16), ts, 1e-4)
    _close(ts["master"], rs["master"], rtol=STEPS_RTOL)
    _close(ts["m"], rs["m"], rtol=STEPS_RTOL)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(rp)):
        want = np.asarray(want, np.float32)
        diff = np.abs(got.float().numpy() - want)
        assert (diff <= 2 ** -8 * np.abs(want) + 1e-30).all()
    moved = sum(int((a != b).sum()) for a, b in zip(tree_leaves(tp), p0))
    master_moved = sum(int((m.bfloat16() != b).sum())
                       for m, b in zip(tree_leaves(ts["master"]), p0))
    assert moved == master_moved > 0


def test_adamw_state_checkpoints_as_a_plain_tree(tmp_path):
    """The state is a plain tree of tensors: CheckpointManager saves and
    restores it bitwise, and the restored state steps on identically."""
    to = topt.AdamW()
    tp = _torch(_arrays(5))
    ts = to.init(tp)
    to.step(tp, _torch(_arrays(40)), ts, 1e-3)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"params": tp, "opt": ts}, blocking=True)
    got, step = cm.restore({"params": tp, "opt": ts})
    assert step == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(
        {"params": tp, "opt": ts})))
    g = _torch(_arrays(41))
    to.step(tp, g, ts, 1e-3)
    to.step(got["params"], g, got["opt"], 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got["params"]), tree_leaves(tp)))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rowwise_adagrad_matches_reference(dtype):
    rng = np.random.default_rng(6)
    rows = rng.standard_normal((7, 8)).astype(np.float32)
    ro, to = ropt.RowWiseAdagrad(), topt.RowWiseAdagrad()
    racc, tacc = ro.init_rows(7), to.init_rows(7)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else (jnp.bfloat16,
                                                                          torch.bfloat16)
    rr, tr = jnp.asarray(rows, jdt), torch.from_numpy(rows).to(tdt)
    for i in range(3):
        g = rng.standard_normal((7, 8)).astype(np.float32)
        rr, racc = ro.step_rows(rr, jnp.asarray(g, jdt), racc, 0.05)
        tr, tacc = to.step_rows(tr, torch.from_numpy(g).to(tdt), tacc, 0.05)
    assert tr.dtype == tdt
    np.testing.assert_allclose(tacc.numpy(), np.asarray(racc), rtol=RTOL)
    rtol = RTOL if dtype is np.float32 else 2 ** -8
    np.testing.assert_allclose(tr.float().numpy(), np.asarray(rr, np.float32), rtol=rtol,
                               atol=ATOL)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 50, 99, 100, 150])
def test_warmup_cosine_matches_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100, min_frac=0.1)
    np.testing.assert_allclose(float(topt.warmup_cosine(step, **kw)),
                               float(ropt.warmup_cosine(step, **kw)), rtol=RTOL, atol=1e-12)
