"""LM training of the port's transformer families against the JAX
package's, on the CPU.

Inputs are the reference's own: its params from ``jax.random.key(0)``
(carried over by ``convert.lm_params_from_reference``) and its synthetic
batches (``synth_batch``, the same numpy draws in both packages), or
arrays from numpy seeds handed to both. Everything is fp32 (the smoke
configs). Tolerances, each the reference's float32 reproduced in another
summation order:

  * ``sharded_xent_loss`` and the loss: rtol 1e-5; gradients within 1e-5
    of each leaf's largest |value| for the cross entropy alone, 1e-4 for
    the whole model;
  * the plain flash backward (``ref.flash_attention_bwd_ref``) against
    ``jax.vjp`` of the reference's ``layers.chunked_attention``: 1e-5 of
    the largest |gradient|;
  * three ``train_step``s against the reference's ``make_train_step``: the
    losses at rtol 1e-5, the AdamW ``m`` within 1e-4 of each leaf's
    largest |value|, ``v`` at 1e-3 of it (a square), and the params and
    ``master`` within 1e-3 x lr of their values: an update is
    lr x m / (sqrt(v) + eps), about lr x sign(g) in the first steps, so a
    gradient entry within its rounding of zero moves its param by up to
    2 lr either way; such entries are counted and must be rare (< 0.1%).

The CPU path launches no kernel: ``ops.flash_attention`` is the plain
version there, differentiated by torch's autograd.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.launch import steps as rsteps
from repro.models import api as rapi
from repro.models import layers as rlayers
from repro.parallel import collectives as rcoll
from repro.runtime import PreemptionHandler as RefPreemptionHandler
from repro.runtime import TrainSupervisor as RefTrainSupervisor
from repro.runtime.fault_tolerance import FailureInjector as RefFailureInjector
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.parallel import collectives as tcoll
from repro_torch.runtime import FailureInjector, PreemptionHandler, TrainSupervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("chatglm3-6b", "mixtral-8x7b", "llama4-scout-17b-a16e", "hubert-xlarge",
         "phi-3-vision-4.2b")
BATCH, SEQ = 2, 24
LOSS_RTOL, XENT_GRAD_TOL, GRAD_TOL, ATTN_TOL = 1e-5, 1e-5, 1e-4, 1e-5
_CACHE = {}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaf_close(got, want, tol, what=""):
    """|got - want| <= tol x max |want| (each leaf)."""
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _tree_close(got_ref_layout, want, tol, what=""):
    flat_g = jax.tree_util.tree_flatten_with_path(got_ref_layout)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        _leaf_close(g, flat_w[path], tol, f"{what}{jax.tree_util.keystr(path)}")


def _live(params):
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), params)


def _grads(loss, live):
    """The gradient of every leaf of ``live``, in ``live``'s structure."""
    leaves = tree_leaves(live)
    g = torch.autograd.grad(loss, leaves, materialize_grads=True)
    by_leaf = {id(p): gp for p, gp in zip(leaves, g)}
    return tree_map(lambda p: by_leaf[id(p)], live)


# --------------------------------------------------------------------------- #
# the chunked cross entropy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "S,chunk,V,Vpad,masked",
    [
        (24, 8, 40, 40, False),  # three full chunks
        (20, 8, 40, 40, False),  # two chunks and a remainder of 4
        (20, 8, 37, 48, True),  # padded vocab, a mask, the remainder
        (12, 512, 50, 64, True),  # one chunk shorter than seq_chunk
        (9, 4, 30, 32, False),
    ],
)
def test_sharded_xent_loss_matches_reference(S, chunk, V, Vpad, masked):
    rng = np.random.default_rng(S * 100 + chunk)
    B, D = 3, 16
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, Vpad)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=(B, S), dtype=np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None

    def ref_loss(x_, w_):
        return rcoll.sharded_xent_loss(x_, w_, jnp.asarray(labels),
                                       None if mask is None else jnp.asarray(mask),
                                       true_vocab=V, seq_chunk=chunk)

    want, (gx_w, gw_w) = jax.value_and_grad(ref_loss, argnums=(0, 1))(x, w)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = tcoll.sharded_xent_loss(xt, wt, torch.from_numpy(labels),
                                  None if mask is None else torch.from_numpy(mask),
                                  true_vocab=V, seq_chunk=chunk)
    gx, gw = torch.autograd.grad(got, (xt, wt))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    _leaf_close(gx, gx_w, XENT_GRAD_TOL, "dx")
    _leaf_close(gw, gw_w, XENT_GRAD_TOL, "dhead")
    assert not gw[:, V:].any()  # padding columns are outside the softmax


def test_sharded_xent_loss_all_masked_divides_by_one():
    x = torch.randn(2, 5, 8)
    got = tcoll.sharded_xent_loss(x, torch.randn(8, 10), torch.zeros(2, 5, dtype=torch.int32),
                                  torch.zeros(2, 5), true_vocab=10, seq_chunk=2)
    assert float(got) == 0.0


# --------------------------------------------------------------------------- #
# the attention backward
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window,q_offset,block_kv",
    [
        (2, 40, 40, 8, 2, 16, True, None, 0, 16),  # GQA, Skv not a block multiple
        (2, 33, 33, 4, 1, 8, True, None, 0, 8),  # MQA
        (1, 48, 48, 4, 2, 16, True, 10, 0, 16),  # window
        (1, 30, 30, 4, 4, 16, False, None, 0, 16),  # non-causal, ragged last block
        (1, 20, 37, 4, 2, 8, False, 12, 0, 16),  # non-causal window, Sq != Skv
        (1, 12, 40, 6, 3, 8, True, None, 28, 16),  # q_offset: a chunk after a prefix
    ],
)
def test_flash_attention_bwd_ref_matches_reference_vjp(B, Sq, Skv, H, K, hd, causal, window,
                                                       q_offset, block_kv):
    """The explicit backward formulas, on the lse of the plain forward,
    against jax.vjp of the reference's training attention; and torch's
    autograd of the port's plain path (what the CPU trains through)."""
    rng = np.random.default_rng(Sq * 7 + Skv)
    q, do = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Skv, K, hd)).astype(np.float32) for _ in range(2))

    def attn(q_, k_, v_):
        return rlayers.chunked_attention(q_, k_, v_, causal=causal, window=window,
                                         block_kv=block_kv, q_offset=q_offset)

    out_w, vjp = jax.vjp(attn, q, k, v)
    want = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o = tref.flash_attention_ref(qt, kt, vt, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_w), rtol=1e-5, atol=1e-6)
    lse = tref.flash_attention_lse_ref(qt, kt, causal, window, q_offset)
    got = tref.flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, causal, window, q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _leaf_close(g, w, ATTN_TOL, name)
    live = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out = tops.flash_attention(*live, causal, window, q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), torch.autograd.grad(out, live, dot), want):
        _leaf_close(g, w, ATTN_TOL, f"autograd {name}")
    assert not any(tops.launch_counts().values())


def test_flash_attention_lse_ref_masks_rows_without_keys():
    q, k = torch.randn(1, 4, 2, 8), torch.randn(1, 3, 1, 8)
    lse = tref.flash_attention_lse_ref(q, k, True, 2, q_offset=3)
    # rows at positions 3..6 with a window of 2 see keys 2.., of which only 2 exists
    assert torch.isfinite(lse[0, :, 0]).all() and torch.isinf(lse[0, :, 1:]).all()
    assert (lse[0, :, 1:] > 0).all()


# --------------------------------------------------------------------------- #
# the loss of each transformer family and its gradients
# --------------------------------------------------------------------------- #
def _reference(arch, mesh):
    """(reference cfg, params, batch, loss, grads) for ``arch``, cached."""
    if arch not in _CACHE:
        cfg = ref_smoke_config(arch)
        params = rapi.init(cfg, jax.random.key(0))
        batch = rapi.synth_batch(cfg, RefShapeSpec("t", SEQ, BATCH, "train"), seed=0)
        with jax.set_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(rapi.make_loss_fn(cfg, mesh)))(
                params, batch)
        _CACHE[arch] = (cfg, jax.tree.map(np.asarray, params), batch, float(loss),
                        jax.tree.map(np.asarray, grads))
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, mesh1):
    _, params, _, want_loss, want_grads = _reference(arch, mesh1)
    cfg = get_smoke_config(arch)
    batch = tapi.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=0)
    live = _live(convert.lm_params_from_reference(params))
    loss = tapi.make_loss_fn(cfg)(live, batch)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    got = convert.lm_params_to_reference(_grads(loss, live))
    _tree_close(got, want_grads, GRAD_TOL, f"{arch} grad")


def test_moe_aux_loss_carries_gradients_to_the_router():
    """The MoE aux loss reaches the loss and, through the router's softmax,
    the router's gradient: dropping it changes that gradient."""
    cfg = get_smoke_config("mixtral-8x7b")
    params = tapi.init(cfg, torch.Generator().manual_seed(0))
    batch = tapi.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=0)
    from repro_torch.models import moe, transformer

    live = _live(params)
    x, aux = transformer.forward_hidden(live, cfg, batch)
    assert aux.requires_grad and float(aux.detach()) > 0
    g_aux = torch.autograd.grad(aux, live["layers"][0]["mlp"]["router"])[0]
    assert g_aux.abs().max() > 0
    assert moe.AUX_WEIGHT == 0.01


def test_vlm_image_positions_carry_no_loss():
    """phi-3-vision: labels cover the text positions only; changing the
    patches changes the loss only through the text positions' attention."""
    cfg = get_smoke_config("phi-3-vision-4.2b")
    batch = tapi.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=0)
    assert batch["labels"].shape == (BATCH, SEQ - cfg.frontend_positions)
    params = tapi.init(cfg, torch.Generator().manual_seed(0))
    loss = tapi.make_loss_fn(cfg)(params, batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_hybrid_and_ssm_training_raise_naming_item_20(arch, tmp_path):
    with pytest.raises(NotImplementedError, match="item 20"):
        tapi.make_loss_fn(get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="item 20"):
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x7b"])
def test_remat_on_and_off_give_equal_losses_and_gradients(arch, monkeypatch):
    """torch.utils.checkpoint recomputes each layer in the backward: the
    same values, bit for bit, on the CPU, as the layers called directly
    (remat off: ``run_layers``' checkpoint replaced by a plain call)."""
    from repro_torch.models import transformer

    cfg = get_smoke_config(arch)
    params = tapi.init(cfg, torch.Generator().manual_seed(1))
    batch = tapi.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=3)
    calls, real_checkpoint = [], transformer.checkpoint

    def counted(fn, *a, **k):
        calls.append(fn)
        return real_checkpoint(fn, *a, **k)

    def direct(fn, *a, use_reentrant):
        return fn(*a)

    out = []
    for wrap in (counted, direct):
        monkeypatch.setattr(transformer, "checkpoint", wrap)
        live = _live(params)
        loss = tapi.make_loss_fn(cfg)(live, batch)
        out.append((loss.detach(), tree_leaves(_grads(loss, live))))
    assert calls == [transformer.train_layer] * cfg.num_layers
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------------- #
# the train step: loss, backward, clip, AdamW
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x7b"])
def test_three_train_steps_match_reference(arch, mesh1):
    lr, n = 3e-4, 3
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    shape_r, shape_t = RefShapeSpec("t", SEQ, BATCH, "train"), ShapeSpec("t", SEQ, BATCH,
                                                                         "train")
    with jax.set_mesh(mesh1):
        step_r, _, opt_r = rsteps.make_train_step(rcfg, mesh1, lr=lr)
        params_r = rapi.init(rcfg, jax.random.key(0))
        params_t = convert.lm_params_from_reference(jax.tree.map(np.asarray, params_r))
        state_r = opt_r.init(params_r)
        step_r = jax.jit(step_r)
        losses_r = []
        for i in range(n):
            params_r, state_r, m = step_r(params_r, state_r,
                                          rapi.synth_batch(rcfg, shape_r, seed=i))
            losses_r.append(float(m["loss"]))
    step_t, opt_t = tsteps.make_train_step(cfg, lr=lr)
    state_t = opt_t.init(params_t)
    losses_t = []
    for i in range(n):
        params_t, state_t, m = step_t(params_t, state_t, tapi.synth_batch(cfg, shape_t, seed=i))
        losses_t.append(float(m["loss"]))
    np.testing.assert_allclose(losses_t, losses_r, rtol=LOSS_RTOL)
    got = convert.adamw_state_to_reference(state_t)
    want = jax.tree.map(np.asarray, state_r)
    assert int(got["t"]) == int(want["t"]) == n
    back = convert.adamw_state_from_reference(want)  # the reference's state, in the port's layout
    assert set(back) == set(state_t) and int(back["t"]) == n
    assert [t.shape for t in tree_leaves(back)] == [t.shape for t in tree_leaves(state_t)]
    _tree_close(got["m"], want["m"], 1e-4, "m")
    _tree_close(got["v"], want["v"], 1e-3, "v")
    flips = total = 0
    for name, tree in (("params", convert.lm_params_to_reference(params_t)),
                       ("master", got["master"])):
        ref_tree = jax.tree.map(np.asarray, params_r) if name == "params" else want["master"]
        flat_w = dict(jax.tree_util.tree_flatten_with_path(ref_tree)[0])
        for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
            diff = np.abs(g - flat_w[path])
            assert (diff <= 2 * n * lr + 1e-6).all(), (name, jax.tree_util.keystr(path))
            flips += int((diff > 1e-3 * lr + 1e-6 * np.abs(flat_w[path])).sum())
            total += diff.size
    assert flips <= 1e-3 * total, (flips, total)


def test_train_step_skips_a_non_finite_step():
    """A step whose loss is not finite updates neither the params nor the
    AdamW state (in place, the supervisor could not drop it afterwards)."""
    cfg = get_smoke_config("chatglm3-6b")
    step, opt = tsteps.make_train_step(cfg)
    params = tapi.init(cfg, torch.Generator().manual_seed(0))
    params["final_norm"][0] = float("nan")
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves((params, state))]
    _, _, m = step(params, state, tapi.synth_batch(cfg, ShapeSpec("t", 8, 2, "train"), seed=0))
    assert not np.isfinite(float(m["loss"]))
    assert all(torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num()) for a, b in zip(before, tree_leaves((params, state))))
    assert int(state["t"]) == 0


# --------------------------------------------------------------------------- #
# the supervisor: tests/test_checkpoint_ft.py's cases, on the port and on the
# reference side by side
# --------------------------------------------------------------------------- #
def _stream(skip, n=100):
    return iter([float(i) for i in range(skip, n)])


def _both(fn):
    """Run ``fn(supervisor class, injector class, make state, tmp dir)`` for
    the port and the reference; returns both results."""
    from repro.checkpoint import CheckpointManager as RefCheckpointManager

    return fn(TrainSupervisor, FailureInjector, CheckpointManager,
              lambda x: {"x": torch.tensor(x, dtype=torch.float32)}), \
        fn(RefTrainSupervisor, RefFailureInjector, RefCheckpointManager,
           lambda x: {"x": jnp.float32(x)})


def test_supervisor_recovers_from_injected_failures(tmp_path):
    """Two injected node failures; the final state equals an uninterrupted
    run's (deterministic stream replay), as in the reference."""
    def run(Sup, Inj, CM, state0):
        inj = Inj(fail_at=[7, 13])

        def step_fn(state, batch):
            inj.maybe_fail()
            state = {"x": state["x"] + batch}
            return state, {"loss": float(state["x"])}

        d = tmp_path / Sup.__module__.split(".")[0]
        state, report = Sup(CM(str(d), keep=3), step_fn, _stream, ckpt_every=2).run(
            state0(0.0), total_steps=20)
        return float(state["x"]), report.restarts, report.steps_run

    port, ref = _both(run)
    assert port == ref and port[0] == sum(range(20)) and port[1] == 2


@pytest.mark.parametrize("policy", ["skip", "restore", "raise"])
def test_supervisor_nan_policies(tmp_path, policy):
    def run(Sup, Inj, CM, state0):
        calls = []

        def step_fn(state, batch):
            calls.append(batch)
            bad = batch == 5 and calls.count(5) == 1  # the first time only
            val = float("nan") if bad else batch
            return {"x": state["x"] + val}, {"loss": val}

        d = tmp_path / Sup.__module__.split(".")[0]
        sup = Sup(CM(str(d), keep=3), step_fn, _stream, ckpt_every=2, nan_policy=policy)
        try:
            state, report = sup.run(state0(0.0), total_steps=10)
        except FloatingPointError:
            return "raised"
        return float(state["x"]), report.nan_steps_skipped, report.restarts

    port, ref = _both(run)
    assert port == ref
    if policy == "skip":
        assert port == (sum(range(10)) - 5, 1, 0)  # the nan batch dropped
    elif policy == "restore":
        assert port == (sum(range(10)), 1, 1)  # restored and replayed
    else:
        assert port == "raised"


def test_supervisor_preemption_checkpoint(tmp_path):
    def run(Sup, Inj, CM, state0):
        ph = (PreemptionHandler if Sup is TrainSupervisor else RefPreemptionHandler)()

        def step_fn(state, batch):
            if batch == 3:
                ph.requested = True  # simulated SIGTERM mid-run
            return {"x": state["x"] + batch}, {"loss": 0.0}

        cm = CM(str(tmp_path / Sup.__module__.split(".")[0]))
        _, report = Sup(cm, step_fn, _stream, ckpt_every=1000, preemption=ph).run(
            state0(0.0), total_steps=50)
        return report.last_step, cm.latest_step()

    port, ref = _both(run)
    assert port == ref == (4, 4)  # stopped at the step after the signal, and saved


def test_supervisor_max_restarts(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("always")

    sup = TrainSupervisor(CheckpointManager(str(tmp_path)), step_fn, _stream, max_restarts=2)
    with pytest.raises(RuntimeError, match="max_restarts=2"):
        sup.run({"x": torch.zeros(())}, total_steps=5)


def test_supervisor_restore_joins_a_save_in_flight(tmp_path, monkeypatch):
    """A failure right after a save whose write is still running on the
    checkpoint thread: the supervisor waits for it and restores that step
    (a check that did not wait would see no checkpoint and start over from
    step 0 with the state it has, counting steps twice)."""
    real = tmanager.np.savez

    def slow_savez(*a, **k):
        time.sleep(0.3)
        return real(*a, **k)

    monkeypatch.setattr(tmanager.np, "savez", slow_savez)
    inj = FailureInjector(fail_at=[3])

    def step_fn(state, batch):
        inj.maybe_fail()
        return {"x": state["x"] + batch}, {"loss": 0.0}

    sup = TrainSupervisor(CheckpointManager(str(tmp_path), keep=3), step_fn, _stream,
                          ckpt_every=2)
    state, report = sup.run({"x": torch.zeros(())}, total_steps=6)
    assert float(state["x"]) == sum(range(6))
    assert report.restarts == 1 and report.steps_run == 6
    assert report.causes == [(2, "RuntimeError")] and len(report.restore_ms) == 1


def test_lm_drill_resumes_bitwise(tmp_path):
    """chatglm3-6b's smoke config through ``train_lm`` under the supervisor:
    a node failure at the 7th step call with checkpoints every 4 steps
    ends in params and AdamW state bitwise equal to an uninterrupted
    run's (the card's drill in chip_smoke.py, phase 20)."""
    def run(name, hook):
        args = ttrain.build_parser().parse_args(
            ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--steps", "12",
             "--batch", "2", "--seq-len", "16", "--ckpt-every", "4",
             "--ckpt-dir", str(tmp_path / name)])
        return ttrain.train_lm(args, step_hook=hook)

    clean = run("clean", None)
    drill = run("drill", FailureInjector(fail_at=[7]).maybe_fail)
    assert drill["report"].restarts == 1 and clean["report"].restarts == 0
    assert all(np.isfinite(clean["losses"]))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((clean["params"], clean["opt_state"])),
        tree_leaves((drill["params"], drill["opt_state"]))))


def test_lm_launcher_prints_done(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "chatglm3-6b", "--smoke",
         "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: steps=4 restarts=0 time=" in out.stdout


def test_lm_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs on it")
    with pytest.raises(RuntimeError):
        ttrain.main(["--arch", "chatglm3-6b", "--smoke", "--steps", "1"])
