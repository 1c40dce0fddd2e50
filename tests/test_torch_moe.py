"""The port's MoE transformers (mixtral-8x7b, llama4-scout-17b-a16e) and the
sliding-window KV ring against the JAX package's, on the CPU.

  * ``models/moe.py: moe_ffn`` at both smoke configs, and at mixtral's with
    a capacity factor of 0.5 (tokens dropped): ``out`` within rtol 1e-5 /
    atol 1e-6 of the reference's (fp32), ``aux`` within 1e-6, and the
    routing (top-k expert ids, the stable expert order, the kept mask)
    equal to the reference's ``lax.top_k`` / ``argsort(stable=True)`` /
    ``rank < cap``;
  * prefill from the converted reference params: last-position logits and
    the KV caches within rtol 1e-4 / atol 1e-5;
  * 16 greedy tokens through ``launch.serve.main(... --device cpu)`` (its
    params replaced by the converted reference params) equal to the
    reference's decode loop, where the reference's ring is right (llama4
    has no window; mixtral's 64-token prompt fills its W = 64 ring exactly).

The ring (mixtral's smoke window W = 64, at a capacity factor that drops
no token, so that routing is the same in a prefill and a decode step): the
launcher lays the prefill's keys out in ``min(prompt + gen, W)`` slots,
position p at slot p % W. Decode must then give, at every step, the greedy
token of a prefill over the prompt and the tokens generated so far (the
teacher-forced oracle): at prompt 32, gen 48 (the ring wraps) and at
prompt 96, gen 16 (96 % 64 != 0). At prompt 128 (128 % 64 == 0) the tokens
equal the reference's. At prompt 32 the reference's own ring (32 slots, the
prefill's keys in position order) overwrites position 0 at the first decode
step and its tokens leave the oracle's; the port's do not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import api as rapi
from repro.models import moe as rmoe
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
BATCH, PROMPT, GEN = 2, 24, 16
RTOL, ATOL = 1e-4, 1e-5
MOE_RTOL, MOE_ATOL, AUX_ATOL = 1e-5, 1e-6, 1e-6
RING_ARCH, WINDOW = "mixtral-8x7b", 64


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _no_drop(cfg):
    """``cfg`` at a capacity factor of E / k: every expert has a slot for
    every token, in a prefill and in a decode step alike."""
    return dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def reference_serve(rcfg, mesh, prompt, gen, batch=BATCH):
    """The reference launcher's LM loop (``repro/launch/serve.py:
    _serve_lm``): params from jax.random.key(0), the prompt from seed 0,
    one prefill, the KV cache grown by ``gen`` unless windowed, ``gen - 1``
    greedy steps. Everything as numpy."""
    params = rapi.init(rcfg, jax.random.key(0))
    tokens = rapi.synth_batch(rcfg, RefShapeSpec("serve", prompt, batch, "prefill"), seed=0)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(rapi.make_prefill_fn(rcfg, mesh))(params, tokens)
        out = {"params": jax.tree.map(np.asarray, params), "logits": np.asarray(logits),
               "cache": jax.tree.map(np.asarray, cache),
               "tokens_in": np.asarray(tokens["tokens"])}
        if rcfg.sliding_window is None:
            cache = {k: jnp.pad(v, ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0)))
                     for k, v in cache.items()}
        decode = jax.jit(rapi.make_decode_fn(rcfg, mesh))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        toks = [np.asarray(tok)]
        for i in range(gen - 1):
            tok, cache = decode(params, cache, tok, jnp.int32(prompt + i))
            toks.append(np.asarray(tok))
    out["decoded"] = np.concatenate(toks, axis=1)
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    return out


def port_serve(monkeypatch, cfg, params, prompt, gen, batch=BATCH):
    """``launch.serve.run_lm`` at ``cfg`` with ``params`` (None: the
    launcher's own random init)."""
    if params is not None:
        monkeypatch.setattr(tapi, "init", lambda c, g, device=None: params)
    args = serve.build_parser().parse_args(
        ["--arch", RING_ARCH, "--smoke", "--device", "cpu", "--batch", str(batch),
         "--prompt-len", str(prompt), "--gen", str(gen)])
    return serve.run_lm(args, cfg=cfg)


def oracle_mismatches(cfg, params, prompt_tokens, generated) -> int:
    """Teacher-forced oracle: at each step t, the greedy token of a prefill
    over the prompt and ``generated[:, :t]``; returns how many (row, step)
    differ from ``generated[:, t]``."""
    prefill = tapi.make_prefill_fn(cfg)
    seq = np.concatenate([prompt_tokens, generated], axis=1)
    P, bad = prompt_tokens.shape[1], 0
    with torch.inference_mode():
        for t in range(generated.shape[1]):
            logits, _ = prefill(params, {"tokens": torch.from_numpy(seq[:, :P + t].copy())})
            bad += int((torch.argmax(logits, dim=-1).numpy() != generated[:, t]).sum())
    return bad


# --------------------------------------------------------------------------- #
# configs and batches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch, which):
    mine = get_config(arch) if which == "config" else get_smoke_config(arch)
    theirs = ref_config(arch) if which == "config" else ref_smoke_config(arch)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.family == "moe" and mine.moe_d_ff == mine.d_ff


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_is_the_references(arch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    for kind in ("prefill", "train"):
        want = rapi.synth_batch(rcfg, RefShapeSpec("s", 11, 3, kind), seed=2)
        got = tapi.synth_batch(cfg, ShapeSpec("s", 11, 3, kind), seed=2)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------------------------- #
# moe_ffn alone
# --------------------------------------------------------------------------- #
def _reference_routing(rcfg, router, xf, cap):
    """The reference's dispatch (``repro/models/moe.py: moe_ffn.local``),
    up to the kept mask."""
    E, k = rcfg.num_experts, rcfg.num_experts_per_tok
    logits = jnp.einsum("td,de->te", xf, router, preferred_element_type=jnp.float32)
    _, idx = lax.top_k(logits, k)
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E))
    rank = jnp.arange(xf.shape[0] * k) - starts[sorted_e]
    return np.asarray(idx), np.asarray(order), np.asarray(rank < cap)


@pytest.mark.parametrize("arch,factor", [("mixtral-8x7b", None), ("llama4-scout-17b-a16e", None),
                                         ("mixtral-8x7b", 0.5)])
def test_moe_ffn_matches_reference(mesh1, arch, factor):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    if factor is not None:
        rcfg = dataclasses.replace(rcfg, moe_capacity_factor=factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    B, S, D = 2, 24, cfg.d_model
    rp = jax.tree.map(np.asarray, rmoe.init_moe_mlp(jax.random.key(3), rcfg))
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(np.float32)
    with jax.set_mesh(mesh1):
        want, want_aux = jax.jit(lambda p, v: rmoe.moe_ffn(rcfg, p, v, mesh1))(
            jax.tree.map(jnp.asarray, rp), jnp.asarray(x))
    p = {k: torch.from_numpy(v.copy()) for k, v in rp.items()}
    got, aux = tmoe.moe_ffn(cfg, p, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_RTOL, atol=MOE_ATOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=0, atol=AUX_ATOL)

    cap = tmoe._capacity(B * S, cfg)
    assert cap == rmoe._capacity(B * S, rcfg) and cap % 8 == 0
    idx, order, keep = _reference_routing(rcfg, jnp.asarray(rp["router"]),
                                          jnp.asarray(x.reshape(B * S, D)), cap)
    r = tmoe.route(cfg, p["router"], torch.from_numpy(x.reshape(B * S, D)), cap)
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    np.testing.assert_array_equal(r["order"].numpy(), order)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if factor is not None:
        assert not keep.all()  # tokens past the capacity were dropped
    else:
        assert keep.all()


def test_capacity_rounds_up_to_eight():
    cfg = get_smoke_config("mixtral-8x7b")  # E 4, k 2, factor 1.25
    assert [tmoe._capacity(t, cfg) for t in (1, 4, 7, 13, 100)] == [8, 8, 8, 16, 64]


# --------------------------------------------------------------------------- #
# prefill and decode against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(mesh1, arch):
    ref = reference_serve(ref_smoke_config(arch), mesh1, PROMPT, 2)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_reference(ref["params"])
    assert set(params["layers"][0]["mlp"]) == {"router", "wg", "wu", "wd"}
    own = tapi.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own["layers"][1]["mlp"].items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in params["layers"][1]["mlp"].items()}
    batch = tapi.synth_batch(cfg, ShapeSpec("serve", PROMPT, BATCH, "prefill"), seed=0)
    np.testing.assert_array_equal(batch["tokens"].numpy(), ref["tokens_in"])
    with torch.inference_mode():
        logits, cache = tapi.make_prefill_fn(cfg)(params, batch)
    assert logits.dtype == torch.float32
    _close(logits, ref["logits"], "logits")
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == ref["cache"][k].shape
        _close(cache[k], ref["cache"][k], f"cache {k}")


@pytest.mark.parametrize("arch,prompt", [("mixtral-8x7b", WINDOW),
                                         ("llama4-scout-17b-a16e", PROMPT)])
def test_launcher_decodes_the_references_tokens(mesh1, monkeypatch, capsys, arch, prompt):
    ref = reference_serve(ref_smoke_config(arch), mesh1, prompt, GEN)
    params = convert.lm_params_from_reference(ref["params"])
    monkeypatch.setattr(tapi, "init", lambda cfg, gen, device=None: params)
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", str(BATCH),
                      "--prompt-len", str(prompt), "--gen", str(GEN)])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("prefill: ") for ln in lines)
    assert any(ln.startswith(f"decode: {GEN - 1} steps in ") for ln in lines)
    assert [ln.strip().split(":")[0] for ln in lines[-2:]] == ["sample[0]", "sample[1]"]
    np.testing.assert_array_equal(res["tokens"], ref["decoded"])
    for k in ("k", "v"):
        assert tuple(res["cache"][k].shape) == ref["final_cache"][k].shape
        _close(res["cache"][k], ref["final_cache"][k], f"decoded cache {k}")


# --------------------------------------------------------------------------- #
# the sliding-window ring
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,prompt,size", [
    (8, 8, 12),  # no window: a growth by 4 zero slots
    (5, 5, 8),  # a ring longer than the prompt
    (8, 16, 8),  # the window's keys, prompt % W == 0: slots in position order
    (8, 20, 8),  # prompt % W == 4: rolled by 4
    (8, 20, 5),  # a ring shorter than the keys kept: the last 5
])
def test_ring_kv_puts_position_p_at_slot_p_mod_size(n, prompt, size):
    pos = torch.arange(prompt - n, prompt, dtype=torch.float32) + 1  # 0 marks empty
    kv = pos[None, None, :, None, None].expand(2, 3, n, 2, 4).contiguous()
    out = tlayers.ring_kv(kv, prompt, size)
    assert tuple(out.shape) == (2, 3, size, 2, 4)
    want = torch.zeros(size)
    for p in range(max(prompt - n, prompt - size), prompt):
        want[p % size] = p + 1
    assert torch.equal(out[0, 0, :, 0, 0], want) and torch.equal(out, want[
        None, None, :, None, None].expand_as(out))


@pytest.mark.parametrize("prompt,gen", [(32, 48), (96, 16)])
def test_ring_decode_equals_teacher_forced_prefill(monkeypatch, prompt, gen):
    """The launcher's decode at mixtral's smoke window against the
    teacher-forced oracle, token for token."""
    cfg = _no_drop(get_smoke_config(RING_ARCH))
    res = port_serve(monkeypatch, cfg, None, prompt, gen)
    assert tuple(res["cache"]["k"].shape)[2] == min(prompt + gen, WINDOW) == WINDOW
    prompt_tokens = tapi.synth_batch(
        cfg, ShapeSpec("serve", prompt, BATCH, "prefill"), seed=0)["tokens"].numpy()
    assert oracle_mismatches(cfg, res["params"], prompt_tokens, res["tokens"]) == 0


def test_ring_equals_the_reference_at_a_multiple_of_the_window(mesh1, monkeypatch):
    """Prompt 128 = 2 W: the reference keeps positions 64..127 at slots
    0..63, which is p % 64, so its decode is right and the tokens agree."""
    prompt = 2 * WINDOW
    rcfg, cfg = _no_drop(ref_smoke_config(RING_ARCH)), _no_drop(get_smoke_config(RING_ARCH))
    ref = reference_serve(rcfg, mesh1, prompt, GEN)
    res = port_serve(monkeypatch, cfg, convert.lm_params_from_reference(ref["params"]),
                     prompt, GEN)
    np.testing.assert_array_equal(res["tokens"], ref["decoded"])
    for k in ("k", "v"):
        _close(res["cache"][k], ref["final_cache"][k], f"decoded ring {k}")


def test_the_references_ring_leaves_the_oracle_at_prompt_32(mesh1, monkeypatch):
    """The reference sizes the ring by the prompt (32 slots for a 64-key
    window) and decode writes slot pos % 32: the first step overwrites
    position 0, still inside the window, and its tokens leave the
    teacher-forced oracle's; the port's ring of 64 slots does not, from
    the same params."""
    prompt, gen = 32, 48
    rcfg, cfg = _no_drop(ref_smoke_config(RING_ARCH)), _no_drop(get_smoke_config(RING_ARCH))
    ref = reference_serve(rcfg, mesh1, prompt, gen)
    assert ref["cache"]["k"].shape[2] == prompt  # the reference's ring: 32 slots
    params = convert.lm_params_from_reference(ref["params"])
    res = port_serve(monkeypatch, cfg, params, prompt, gen)
    assert tuple(res["cache"]["k"].shape)[2] == WINDOW
    np.testing.assert_array_equal(res["tokens"][:, 0], ref["decoded"][:, 0])  # the prefill's
    assert oracle_mismatches(cfg, params, ref["tokens_in"], res["tokens"]) == 0
    assert oracle_mismatches(cfg, params, ref["tokens_in"], ref["decoded"]) > 0
