"""The port's dense, encoder and vlm transformer serving paths against the
JAX package's, on the CPU.

For each of the six transformer smoke configs (fp32; chatglm3-6b,
hubert-xlarge, phi-3-vision-4.2b, qwen2.5-32b, qwen2-72b,
mistral-large-123b), batch 2, a 24-token prompt (8 patches + 16 tokens for
phi-3-vision, 24 frames for hubert):

  * ``models/api.py: batch_structure`` and ``synth_batch`` give the
    reference's inputs (tokens, frames, patches) from the same seed;
  * prefill from the reference's params (``convert.lm_params_from_reference``):
    last-position logits and the KV caches within rtol 1e-4 / atol 1e-5 of
    ``repro.models.api.make_prefill_fn`` on a host mesh (the reference's jnp
    ``chunked_attention``, which the port's flash path is held against);
  * greedy decode tokens equal to the reference's for 4 steps, from the
    port's own prefill and from a converted reference cache (not hubert:
    an encoder has no decode step, and the launcher exits as the
    reference's does).

And one test each for: a rolling decode under a ``sliding_window`` smaller
than the prompt; ``chunked_attention`` with ``q_offset`` != 0; a
non-causal prefill at an S that is no multiple of 128; ``rope_fraction``
0.5 on a config that has full RoPE; tied embeddings. The CPU path launches
no kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import api as rapi
from repro.models import layers as rlayers
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

ARCHS = ("chatglm3-6b", "hubert-xlarge", "phi-3-vision-4.2b", "qwen2.5-32b",
         "qwen2-72b", "mistral-large-123b")
DECODERS = tuple(a for a in ARCHS if a != "hubert-xlarge")
BATCH, PROMPT, DECODE_STEPS = 2, 24, 4
RTOL, ATOL = 1e-4, 1e-5
_CACHE = {}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _grow_ref(cache, pad):
    return {k: jnp.pad(v, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
            for k, v in cache.items()}


def _grow_port(cache, pad):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) for k, v in cache.items()}


def reference_run(cfg, mesh, prompt=PROMPT, steps=DECODE_STEPS):
    """The reference's prefill (and ``steps`` greedy decode steps unless an
    encoder) on ``mesh``, params from jax.random.key(0), the batch from
    seed 0; everything as numpy."""
    shape = RefShapeSpec("serve", prompt, BATCH, "prefill")
    params = rapi.init(cfg, jax.random.key(0))
    batch = rapi.synth_batch(cfg, shape, seed=0)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(rapi.make_prefill_fn(cfg, mesh))(params, batch)
        out = {"params": jax.tree.map(np.asarray, params),
               "batch": jax.tree.map(np.asarray, batch), "logits": np.asarray(logits),
               "cache": jax.tree.map(np.asarray, cache)}
        if cfg.family == "encoder":
            return out
        grown = cache if cfg.sliding_window else _grow_ref(cache, steps)
        out["grown_cache"] = jax.tree.map(np.asarray, grown)
        decode = jax.jit(rapi.make_decode_fn(cfg, mesh))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        toks = [np.asarray(tok)]
        for i in range(steps):
            tok, grown = decode(params, grown, tok, jnp.int32(prompt + i))
            toks.append(np.asarray(tok))
    out["decoded"] = np.concatenate(toks, axis=1)
    out["final_cache"] = jax.tree.map(np.asarray, grown)
    return out


def port_decode(cfg, params, logits, cache, prompt=PROMPT, steps=DECODE_STEPS):
    decode = tapi.make_decode_fn(cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks = [tok.numpy()]
    with torch.inference_mode():
        for i in range(steps):
            tok, cache = decode(params, cache, tok, prompt + i)
            toks.append(tok.numpy())
    return np.concatenate(toks, axis=1), cache


def port_prefill(cfg, params, prompt=PROMPT):
    batch = tapi.synth_batch(cfg, ShapeSpec("serve", prompt, BATCH, "prefill"), seed=0)
    with torch.inference_mode():
        logits, cache = tapi.make_prefill_fn(cfg)(params, batch)
    return batch, logits, cache


def runs(arch, mesh):
    """(reference run, port config, port params, port batch, logits, cache),
    computed once per arch."""
    if arch not in _CACHE:
        ref = reference_run(ref_smoke_config(arch), mesh)
        cfg = get_smoke_config(arch)
        params = convert.lm_params_from_reference(ref["params"])
        batch, logits, cache = port_prefill(cfg, params)
        _CACHE[arch] = (ref, cfg, params, batch, logits, cache)
    return _CACHE[arch]


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# --------------------------------------------------------------------------- #
# configs and batches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    from repro.configs import get_entry

    entry = get_entry(arch)
    for mine, theirs in ((get_config(arch), entry.config),
                         (get_smoke_config(arch), entry.smoke)):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_is_the_references(arch, kind):
    shape = ShapeSpec("s", PROMPT, BATCH, kind)
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    want = rapi.batch_structure(rcfg, RefShapeSpec("s", PROMPT, BATCH, kind))
    assert tapi.batch_structure(cfg, shape) == want
    theirs = rapi.synth_batch(rcfg, RefShapeSpec("s", PROMPT, BATCH, kind), seed=3)
    mine = tapi.synth_batch(cfg, shape, seed=3)
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(_np(mine[k]), np.asarray(theirs[k]), err_msg=k)


# --------------------------------------------------------------------------- #
# prefill and decode against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, mesh1):
    ref, cfg, params, batch, logits, cache = runs(arch, mesh1)
    for k in ref["batch"]:
        np.testing.assert_array_equal(_np(batch[k]), ref["batch"][k], err_msg=k)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == ref["logits"].shape
    _close(logits, ref["logits"], "logits")
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == ref["cache"][k].shape
        _close(cache[k], ref["cache"][k], f"cache {k}")


@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_decode_tokens(arch, mesh1):
    ref, cfg, params, _batch, logits, cache = runs(arch, mesh1)
    toks, final = port_decode(cfg, params, logits, _grow_port(cache, DECODE_STEPS))
    np.testing.assert_array_equal(toks, ref["decoded"])
    for k in ("k", "v"):
        _close(final[k], ref["final_cache"][k], f"decoded cache {k}")
    # and on from the reference's own prefill cache, converted
    toks2, _ = port_decode(cfg, params, torch.from_numpy(ref["logits"].copy()),
                           convert.lm_cache_from_reference(ref["grown_cache"]))
    np.testing.assert_array_equal(toks2, ref["decoded"])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_across_with_the_ports_structure(arch, mesh1):
    """The converted params have the port's own init's structure, shapes
    and dtypes (per-layer lists; qkv biases, layer-norm pairs,
    frontend_proj and the untied head where the config has them)."""
    _ref, cfg, params, *_ = runs(arch, mesh1)
    own = tapi.init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(params) == shapes(own)
    assert len(params["layers"]) == cfg.num_layers
    assert ("bq" in params["layers"][0]["attn"]) == cfg.qkv_bias
    assert ("frontend_proj" in params) == (cfg.frontend is not None)


# --------------------------------------------------------------------------- #
# the single-feature cases
# --------------------------------------------------------------------------- #
def test_rolling_decode_under_a_sliding_window(mesh1):
    """sliding_window 8 < a 20-token prompt: the prefill keeps the last 8
    positions, in position order, as the reference's does; the launcher's
    ``fit_kv_cache`` lays them out as a ring of 8 with position p at slot
    p % 8 (here a roll by 20 % 8 = 4), and decode writes slot pos % 8. The
    tokens and caches equal the reference's decode started from its own
    prefill cache laid out the same way (its launcher leaves the cache in
    position order, so its decode would overwrite position 16, still in
    the window, first: ROADMAP.md Queue 3)."""
    arch, prompt, steps, W = "qwen2.5-32b", 20, 6, 8
    rcfg = dataclasses.replace(ref_smoke_config(arch), sliding_window=W)
    cfg = dataclasses.replace(get_smoke_config(arch), sliding_window=W)
    ref = reference_run(rcfg, mesh1, prompt=prompt, steps=0)
    params = convert.lm_params_from_reference(ref["params"])
    _batch, logits, cache = port_prefill(cfg, params, prompt=prompt)
    _close(logits, ref["logits"], "windowed logits")
    assert cache["k"].shape[2] == W
    for k in ("k", "v"):
        _close(cache[k], ref["cache"][k], f"windowed cache {k}")
    cache = serve.fit_kv_cache(cfg, cache, prompt, steps + 1)
    rolled = {k: np.roll(v, prompt % W, axis=2) for k, v in ref["cache"].items()}
    for k in ("k", "v"):
        _close(cache[k], rolled[k], f"ring {k}")
    with jax.set_mesh(mesh1):
        decode = jax.jit(rapi.make_decode_fn(rcfg, mesh1))
        tok = jnp.argmax(jnp.asarray(ref["logits"]), axis=-1).astype(jnp.int32)[:, None]
        want, ring = [np.asarray(tok)], jax.tree.map(jnp.asarray, rolled)
        for i in range(steps):
            tok, ring = decode(jax.tree.map(jnp.asarray, ref["params"]), ring, tok,
                               jnp.int32(prompt + i))
            want.append(np.asarray(tok))
    toks, final = port_decode(cfg, params, logits, cache, prompt=prompt, steps=steps)
    np.testing.assert_array_equal(toks, np.concatenate(want, axis=1))
    for k in ("k", "v"):
        _close(final[k], np.asarray(ring[k]), f"rolled cache {k}")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 6), (False, None)])
def test_chunked_attention_q_offset(causal, window):
    """A chunk of 7 queries at positions 9..15 against 16 keys, GQA 2."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    want = rlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, window=window, q_offset=9,
                                     block_kv=8)
    got = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal, window=window,
                                    q_offset=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # q_offset 0 is the prefill's own attention
    full = tlayers.chunked_attention(torch.from_numpy(q), torch.from_numpy(k[:, :7]),
                                     torch.from_numpy(v[:, :7]), causal=causal,
                                     window=window)
    want0 = rlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k[:, :7]),
                                      jnp.asarray(v[:, :7]), causal=causal, window=window)
    np.testing.assert_allclose(full.numpy(), np.asarray(want0), rtol=RTOL, atol=ATOL)


def test_non_causal_prefill_at_a_ragged_length(mesh1):
    """hubert (encoder, non-causal, no RoPE) at S = 130, which is no multiple
    of 128 (the kernel's q tile) nor of the reference's KV block."""
    arch, prompt = "hubert-xlarge", 130
    rcfg = dataclasses.replace(ref_smoke_config(arch), attn_block_kv=64)
    ref = reference_run(rcfg, mesh1, prompt=prompt)
    cfg = get_smoke_config(arch)
    assert not cfg.causal and cfg.family == "encoder"
    params = convert.lm_params_from_reference(ref["params"])
    _batch, logits, cache = port_prefill(cfg, params, prompt=prompt)
    _close(logits, ref["logits"], "encoder logits")
    for k in ("k", "v"):
        _close(cache[k], ref["cache"][k], f"encoder cache {k}")


def test_half_rope_on_a_full_rope_config(mesh1):
    """mistral's smoke config (full RoPE, GQA 3) at rope_fraction 0.5."""
    arch = "mistral-large-123b"
    rcfg = dataclasses.replace(ref_smoke_config(arch), rope_fraction=0.5)
    cfg = dataclasses.replace(get_smoke_config(arch), rope_fraction=0.5)
    ref = reference_run(rcfg, mesh1)
    params = convert.lm_params_from_reference(ref["params"])
    _batch, logits, cache = port_prefill(cfg, params)
    _close(logits, ref["logits"], "half-rope logits")
    _close(cache["k"], ref["cache"]["k"], "half-rope keys")
    toks, _ = port_decode(cfg, params, logits, _grow_port(cache, DECODE_STEPS))
    np.testing.assert_array_equal(toks, ref["decoded"])


def test_tied_embeddings(mesh1):
    """tie_embeddings: no lm_head, the head is embed^T."""
    arch = "chatglm3-6b"
    rcfg = dataclasses.replace(ref_smoke_config(arch), tie_embeddings=True)
    cfg = dataclasses.replace(get_smoke_config(arch), tie_embeddings=True)
    ref = reference_run(rcfg, mesh1)
    assert "lm_head" not in ref["params"]
    params = convert.lm_params_from_reference(ref["params"])
    assert torch.equal(ttransformer.head_weight(params, cfg), params["embed"].T)
    _batch, logits, cache = port_prefill(cfg, params)
    _close(logits, ref["logits"], "tied logits")
    toks, _ = port_decode(cfg, params, logits, _grow_port(cache, DECODE_STEPS))
    np.testing.assert_array_equal(toks, ref["decoded"])


def test_building_blocks():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              1e-5),
           rlayers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    w1 = rng.standard_normal((32, 48)).astype(np.float32) / 6
    w2 = rng.standard_normal((48, 32)).astype(np.float32) / 7
    b1, b2 = rng.standard_normal(48).astype(np.float32), b
    _close(tlayers.gelu_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2))),
           rlayers.gelu_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    cache = torch.zeros(2, 4, 1, 8)
    new = torch.ones(2, 1, 1, 8)
    tlayers.cache_write(cache, new, 6, rolling=True)
    assert cache[:, 2].eq(1).all() and cache.sum() == 16


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_launcher_serves_a_dense_arch(capsys):
    res = serve.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "12", "--gen", "5"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode: 4 steps" in out and "sample[1]:" in out
    assert res["tokens"].shape == (2, 5)
    assert tuple(res["cache"]["k"].shape) == (2, 2, 12 + 5, 2, 16)  # grown by gen


def test_launcher_serves_the_vlm_and_refuses_the_encoder():
    res = serve.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["k"].shape[2] == 20 + 3  # 8 patches + 12 tokens, grown by gen
    with pytest.raises(SystemExit, match="encoder-only arch has no decode step"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
