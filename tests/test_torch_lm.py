"""The port's zamba2 LM serving path against the JAX package's, on the CPU.

At zamba2-1.2b's smoke config (fp32; 2 groups x 2 mamba layers + the
shared attention block, a 1-layer tail), batch 4, a 32-token prompt:

  * ``models/api.py: synth_batch`` draws the reference's tokens;
  * ``convert.lm_params_from_reference`` carries the reference's random
    params across exactly (and back, restacked), with the port's own init's
    structure, shapes and dtypes;
  * prefill from the converted params: last-position logits, the KV caches
    and every mamba layer's decode state within rtol 1e-4 / atol 1e-5 of
    ``repro.models.api.make_prefill_fn``;
  * greedy decode tokens equal to the reference's for 4 steps, from the
    port's own prefill and from a converted reference cache;
  * the launcher's ``--arch zamba2-1.2b --smoke --device cpu`` prints the
    reference's ``prefill:``, ``decode:`` and ``sample[b]:`` lines and grows
    the KV cache by ``gen + 1``.

The building blocks (norm, RoPE, decode attention, convolutions, the SSD
decode step) are held against the reference's at atol 1e-5 too.
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
from repro.models import mamba2 as rmamba
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba

ARCH = "zamba2-1.2b"
BATCH, PROMPT, DECODE_STEPS = 4, 32, 4
RTOL, ATOL = 1e-4, 1e-5
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _grow(cache, pad, xp):
    """The launcher's KV growth by ``pad`` positions (axis 2 of (G, B, S, K,
    hd)), for a reference (jnp) or port (torch) cache."""
    out = dict(cache)
    for k in ("k", "v"):
        if xp is jnp:
            out[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
        else:
            out[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, pad))
    return out


@pytest.fixture(scope="module")
def ref_run():
    """The reference's smoke prefill + 4 greedy decode steps, params from
    jax.random.key(0)."""
    cfg = ref_smoke_config(ARCH)
    shape = RefShapeSpec("serve", PROMPT, BATCH, "prefill")
    params = rapi.init(cfg, jax.random.key(0))
    batch = rapi.synth_batch(cfg, shape, seed=0)
    logits, cache = jax.jit(rapi.make_prefill_fn(cfg, None))(params, batch)
    cache_np = jax.tree.map(np.asarray, cache)
    grown = _grow(cache, DECODE_STEPS + 1, jnp)
    grown_np = jax.tree.map(np.asarray, grown)
    decode = jax.jit(rapi.make_decode_fn(cfg, None))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(DECODE_STEPS):
        tok, grown = decode(params, grown, tok, jnp.int32(PROMPT + i))
        toks.append(np.asarray(tok))
    return {
        "params": jax.tree.map(np.asarray, params),
        "tokens_in": np.asarray(batch["tokens"]),
        "logits": np.asarray(logits),
        "cache": cache_np,
        "grown_cache": grown_np,
        "decoded": np.concatenate(toks, axis=1),
    }


@pytest.fixture(scope="module")
def port_run(ref_run):
    """The port's smoke prefill from the converted reference params."""
    cfg = get_smoke_config(ARCH)
    params = convert.lm_params_from_reference(ref_run["params"])
    batch = tapi.synth_batch(cfg, ShapeSpec("serve", PROMPT, BATCH, "prefill"), seed=0)
    with torch.inference_mode():
        logits, cache = tapi.make_prefill_fn(cfg)(params, batch)
    return {"cfg": cfg, "params": params, "batch": batch, "logits": logits,
            "cache": cache}


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# --------------------------------------------------------------------------- #
# config, batch, params
# --------------------------------------------------------------------------- #
def test_smoke_and_full_configs_equal_the_reference():
    """Every field of the port's ModelConfig equals the reference's, and
    every reference field the port leaves out is at its default in both of
    zamba2's configs (so nothing the reference sets is dropped)."""
    from repro.configs import get_config as ref_config
    from repro.configs.base import ModelConfig as RefModelConfig
    from repro_torch.configs import get_config

    ported = {f.name for f in dataclasses.fields(get_config(ARCH))}
    ref_defaults = {f.name: f.default for f in dataclasses.fields(RefModelConfig)}
    for port_cfg, ref_cfg in ((get_smoke_config(ARCH), ref_smoke_config(ARCH)),
                              (get_config(ARCH), ref_config(ARCH))):
        got = {name: getattr(port_cfg, name) for name in ported}
        assert got == {name: getattr(ref_cfg, name) for name in ported}
        left_out = {name: getattr(ref_cfg, name) for name in ref_defaults
                    if name not in ported}
        assert left_out == {name: ref_defaults[name] for name in left_out}
        for prop in ("d_inner", "ssm_nheads"):
            assert getattr(port_cfg, prop) == getattr(ref_cfg, prop)
    cfg = get_config(ARCH)
    assert (cfg.head_dim, cfg.d_inner, cfg.ssm_nheads) == (64, 4096, 64)


@pytest.mark.parametrize("seed,B,S", [(0, BATCH, PROMPT), (3, 2, 7), (11, 1, 130)])
def test_synth_batch_tokens_identical(seed, B, S):
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    want = rapi.synth_batch(rcfg, RefShapeSpec("s", S, B, "prefill"), seed=seed)
    got = tapi.synth_batch(cfg, ShapeSpec("s", S, B, "prefill"), seed=seed)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_lm_params_round_trip(ref_run, port_run):
    """Converted params equal the reference's leaf for leaf (restacked), and
    have the structure, shapes and dtypes of the port's own init."""
    ref, params = ref_run["params"], port_run["params"]
    for key in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(_np(params[key]), ref[key])
    for key, leaf in ref["groups"].items():
        restacked = np.stack([np.stack([_np(layer[key]) for layer in group])
                              for group in params["groups"]])
        np.testing.assert_array_equal(restacked, leaf)
    for key, leaf in ref["tail"].items():
        np.testing.assert_array_equal(np.stack([_np(l[key]) for l in params["tail"]]), leaf)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["shared"])[0]
    for path, leaf in flat_ref:
        node = params["shared"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(_np(node), leaf)

    own = tapi.init(port_run["cfg"], torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(params)


# --------------------------------------------------------------------------- #
# prefill and decode against the reference
# --------------------------------------------------------------------------- #
def test_prefill_logits_and_caches_match_reference(ref_run, port_run):
    np.testing.assert_array_equal(port_run["batch"]["tokens"].numpy(), ref_run["tokens_in"])
    logits, cache, ref_cache = port_run["logits"], port_run["cache"], ref_run["cache"]
    assert logits.dtype == torch.float32 and logits.shape == ref_run["logits"].shape
    _close(logits, ref_run["logits"], "logits")
    for k in ("k", "v", "x0"):
        assert tuple(cache[k].shape) == ref_cache[k].shape
        _close(cache[k], ref_cache[k], k)
    for g, group in enumerate(cache["groups"]):
        for i, st in enumerate(group):
            for key in STATE_KEYS:
                _close(st[key], ref_cache["groups"][key][g, i], f"groups[{g}][{i}].{key}")
    for i, st in enumerate(cache["tail"]):
        for key in STATE_KEYS:
            _close(st[key], ref_cache["tail"][key][i], f"tail[{i}].{key}")


def _decode(cfg, params, cache, first_tok):
    decode = tapi.make_decode_fn(cfg)
    tok, toks = first_tok, [first_tok.numpy()]
    with torch.inference_mode():
        for i in range(DECODE_STEPS):
            tok, cache = decode(params, cache, tok, PROMPT + i)
            toks.append(tok.numpy())
    return np.concatenate(toks, axis=1)


@pytest.mark.parametrize("start", ["port prefill", "reference cache"])
def test_decode_tokens_match_reference(ref_run, port_run, start):
    """4 greedy steps after the prompt's own argmax token, from the port's
    prefill (its cache grown as the launcher grows it) or from the
    reference's grown cache carried across."""
    cfg, params = port_run["cfg"], port_run["params"]
    if start == "port prefill":
        cache = _grow(port_run["cache"], DECODE_STEPS + 1, torch)
    else:
        cache = convert.lm_cache_from_reference(ref_run["grown_cache"])
        assert tuple(cache["k"].shape) == ref_run["grown_cache"]["k"].shape
    first = torch.argmax(port_run["logits"], dim=-1).to(torch.int32)[:, None]
    got = _decode(cfg, params, cache, first)
    np.testing.assert_array_equal(got, ref_run["decoded"])


def test_init_cache_matches_reference_layout():
    cfg = get_smoke_config(ARCH)
    cache = tapi.init_cache(cfg, 3, 10)
    want = jax.tree.map(np.asarray, rapi.init_cache(ref_smoke_config(ARCH), 3, 10))
    assert tuple(cache["k"].shape) == want["k"].shape
    assert tuple(cache["x0"].shape) == want["x0"].shape
    for key in STATE_KEYS:
        assert tuple(cache["groups"][1][1][key].shape) == want["groups"][key].shape[2:]
        assert cache["groups"][0][0][key].dtype == getattr(torch, str(want["groups"][key].dtype))
        assert tuple(cache["tail"][0][key].shape) == want["tail"][key].shape[1:]


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #
def _rand(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("block", ["rms_norm", "apply_rope", "decode_attention",
                                   "cache_write", "causal_conv",
                                   "conv_step", "ssd_step"])
def test_building_block_matches_reference(block):
    rng = np.random.default_rng(7)
    if block == "rms_norm":
        (jx, tx), (jw, tw) = _rand(rng, 2, 5, 24), _rand(rng, 24)
        got, want = tlayers.rms_norm(tx, tw, 1e-5), rlayers.rms_norm(jx, jw, 1e-5)
    elif block == "apply_rope":
        jx, tx = _rand(rng, 2, 9, 3, 16)
        pos = np.tile(np.arange(100, 109, dtype=np.int32), (2, 1))
        got = tlayers.apply_rope(tx, torch.from_numpy(pos), 10000.0, 0.5)
        want = rlayers.apply_rope(jx, jnp.asarray(pos), 10000.0, 0.5)
    elif block == "decode_attention":
        (jq, tq), (jk, tk), (jv, tv) = (_rand(rng, 2, 1, 4, 8), _rand(rng, 2, 12, 2, 8),
                                        _rand(rng, 2, 12, 2, 8))
        got = tlayers.decode_attention(tq, tk, tv, 7)
        want = rlayers.decode_attention(jq, jk, jv, jnp.int32(7))
    elif block == "cache_write":  # a slot past the end clamps to the last
        (jc, tc), (jn, tn) = _rand(rng, 2, 6, 2, 8), _rand(rng, 2, 1, 2, 8)
        got = tuple(tlayers.cache_write(tc.clone(), tn, pos) for pos in (3, 6))
        want = tuple(rlayers.cache_write(jc, jn, jnp.int32(pos)) for pos in (3, 6))
    elif block == "causal_conv":
        (jx, tx), (jw, tw), (jb, tb) = _rand(rng, 2, 11, 6), _rand(rng, 4, 6), _rand(rng, 6)
        got, want = tmamba.causal_conv(tx, tw, tb), rmamba.causal_conv(jx, jw, jb)
    elif block == "conv_step":
        (js, ts), (jx, tx) = _rand(rng, 2, 3, 6), _rand(rng, 2, 6)
        (jw, tw), (jb, tb) = _rand(rng, 4, 6), _rand(rng, 6)
        got, want = tmamba.conv_step(ts, tx, tw, tb), rmamba.conv_step(js, jx, jw, jb)
    else:
        (jh, th), (jx, tx) = _rand(rng, 2, 4, 8, 6), _rand(rng, 2, 4, 8)
        dt = rng.uniform(0.05, 1.0, (2, 4)).astype(np.float32)
        A = -rng.uniform(0.3, 4.0, (4,)).astype(np.float32)
        (jB, tB), (jC, tC) = _rand(rng, 2, 2, 6), _rand(rng, 2, 2, 6)
        got = tmamba.ssd_step(th, tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC)
        want = rmamba.ssd_step(jh, jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("K,pos", [(2, 5), (4, 0), (4, 7)])
def test_attention_decode_matches_reference(K, pos):
    """One-token attention against a cache (written in place in the port):
    GQA (K = 2) and MHA (K = 4, the shared block's), at the cache's first,
    a middle and its last slot."""
    from repro.configs.base import ModelConfig as RefModelConfig
    from repro_torch.configs.base import ModelConfig

    kw = dict(name="t", family="hybrid", num_layers=1, d_model=16, num_heads=4,
              num_kv_heads=K, d_ff=32, vocab_size=8, param_dtype="float32",
              compute_dtype="float32")
    rcfg, cfg = RefModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(5)
    shapes = {"wq": (16, 16), "wk": (16, 4 * K), "wv": (16, 4 * K), "wo": (16, 16)}
    p_np = {k: rng.standard_normal(v).astype(np.float32) * 0.3 for k, v in shapes.items()}
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 8, K, 4)).astype(np.float32) for _ in range(2))
    want = rlayers.attention_decode({k: jnp.asarray(v) for k, v in p_np.items()},
                                    jnp.asarray(x), jnp.int32(pos), jnp.asarray(kc),
                                    jnp.asarray(vc), rcfg)
    got = tlayers.attention_decode({k: torch.from_numpy(v) for k, v in p_np.items()},
                                   torch.from_numpy(x), pos, torch.from_numpy(kc.copy()),
                                   torch.from_numpy(vc.copy()), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5)


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_launcher_smoke_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "3",
                      "--prompt-len", "20", "--gen", "5"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert any(ln.startswith("prefill: ") for ln in lines), out
    assert any(ln.startswith("decode: 4 steps in ") and "ms/step/batch" in ln
               for ln in lines), out
    assert sum(ln.strip().startswith("sample[") for ln in lines) == 2, out
    assert lines[-2].strip().startswith("sample[0]: [")
    assert res["tokens"].shape == (3, 5)
    assert tuple(res["cache"]["k"].shape)[2] == 20 + 5 + 1  # grown by gen + 1
    assert res["params"]["embed"].device.type == "cpu"
