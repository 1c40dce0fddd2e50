"""The port's attention-free mamba2 LM serving path against the JAX
package's, on the CPU.

At mamba2-2.7b's smoke config (fp32; 2 mamba2 layers, d_model 64, ds 16,
chunk 16, tied head), batch 4, a 40-token prompt (three SSD chunks, the
last one ragged):

  * the configs and ``models/api.py: synth_batch`` equal the reference's;
  * ``convert.lm_params_from_reference`` carries the reference's random
    params across exactly, with the port's own init's structure;
  * prefill from the converted params: last-position logits and every
    layer's decode state within rtol 1e-4 / atol 1e-5 of
    ``repro.models.api.make_prefill_fn`` (the reference's jnp SSD scan);
  * 16 greedy tokens through ``launch.serve.main(... --device cpu)`` (the
    launcher's params replaced by the converted reference params) equal to
    the reference's decode loop, and equal again when the port decodes on
    from the reference's own prefill cache, carried across.

The CPU path launches no kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.models import api as rapi
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve
from repro_torch.models import api as tapi

ARCH = "mamba2-2.7b"
BATCH, PROMPT, GEN = 4, 40, 16
RTOL, ATOL = 1e-4, 1e-5
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's smoke prefill and GEN - 1 greedy decode steps (the
    reference launcher's loop: an ssm cache is never grown), params from
    jax.random.key(0), the prompt from seed 0; everything as numpy."""
    cfg = ref_smoke_config(ARCH)
    params = rapi.init(cfg, jax.random.key(0))
    batch = rapi.synth_batch(cfg, RefShapeSpec("serve", PROMPT, BATCH, "prefill"), seed=0)
    logits, cache = jax.jit(rapi.make_prefill_fn(cfg, None))(params, batch)
    out = {"params": jax.tree.map(np.asarray, params), "tokens_in": np.asarray(batch["tokens"]),
           "logits": np.asarray(logits), "cache": jax.tree.map(np.asarray, cache)}
    decode = jax.jit(rapi.make_decode_fn(cfg, None))
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for i in range(GEN - 1):
        tok, cache = decode(params, cache, tok, jnp.int32(PROMPT + i))
        toks.append(np.asarray(tok))
    out["decoded"] = np.concatenate(toks, axis=1)
    out["final_cache"] = jax.tree.map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def port_run(ref_run):
    cfg = get_smoke_config(ARCH)
    params = convert.lm_params_from_reference(ref_run["params"])
    batch = tapi.synth_batch(cfg, ShapeSpec("serve", PROMPT, BATCH, "prefill"), seed=0)
    with torch.inference_mode():
        logits, cache = tapi.make_prefill_fn(cfg)(params, batch)
    return {"cfg": cfg, "params": params, "batch": batch, "logits": logits, "cache": cache}


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


# --------------------------------------------------------------------------- #
# config, batch, params
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_are_the_references(which):
    mine = get_config(ARCH) if which == "config" else get_smoke_config(ARCH)
    theirs = ref_config(ARCH) if which == "config" else ref_smoke_config(ARCH)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    for prop in ("d_inner", "ssm_nheads"):
        assert getattr(mine, prop) == getattr(theirs, prop)
    assert mine.family == "ssm" and mine.tie_embeddings and not theirs.ssd_bf16


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_synth_batch_is_the_references(kind):
    rcfg, cfg = ref_smoke_config(ARCH), get_smoke_config(ARCH)
    want = rapi.synth_batch(rcfg, RefShapeSpec("s", 9, 3, kind), seed=5)
    got = tapi.synth_batch(cfg, ShapeSpec("s", 9, 3, kind), seed=5)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)


def test_params_carry_across_with_the_ports_structure(ref_run, port_run):
    ref, params = ref_run["params"], port_run["params"]
    assert "lm_head" not in ref and "lm_head" not in params  # tied head
    for key in ("embed", "final_norm"):
        np.testing.assert_array_equal(_np(params[key]), ref[key])
    for key, leaf in ref["layers"].items():
        np.testing.assert_array_equal(np.stack([_np(lp[key]) for lp in params["layers"]]),
                                      leaf, err_msg=key)
    own = tapi.init(port_run["cfg"], torch.Generator().manual_seed(0), device="cpu")
    assert _shapes(own) == _shapes(params)


def test_init_cache_matches_reference_layout():
    cfg = get_smoke_config(ARCH)
    cache = tapi.init_cache(cfg, 3, 10)
    want = jax.tree.map(np.asarray, rapi.init_cache(ref_smoke_config(ARCH), 3, 10))
    assert len(cache["layers"]) == cfg.num_layers
    for key in STATE_KEYS:
        for st in cache["layers"]:
            assert tuple(st[key].shape) == want[key].shape[1:]
            assert st[key].dtype == getattr(torch, str(want[key].dtype)) and not st[key].any()


# --------------------------------------------------------------------------- #
# prefill and decode against the reference
# --------------------------------------------------------------------------- #
def test_prefill_logits_and_states_match_reference(ref_run, port_run):
    np.testing.assert_array_equal(port_run["batch"]["tokens"].numpy(), ref_run["tokens_in"])
    logits = port_run["logits"]
    assert logits.dtype == torch.float32 and logits.shape == ref_run["logits"].shape
    _close(logits, ref_run["logits"], "logits")
    states = port_run["cache"]["layers"]
    assert len(states) == ref_run["cache"]["ssm"].shape[0]
    for i, st in enumerate(states):
        for key in STATE_KEYS:
            _close(st[key], ref_run["cache"][key][i], f"layers[{i}].{key}")


def test_launcher_decodes_the_references_tokens(ref_run, monkeypatch, capsys):
    """``launch.serve.main`` with the reference's params: 16 greedy tokens
    equal to the reference's, the reference's lines printed, the states
    after decode within tolerance of the reference's."""
    params = convert.lm_params_from_reference(ref_run["params"])
    monkeypatch.setattr(tapi, "init", lambda cfg, gen, device=None: params)
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("prefill: ") for ln in lines)
    assert any(ln.startswith(f"decode: {GEN - 1} steps in ") for ln in lines)
    assert [ln.strip().split(":")[0] for ln in lines[-2:]] == ["sample[0]", "sample[1]"]
    np.testing.assert_array_equal(res["tokens"], ref_run["decoded"])
    assert set(res["cache"]) == {"layers"}  # nothing grown
    for i, st in enumerate(res["cache"]["layers"]):
        for key in STATE_KEYS:
            _close(st[key], ref_run["final_cache"][key][i], f"decoded layers[{i}].{key}")


def test_decode_on_from_the_references_cache(ref_run, port_run):
    cfg, params = port_run["cfg"], port_run["params"]
    cache = convert.lm_cache_from_reference(ref_run["cache"])
    assert _shapes(cache) == _shapes(port_run["cache"])
    decode = tapi.make_decode_fn(cfg)
    tok = torch.from_numpy(ref_run["decoded"][:, :1].copy())
    toks = [tok.numpy()]
    with torch.inference_mode():
        for i in range(GEN - 1):
            tok, cache = decode(params, cache, tok, PROMPT + i)
            toks.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, axis=1), ref_run["decoded"])
