"""The port's LM kernels' plain versions against the JAX package's.

On the CPU ``repro_torch.kernels.ops.flash_attention`` and
``ops.ssd_chunk_scan`` run the plain PyTorch versions (``kernels/ref.py``).
Each is held, on the same numpy inputs, against the reference's plain
version, the Pallas kernel in interpret mode (``repro.kernels.ops``) and
the pure-JAX function the kernel replaces (``repro.models.layers.
chunked_attention``, ``repro.models.mamba2.ssd_scan``), over the sweep of
tests/test_kernels.py, at the reference's own tolerances: flash atol 2e-5
at fp32 and 3e-2 at bf16 (compared in fp32), SSD atol 2e-4 at fp32. With
bf16 ``x`` the SSD output is rounded to bf16 (a 2^-8 relative step), so
there |port - reference| <= 3e-2 + 1e-2 |reference|. Nothing launches on
the CPU; the CUDA kernels are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba

RNG = np.random.default_rng(0)
BF16_ATOL, BF16_RTOL = 3e-2, 1e-2


@pytest.fixture(autouse=True)
def _fresh_counts():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _normal(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp array and a torch tensor, both rounded to
    ``dtype`` (round to nearest even on both sides)."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "Sq,Skv,H,K,hd,causal,window",
    [
        (128, 128, 4, 2, 64, True, None),
        (256, 256, 4, 4, 32, True, None),
        (128, 128, 8, 2, 64, True, 64),
        (96, 96, 2, 2, 16, False, None),  # encoder (bidirectional)
        (160, 160, 4, 1, 32, True, None),  # MQA, Sq not a block multiple
    ],
)
def test_flash_attention_plain_vs_reference(Sq, Skv, H, K, hd, causal, window):
    """The reference's fp32 sweep: the port's plain version (through
    ``ops``) against ``ref.flash_attention_ref``, the Pallas kernel in
    interpret mode and ``layers.chunked_attention``; the port's
    ``chunked_attention`` takes the same path."""
    (jq, q), (jk, k), (jv, v) = (_pair(_normal(2, S, n, hd), "float32")
                                 for S, n in ((Sq, H), (Skv, K), (Skv, K)))
    port = tops.flash_attention(q, k, v, causal, window)
    assert port.dtype == torch.float32 and port.shape == q.shape
    for want in (
        jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window),
        jops.flash_attention(jq, jk, jv, causal, window),
        jlayers.chunked_attention(jq, jk, jv, causal=causal, window=window),
    ):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=2e-5)
    via_layer = tlayers.chunked_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_array_equal(via_layer.numpy(), port.numpy())


def test_flash_attention_plain_bf16():
    """bf16 operands (the reference's bf16 case): atol 3e-2 in fp32."""
    (jq, q), (jk, k), (jv, v) = (_pair(_normal(1, 128, n, 64), "bfloat16")
                                 for n in (4, 2, 2))
    port = tops.flash_attention(q, k, v, True, None)
    assert port.dtype == torch.bfloat16
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=True),
                 jops.flash_attention(jq, jk, jv, True, None),
                 jlayers.chunked_attention(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_np(port), _np(want), atol=3e-2)


def test_flash_attention_noncausal_ragged_keys():
    """Non-causal, Sq = Skv = 200 with the reference wrapper's block 128:
    the port masks kv_pos >= Skv, as ``ref.flash_attention_ref`` and
    ``layers.chunked_attention`` do, and matches both at atol 2e-5. The
    reference's ``ops.flash_attention`` differs there by 0.069 to 0.083
    (0.079 at this shape, standard-normal inputs): it zero-pads
    k/v to 256 and its Pallas kernel masks only by causality and window,
    so the 56 padded keys enter every softmax (ROADMAP Queue 3)."""
    (jq, q), (jk, k), (jv, v) = (_pair(_normal(2, 200, 4, 32), "float32")
                                 for _ in range(3))
    port = tops.flash_attention(q, k, v, False, None)
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=False),
                 jlayers.chunked_attention(jq, jk, jv, causal=False, block_kv=128)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=2e-5)


def test_flash_attention_empty_and_q_offset():
    q = torch.zeros(2, 0, 4, 16)
    k = torch.ones(2, 5, 4, 16)
    assert tops.flash_attention(q, k, k).shape == q.shape
    out = tops.flash_attention(k, q, q)  # no keys: every row masked -> zeros
    assert out.shape == k.shape and not out.any()
    # q_offset (ported with the dense family): rows at positions 3.. of 5
    # keys, against the reference's plain attention on the full query range
    q5, k5, v5 = (np.random.default_rng(5).standard_normal((2, 5, 4, 16)).astype(np.float32)
                  for _ in range(3))
    got = tlayers.chunked_attention(torch.from_numpy(q5[:, 3:]), torch.from_numpy(k5),
                                    torch.from_numpy(v5), q_offset=3)
    want = jref.flash_attention_ref(jnp.asarray(q5), jnp.asarray(k5), jnp.asarray(v5),
                                    causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 3:], atol=2e-5)


# --------------------------------------------------------------------------- #
# SSD chunked scan
# --------------------------------------------------------------------------- #
def _ssd_inputs(B, S, ng, hpg, hd, ds, x_dtype="float32", rng=RNG):
    """The reference's SSD test inputs (tests/test_kernels.py), drawn from
    ``rng``: as (jnp arrays, torch tensors)."""
    nh = ng * hpg
    x = _pair(rng.standard_normal((B, S, nh, hd)).astype(np.float32), x_dtype)
    dt = _pair(rng.uniform(0.05, 1.0, (B, S, nh)).astype(np.float32), "float32")
    A = _pair(-rng.uniform(0.3, 4.0, (nh,)).astype(np.float32), "float32")
    Bm = _pair(rng.standard_normal((B, S, ng, ds)).astype(np.float32), "float32")
    Cm = _pair(rng.standard_normal((B, S, ng, ds)).astype(np.float32), "float32")
    return [a[0] for a in (x, dt, A, Bm, Cm)], [a[1] for a in (x, dt, A, Bm, Cm)]


def _ssd_exact(x, dt, A, Bm, Cm):
    """The SSD recurrence one position at a time in fp64 (``mamba2.
    ssd_step`` exactly, no chunking): y (B, S, nh, hd), h (B, nh, hd, ds)."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    B, S, nh, hd = x.shape
    hpg = nh // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, hpg, axis=2), np.repeat(Cm, hpg, axis=2)
    h = np.zeros((B, nh, hd, Bm.shape[3]))
    y = np.zeros_like(x)
    for t in range(S):
        h = h * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bnd,bns,bn->bnds", x[:, t], Bh[:, t], dt[:, t])
        y[:, t] = np.einsum("bnds,bns->bnd", h, Ch[:, t])
    return y, h


#: zamba2's SSD widths (hd = ds = 64) at its serving chunk Q = 256: one or
#: two groups, and a ragged S
SERVING_CHUNK_CASES = [(1, 512, 1, 4, 64, 64), (1, 512, 2, 2, 64, 64),
                       (1, 600, 1, 4, 64, 64)]


def ssd_serving_chunk_errors(B, S, ng, hpg, hd, ds, dtype, Q=256, seed=256):
    """Largest |y| and |h| errors at chunk ``Q``, with the reference's
    inputs cast to ``dtype`` (float32 or float64), of the port's plain
    version (``port``), ``mamba2.ssd_scan`` (``scan``; under jax's x64 mode
    for float64) and, at float32, the Pallas kernel in interpret mode
    (``interp``), each against the fp64 recurrence; and of the port against
    each reference form (``port-scan``, ``port-interp``)."""
    _, tin = _ssd_inputs(B, S, ng, hpg, hd, ds, rng=np.random.default_rng(seed))
    arrs = [t.numpy().astype(dtype) for t in tin]
    exact = _ssd_exact(*arrs)
    out = {"port": tops.ssd_chunk_scan(*(torch.from_numpy(a) for a in arrs), Q)}
    with jax.enable_x64(dtype == "float64"):
        jin = [jnp.asarray(a) for a in arrs]
        h0 = jnp.zeros((B, ng, hpg, hd, ds), dtype)
        out["scan"] = jmamba.ssd_scan(*jin, Q, h0=h0)
        if dtype == "float32":
            out["interp"] = jops.ssd_chunk_scan(*jin, chunk=Q)
        out = {k: tuple(a.double().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a, np.float64) for a in v)
               for k, v in out.items()}
    err = {k: tuple(float(np.abs(a - b).max()) for a, b in zip(v, exact))
           for k, v in out.items()}
    for ref in set(out) - {"port"}:
        err[f"port-{ref}"] = tuple(float(np.abs(a - b).max())
                                   for a, b in zip(out["port"], out[ref]))
    err["y_max"] = float(np.abs(exact[0]).max())
    return err


@pytest.mark.parametrize(
    "B,S,ng,hpg,hd,ds,Q",
    [(2, 32, 1, 4, 8, 16, 8), (1, 64, 2, 3, 16, 8, 16), (1, 40, 1, 2, 8, 8, 16)],
)
def test_ssd_chunk_scan_plain_vs_reference(B, S, ng, hpg, hd, ds, Q):
    """The reference's sweep (S = 40 is ragged at Q = 16): the port's plain
    version against the Pallas kernel in interpret mode and against
    ``mamba2.ssd_scan``, y and the final state at atol 2e-4; the port's
    ``mamba2.ssd_scan`` takes the same path."""
    jin, tin = _ssd_inputs(B, S, ng, hpg, hd, ds)
    y, h = tops.ssd_chunk_scan(*tin, Q)
    assert y.shape == tin[0].shape and h.shape == (B, ng * hpg, hd, ds)
    for y_want, h_want in (jops.ssd_chunk_scan(*jin, chunk=Q), jmamba.ssd_scan(*jin, Q)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=2e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=2e-4)
    y2, h2 = tmamba.ssd_scan(*tin, Q)
    np.testing.assert_array_equal(y2.numpy(), y.numpy())
    np.testing.assert_array_equal(h2.numpy(), h.numpy())


@pytest.mark.parametrize("B,S,ng,hpg,hd,ds", SERVING_CHUNK_CASES)
def test_ssd_chunk_scan_plain_at_serving_chunk(B, S, ng, hpg, hd, ds):
    """At Q = 256, zamba2's chunk, in fp64: the port's plain version against
    ``mamba2.ssd_scan`` (jax x64 mode) and against the exact fp64
    recurrence, y and the final state at atol 2e-4 (measured: 5.2e-6 and
    under 1e-12). In fp32 the two are not held to each other at 2e-4 at this
    chunk: rounding the prefix sum of ``dt * A`` (down to about -1000) to
    fp32 puts the reference's own y (|y| up to 78) 3.7e-4 to 4.7e-4 from the
    exact recurrence, the port's 4.7e-4 to 5.4e-4, and the two 7.1e-4 to
    8.5e-4 apart; the Pallas kernel computes in fp32 whatever its inputs
    (``python tests/test_torch_lm_kernels.py`` prints these numbers). The
    reference's 2e-4 was set at chunks of 8 and 16, where all are within
    1e-5 of each other."""
    err = ssd_serving_chunk_errors(B, S, ng, hpg, hd, ds, "float64")
    for key in ("port", "port-scan"):
        assert max(err[key]) <= 2e-4, (key, err)


def test_ssd_chunk_scan_plain_bf16():
    """bf16 x (the serving dtype): y in bf16 within 3e-2 + 1e-2 |y| of
    ``mamba2.ssd_scan``, the fp32 state at atol 2e-4."""
    jin, tin = _ssd_inputs(2, 48, 2, 2, 16, 16, x_dtype="bfloat16")
    y, h = tops.ssd_chunk_scan(*tin, 16)
    y_want, h_want = jmamba.ssd_scan(*jin, 16)
    assert y.dtype == torch.bfloat16
    y_want = _np(y_want)
    assert (np.abs(_np(y) - y_want) <= BF16_ATOL + BF16_RTOL * np.abs(y_want)).all()
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=2e-4)


@pytest.mark.parametrize("Bt,S,ng,ds,Q,shape", [
    (4, 2048, 1, 64, 256, (4, 1, 8, 256 * (256 + 2 * 64))),  # the zamba2 prefill
    (1, 50, 2, 8, 50, (1, 2, 1, 64 * (64 + 2 * 16))),  # Q and ds padded up
    (2, 300, 1, 128, 128, (2, 1, 3, 128 * (128 + 2 * 128))),
    (1, 257, 1, 20, 256, (1, 1, 2, 256 * (256 + 2 * 32))),  # a ragged last chunk
    (1, 64, 1, 17, 64, (1, 1, 1, 64 * (64 + 2 * 32))),
])
def test_ssd_workspace_shape(Bt, S, ng, ds, Q, shape):
    """The bf16 route's fp32 workspace: per (b, group, chunk) G (Qp, Qp) and
    C, B (Qp, DS), Qp = Q up to a multiple of 64, DS = ds up to 16, 32, 64
    or 128 (the kernel's layout, csrc/ssd_chunk.cu)."""
    assert tssd.workspace_shape(Bt, S, ng, ds, Q) == shape


@pytest.mark.parametrize("ds,Q,match", [(64, 257, "chunk 257"), (64, 0, "chunk 0"),
                                        (129, 64, "state dim 129")])
def test_ssd_workspace_refuses(ds, Q, match):
    with pytest.raises(ValueError, match=match):
        tssd.workspace_shape(1, 512, 1, ds, Q)


def test_ssd_scan_unported_options_and_empty():
    _, tin = _ssd_inputs(1, 8, 1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="item 16"):
        tmamba.ssd_scan(*tin, 4, h0=torch.zeros(1, 2, 4, 8))
    with pytest.raises(NotImplementedError, match="item 16"):
        tmamba.ssd_scan(*tin, 4, low_prec=True)
    x, dt, A, Bm, Cm = (t[:, :0] if t.dim() > 1 else t for t in tin)
    y, h = tops.ssd_chunk_scan(x, dt, A, Bm, Cm, 4)
    assert y.shape == x.shape and h.shape == (1, 2, 4, 8) and not h.any()


if __name__ == "__main__":
    # the SSD errors at zamba2's serving chunk, as PERF.md quotes them
    for case in SERVING_CHUNK_CASES:
        for dtype in ("float32", "float64"):
            e = ssd_serving_chunk_errors(*case, dtype)
            print(f"B,S,ng,hpg,hd,ds = {case} Q = 256 {dtype}: "
                  f"max|y| = {e.pop('y_max'):.3g}")
            for k, (ey, eh) in sorted(e.items()):
                print(f"  {k if '-' in k else k + '-exact':12s} y {ey:.3g}  h {eh:.3g}")
