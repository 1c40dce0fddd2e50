"""The backward of the port's SSD chunked scan against the JAX package's, on
the CPU.

``kernels/ref.py: ssd_chunk_scan_bwd_ref`` (the explicit formulas the CUDA
backward kernel computes, its plain version) is held against ``jax.vjp`` of
the reference's training scan, ``repro/models/mamba2.py: ssd_scan`` (the
reference has no Pallas backward: it differentiates that chunk loop), from
the same numpy-seeded inputs and cotangents, with a zero and a nonzero
cotangent of the final state. Tolerances:

  * in fp32 at chunks of 8 and 16: every output (dx, ddt, dA, dBm, dCm)
    within 1e-4 of that gradient's largest |value| (the two sum in other
    orders; measured at most 8.3e-6);
  * at the serving chunk Q = 256, in fp64 (jax's x64 mode), as the forward's
    ``test_ssd_chunk_scan_plain_at_serving_chunk``: within 1e-4 of the
    largest |value| (measured 3.9e-7: the reference's einsums
    accumulate in fp32 even there, ``preferred_element_type``). In fp32 at
    Q = 256 the forward alone is 8e-4 apart (tests/test_torch_lm_kernels.py);
  * against torch's autograd of the plain forward ``ssd_chunk_scan_ref``
    (what the CPU trains through): 1e-5 of the largest |value| (the same
    sums in other orders).

The CPU path launches no kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.models import mamba2 as tmamba

NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
VJP_TOL, AUTOGRAD_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _inputs(B, S, ng, hpg, hd, ds, dh_final, dtype="float32", seed=0):
    """x, dt, A, Bm, Cm (the reference's SSD test draws), dy and dh_final
    as numpy arrays of ``dtype``; dh_final zeros unless asked for."""
    rng = np.random.default_rng(seed)
    nh = ng * hpg
    arrs = [rng.standard_normal((B, S, nh, hd)), rng.uniform(0.05, 1.0, (B, S, nh)),
            -rng.uniform(0.3, 4.0, (nh,)), rng.standard_normal((B, S, ng, ds)),
            rng.standard_normal((B, S, ng, ds)), rng.standard_normal((B, S, nh, hd)),
            rng.standard_normal((B, nh, hd, ds)) if dh_final else np.zeros((B, nh, hd, ds))]
    return [a.astype(dtype) for a in arrs]


def _reference_vjp(arrs, Q):
    """jax.vjp of mamba2.ssd_scan at (x, dt, A, Bm, Cm), applied to (dy,
    dh_final); numpy arrays in, numpy arrays out, at the inputs' dtype."""
    x, dt, A, Bm, Cm, dy, dh = arrs
    B, _, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    with jax.enable_x64(x.dtype == np.float64):
        h0 = jnp.zeros((B, ng, nh // ng, hd, ds), x.dtype)
        _, vjp = jax.vjp(lambda *a: jmamba.ssd_scan(*a, Q, h0=h0),
                         *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
        return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _assert_close(got, want, tol, what):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().double().numpy()
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (what, name, err, scale)


def _plain_bwd(arrs, Q, dh_final):
    x, dt, A, Bm, Cm, dy, dh = (torch.from_numpy(a) for a in arrs)
    return tref.ssd_chunk_scan_bwd_ref(x, dt, A, Bm, Cm, Q, dy, dh if dh_final else None)


CASES = [  # B, S, ng, hpg, hd, ds, Q
    (2, 32, 1, 4, 8, 16, 8),  # the reference's sweep
    (1, 64, 2, 3, 16, 8, 16),  # ng 2, hd != ds
    (1, 40, 1, 2, 8, 8, 16),  # ragged S
    (1, 40, 2, 2, 8, 4, 16),  # ragged S, ng 2
    (2, 10, 1, 2, 8, 16, 16),  # S < Q: one short chunk
    (1, 48, 1, 3, 16, 32, 16),  # hd < ds, three chunks
]


@pytest.mark.parametrize("dh_final", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("B,S,ng,hpg,hd,ds,Q", CASES)
def test_ssd_chunk_scan_bwd_ref_matches_reference_vjp(B, S, ng, hpg, hd, ds, Q, dh_final):
    arrs = _inputs(B, S, ng, hpg, hd, ds, dh_final)
    got = _plain_bwd(arrs, Q, dh_final)
    assert [g.dtype for g in got] == [torch.float32] * 5
    _assert_close(got, _reference_vjp(arrs, Q), VJP_TOL, "fp32")


@pytest.mark.parametrize("B,S,ng,hpg,hd,ds", [(1, 512, 1, 4, 64, 64), (1, 600, 2, 2, 64, 64),
                                             (1, 300, 1, 2, 16, 128)])
def test_ssd_chunk_scan_bwd_ref_at_serving_chunk(B, S, ng, hpg, hd, ds):
    """Q = 256, zamba2's and mamba2's chunk, in fp64: two and three chunks,
    a ragged S, ng 2, mamba2's ds 128; a nonzero final-state cotangent."""
    arrs = _inputs(B, S, ng, hpg, hd, ds, True, dtype="float64", seed=256)
    _assert_close(_plain_bwd(arrs, 256, True), _reference_vjp(arrs, 256), VJP_TOL, "fp64")


@pytest.mark.parametrize("dh_final", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("B,S,ng,hpg,hd,ds,Q", CASES[1:4])
def test_ssd_chunk_scan_bwd_ref_matches_autograd(B, S, ng, hpg, hd, ds, Q, dh_final):
    """The explicit formulas against torch's autograd of the plain forward,
    reached through ``models/mamba2.py: ssd_scan`` (the CPU's training
    path: ``ops.ssd_chunk_scan`` on CPU tensors that require grad)."""
    arrs = _inputs(B, S, ng, hpg, hd, ds, dh_final, seed=1)
    live = [torch.from_numpy(a).requires_grad_() for a in arrs[:5]]
    y, h = tmamba.ssd_scan(*live, Q)
    dy, dh = torch.from_numpy(arrs[5]), torch.from_numpy(arrs[6])
    want = torch.autograd.grad((y, h) if dh_final else (y,), live,
                               (dy, dh) if dh_final else (dy,))
    _assert_close(_plain_bwd(arrs, Q, dh_final), [w.double().numpy() for w in want],
                  AUTOGRAD_TOL, "autograd")


def test_ssd_chunk_scan_bwd_ref_bf16():
    """bf16 x and dy (the training path's dtype): dx comes back in bf16, the
    rest in fp32, each as the fp32 formulas on the widened x and dy would
    give it (dx rounded once)."""
    arrs = _inputs(1, 40, 1, 2, 8, 16, True, seed=2)
    x, dy = (torch.from_numpy(arrs[i]).to(torch.bfloat16) for i in (0, 5))
    rest = [torch.from_numpy(a) for a in arrs[1:5]]
    dh = torch.from_numpy(arrs[6])
    got = tref.ssd_chunk_scan_bwd_ref(x, *rest, 16, dy, dh)
    want = tref.ssd_chunk_scan_bwd_ref(x.float(), *rest, 16, dy.float(), dh)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    assert torch.equal(got[0], want[0].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))


def test_ssd_bwd_workspace_shapes():
    """The backward launcher's workspaces (csrc/ssd_chunk_bwd.cu's layout):
    nc = ceil(S / Q) chunks of state per (b, head), dB/dC per head, dA per
    (b, chunk) in fp64."""
    got = tssd.bwd_workspace_shapes(4, 4096, 80, 64, 1, 128, 256)
    assert got == {"Hs": ((4, 80, 16, 64, 128), torch.float32),
                   "dHs": ((4, 80, 16, 64, 128), torch.float32),
                   "tot": ((4, 80, 16), torch.float32),
                   "dBp": ((4, 4096, 80, 128), torch.float32),
                   "dCp": ((4, 4096, 80, 128), torch.float32),
                   "dAp": ((4, 16, 80), torch.float64)}
    assert tssd.bwd_workspace_shapes(1, 600, 4, 8, 2, 16, 256)["Hs"][0] == (1, 4, 3, 8, 16)


def test_ssd_chunk_scan_bwd_launcher_takes_cuda_tensors_only():
    arrs = [torch.from_numpy(a) for a in _inputs(1, 8, 1, 2, 4, 4, False)]
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        tssd.ssd_chunk_scan_bwd(*arrs[:5], arrs[5], None, 4)
