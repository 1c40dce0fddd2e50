"""The tensor-core route of the SSD backward (``kernels/ssd_chunk.py:
ssd_chunk_scan_bwd`` for bf16 ``x``; ``csrc/ssd_chunk_bwd.cu``, eight
launches), against its plain version ``ref.ssd_chunk_scan_bwd_ref``.

The route forms G = C B^T once per (batch, group, chunk) and dB and dC from
the factor summed over a group's heads, so its workspaces hold no (B, S, nh,
ds) per-head partials: the CPU tests check the launcher's workspace shapes.
The tests marked ``cuda`` skip where no CUDA device is visible (decided in a
fixture, at run time) and run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_ssd_bwd_tc.py

They hold every output within 1e-2 of the plain version's Frobenius norm (dx
is rounded to bf16 once, the sums run in another order), the same limit as
tests/test_torch_cuda.py, whose ``test_cuda_ssd_chunk_scan_bwd_vs_plain``
runs the suite's shapes through both entry points; here the configs' real
head groups, unaligned operands and odd widths, and two calls giving the
same bits (no float atomics). The CPU tests also check the bound that
``chip_smoke.py`` sets beside the kernel's time. This file imports neither
JAX nor the JAX package.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_chunk as tssd

RNG = np.random.default_rng(27)
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
REL = 1e-2  # ||kernel - plain||_F <= REL ||plain||_F per output, bf16 x


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where none is visible (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m cuda")
    tops.reset_launch_counts()
    return torch.device("cuda")


def _tensor(shape, dtype, dev, lo=None, hi=None):
    a = RNG.standard_normal(shape) if lo is None else RNG.uniform(lo, hi, shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)


def _operands(dtype, dev, B, S, ng, hpg, hd, ds, dh_final=True):
    nh = ng * hpg
    x = _tensor((B, S, nh, hd), dtype, dev)
    dt = _tensor((B, S, nh), torch.float32, dev, 0.05, 1.0)
    A = -_tensor((nh,), torch.float32, dev, 0.3, 4.0)
    Bm = _tensor((B, S, ng, ds), torch.float32, dev)
    Cm = _tensor((B, S, ng, ds), torch.float32, dev)
    dy = _tensor((B, S, nh, hd), dtype, dev)
    dh = _tensor((B, nh, hd, ds), torch.float32, dev) if dh_final else None
    return x, dt, A, Bm, Cm, dy, dh


class _EntrySpy:
    """The backward's library with its two entry points counted."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("repro_ssd_chunk_scan_bwd_"):
            return fn

        def call(*args):
            self.calls.append(name)
            return fn(*args)

        return call


@pytest.fixture
def entry_spy(cuda, monkeypatch):
    spy = _EntrySpy(tssd._bwd_lib())
    monkeypatch.setattr(tssd, "_bwd_lib", lambda: spy)
    return spy


def _assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rel = (torch.linalg.vector_norm(g.float() - w.float())
               / torch.linalg.vector_norm(w.float())).item()
        assert rel <= REL, (name, rel)


# --------------------------------------------------------------------------- #
# CPU: the launcher's workspaces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "Bt,S,nh,hd,ng,ds,Q,W,P",
    [
        (4, 4096, 80, 64, 1, 128, 256, (4, 1, 16, 256 * (256 + 3 * 128)),
         (4, 16, 1, 10, 2, 64, 128)),  # mamba2-2.7b's training operands
        (4, 4096, 64, 64, 1, 64, 256, (4, 1, 16, 256 * (256 + 3 * 64)),
         (4, 16, 1, 10, 2, 64, 64)),  # zamba2-1.2b's
        (1, 40, 6, 16, 2, 8, 16, (1, 2, 3, 64 * (64 + 3 * 64)), (1, 3, 2, 1, 2, 64, 64)),
        (1, 600, 2, 128, 1, 100, 200, (1, 1, 3, 256 * (256 + 3 * 128)),
         (1, 3, 1, 10, 2, 64, 128)),
    ],
)
def test_ssd_bwd_tc_workspace_shapes(Bt, S, nh, hd, ng, ds, Q, W, P):
    """bf16: the fp32 route's state workspaces, G^T with B and C per (b,
    group, chunk), each chunk's prefix sum and dt per head, one share per
    causal 64 x 64 tile pair, and no per-head dB/dC partials."""
    got = tssd.bwd_workspace_shapes(Bt, S, nh, hd, ng, ds, Q, torch.bfloat16)
    nc = -(-S // Q)
    Qp = -(-Q // 64) * 64
    f32 = torch.float32
    assert got == {"Hs": ((Bt, nh, nc, hd, ds), f32), "dHs": ((Bt, nh, nc, hd, ds), f32),
                   "tot": ((Bt, nh, nc), f32), "W": (W, f32),
                   "cum": ((Bt, nh, nc, 2 * Qp), f32), "P": (P, f32),
                   "dAp": ((Bt, nc, nh), torch.float64)}
    assert "dBp" not in got and "dCp" not in got


def test_ssd_bwd_tc_workspace_is_smaller_than_the_partials():
    """At mamba2-2.7b's training operands the bf16 route's extra workspaces
    (W, cum, P: 94 MB) replace the fp32 route's per-head partials (dBp, dCp:
    1.34 GB)."""

    def nbytes(shapes, keys):
        return sum(int(np.prod(shapes[k][0])) * shapes[k][1].itemsize for k in keys)

    args = (4, 4096, 80, 64, 1, 128, 256)
    tc = tssd.bwd_workspace_shapes(*args, torch.bfloat16)
    fma = tssd.bwd_workspace_shapes(*args)
    assert nbytes(fma, ("dBp", "dCp")) == 2 * 4 * 4096 * 80 * 128 * 4
    assert nbytes(tc, ("W", "cum", "P")) < 0.08 * nbytes(fma, ("dBp", "dCp"))
    assert nbytes(tc, tc) < nbytes(fma, fma) - 1.2e9


@pytest.mark.parametrize("Q", [257, 512])
def test_ssd_bwd_tc_takes_chunks_up_to_256(Q):
    with pytest.raises(ValueError, match="chunk"):
        tssd.bwd_workspace_shapes(1, 1024, 2, 64, 1, 64, Q, torch.bfloat16)
    assert tssd.bwd_workspace_shapes(1, 1024, 2, 64, 1, 64, Q)["Hs"][0] == (1, 2, -(-1024 // Q),
                                                                            64, 64)


@pytest.mark.parametrize("Bt,S,ng,Q", [(65536, 64, 1, 64), (1, 65536 * 16, 1, 16),
                                        (64, 4096, 64, 16)])
def test_ssd_bwd_tc_refuses_grids_past_cuda_z(Bt, S, ng, Q):
    """bf16: launches 5-7 put (b, chunk, group) on a CUDA grid's z, which
    holds 65535; past it the launcher says so instead of a CUDA error. The
    fp32 route's grids take these shapes."""
    with pytest.raises(ValueError, match="65535"):
        tssd.bwd_workspace_shapes(Bt, S, ng, 8, ng, 4, Q, torch.bfloat16)
    assert "dBp" in tssd.bwd_workspace_shapes(Bt, S, ng, 8, ng, 4, Q)
    nc = -(-S // Q)
    small = max(1, tssd.MAX_GRID_Z // (nc * ng))
    if small * nc * ng <= tssd.MAX_GRID_Z:
        assert "P" in tssd.bwd_workspace_shapes(small, S, ng, 8, ng, 4, Q, torch.bfloat16)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ssd_bwd_bound_prices_each_product_at_its_operands_rate(dtype):
    """chip_smoke.py's bound of the backward at mamba2-2.7b's training
    operands: dS = dy x^T, whose operands are both in x's dtype, at the
    bf16 rate for bf16 x; every other product (one factor fp32) at the TF32
    rate; ``bound_ms_tf32`` all of them at the TF32 rate."""
    cs = _chip_smoke()
    B, S, nh, hd, ng, ds, Q = 4, 4096, 80, 64, 1, 128, 256

    def meta(*shape, d=torch.float32):
        return torch.empty(shape, dtype=d, device="meta")

    got = cs.ssd_bwd_bound(meta(B, S, nh, hd, d=dtype), meta(B, S, nh), meta(nh),
                           meta(B, S, ng, ds), meta(B, S, ng, ds), Q)
    ops_x = B * nh * (S // Q) * 2 * (Q * (Q + 1) // 2) * hd
    rate = cs.BF16_OPS_PER_S if dtype == torch.bfloat16 else cs.TF32_OPS_PER_S
    ops_ms = ((got["flops"] - ops_x) / cs.TF32_OPS_PER_S + ops_x / rate) * 1e3
    assert got["flops_both_in_x_dtype"] == ops_x == 21_558_722_560
    assert got["flops"] == 152_108_531_712
    assert got["ops_ms"] == pytest.approx(ops_ms, rel=1e-12)
    assert got["bound_ms"] == pytest.approx(max(ops_ms, got["bytes_ms"]), rel=1e-12)
    assert got["bound_ms_tf32"] == pytest.approx(
        max(got["flops"] / cs.TF32_OPS_PER_S * 1e3, got["bytes_ms"]), rel=1e-12)
    if dtype == torch.bfloat16:
        assert got["bound_by"] == "operations"
        assert got["bound_ms"] < got["bound_ms_tf32"] - 0.02
    else:
        assert got["bound_ms"] == got["bound_ms_tf32"]


def test_ssd_bwd_routes_name_both_dtypes():
    assert set(tssd.BWD_ROUTES) == {torch.bfloat16, torch.float32}
    assert "mma.sync" in tssd.BWD_ROUTES[torch.bfloat16]
    assert "FMA" in tssd.BWD_ROUTES[torch.float32]


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,ng,hpg,hd,ds,Q",
    [
        (1, 300, 1, 80, 64, 128, 256),  # mamba2-2.7b's group of 80 heads, short S
        (1, 300, 1, 64, 64, 64, 256),  # zamba2-1.2b's 64
        (2, 333, 2, 40, 64, 128, 256),  # two groups of 40, ragged
    ],
)
def test_cuda_ssd_bwd_tc_real_head_groups(cuda, B, S, ng, hpg, hd, ds, Q):
    """dB and dC from the factor summed over a whole group's heads in order,
    at the configs' real head counts."""
    ops_ = _operands(torch.bfloat16, cuda, B, S, ng, hpg, hd, ds)
    got = tssd.ssd_chunk_scan_bwd(*ops_, Q)
    x, dt, A, Bm, Cm, dy, dh = ops_
    want = tref.ssd_chunk_scan_bwd_ref(x, dt, A, Bm, Cm, Q, dy, dh)
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ds,offset", [(12, 20, 0), (64, 64, 1), (24, 30, 3)])
def test_cuda_ssd_bwd_tc_unaligned_operands(cuda, entry_spy, hd, ds, offset):
    """Head dims off a multiple of 8, or x, dy and so dx not 16-byte aligned
    (contiguous views at an offset of ``offset`` elements), take the
    element-copy loads; state dims off a multiple of 4 the scalar state
    loads."""

    def shifted(t):
        flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = flat[offset:].view(t.shape)
        out.copy_(t)
        return out

    x, dt, A, Bm, Cm, dy, dh = _operands(torch.bfloat16, cuda, 2, 150, 1, 3, hd, ds)
    x, dy = shifted(x), shifted(dy)
    got = tssd.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, dh, 64)
    want = tref.ssd_chunk_scan_bwd_ref(x, dt, A, Bm, Cm, 64, dy, dh)
    torch.cuda.synchronize()
    assert entry_spy.calls == ["repro_ssd_chunk_scan_bwd_bf16"]
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ng,hpg,ds", [(1, 16, 128), (2, 8, 64)], ids=["ng1", "ng2"])
def test_cuda_ssd_bwd_tc_is_deterministic(cuda, ng, hpg, ds):
    """No float atomics, every sum in a fixed order: two calls give the same
    bits."""
    ops_ = _operands(torch.bfloat16, cuda, 2, 700, ng, hpg, 64, ds)
    a = tssd.ssd_chunk_scan_bwd(*ops_, 256)
    b = tssd.ssd_chunk_scan_bwd(*ops_, 256)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert tops.launch_counts()["ssd_chunk_scan_bwd"] == 2


@pytest.mark.cuda
def test_cuda_ssd_bwd_f32_route_is_deterministic(cuda, entry_spy):
    """fp32 x keeps the FMA route: its entry point, and two calls bitwise
    equal."""
    ops_ = _operands(torch.float32, cuda, 2, 500, 2, 4, 64, 64)
    a = tssd.ssd_chunk_scan_bwd(*ops_, 256)
    b = tssd.ssd_chunk_scan_bwd(*ops_, 256)
    torch.cuda.synchronize()
    assert entry_spy.calls == ["repro_ssd_chunk_scan_bwd_f32"] * 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_cuda_ssd_bwd_tc_refuses_long_chunks(cuda):
    ops_ = _operands(torch.bfloat16, cuda, 1, 600, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="chunk 512"):
        tssd.ssd_chunk_scan_bwd(*ops_, 512)
    assert tops.launch_counts()["ssd_chunk_scan_bwd"] == 0
