"""ctypes launcher of the hand-written CUDA kernel in ``csrc/ssd_chunk.cu``.

Port of the ``ssd_chunk_scan`` Pallas kernel of ``repro/kernels/ssd_chunk.py``
(the Mamba2 / SSD chunked scan), for fp32 and bf16 ``x``; the source file
holds the kernels' bound and design note. Routes by ``x``'s dtype
(:data:`ROUTES`): bf16 makes two CUDA launches per call, G = C B^T once per
(batch, group, chunk) into an fp32 workspace that this launcher allocates
(:func:`workspace_shape`), then the scan on the tensor cores; fp32 makes
one launch of the FMA kernel. The launcher takes CUDA tensors only (``meta``
ones too: the dry run's footprint pass, which allocates the outputs and
workspaces and launches nothing): it checks
device, dtype, shape, contiguity and the shapes the route takes, launches on
the current stream, raises on the launch's CUDA error, and counts each CALL in
:data:`LAUNCHES` (both dtypes under the kernel's name, one per call whatever
its CUDA launches). The library is built and loaded at the first launch,
never at import. Empty operands and the CPU dispatch live in
``kernels/ops.py``.

:func:`ssd_chunk_scan_bwd` launches the hand-written backward of
``csrc/ssd_chunk_bwd.cu``, routed by ``x``'s dtype too (:data:`BWD_ROUTES`;
eight CUDA launches per bf16 call, five per fp32 call, one count in
:data:`LAUNCHES` either way), with the workspaces it allocates here
(:func:`bwd_workspace_shapes`); the source holds its design note.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.gather_reduce import _check, _check_cuda, footprint

#: kernel calls since the last reset — one is added where a call's
#: launches succeed, and nowhere else
LAUNCHES = {"ssd_chunk_scan": 0, "ssd_chunk_scan_bwd": 0}

#: the kernel each dtype of ``x`` runs (the design note is in the source)
ROUTES = {
    torch.bfloat16: "tensor cores: G = C.B^T once per (b, group, chunk) in fp32 FMAs, "
                    "then one CTA per (b, head, 64 head dims) walking the chunks in "
                    "order, mma.sync m16n8k16 bf16 with fp32 operands split into bf16 "
                    "parts (S.x x2, C.h x3, state x3)",
    torch.float32: "fp32 FMAs: one CTA per (b, head), 64 x 64 tiles",
}

#: the backward each dtype of ``x`` runs (the design note is in the source)
BWD_ROUTES = {
    torch.bfloat16: "tensor cores: G = C.B^T once per (b, group, chunk) in fp32 FMAs; each "
                    "chunk's state terms, the state walk; a CTA per (head, chunk, b) for dx, "
                    "ddt and dA; dB and dC per (b, chunk, group) over the group's heads in "
                    "order: their state terms, then the head-summed factor per causal 64 x "
                    "64 tile times B and C, added in tile order; mma.sync m16n8k16 bf16, "
                    "fp32 operands split into bf16 parts",
    torch.float32: "fp32 FMAs: a CTA per (b, head, chunk), 64 x 64 tiles, dB and dC per "
                   "head, then summed over each group's heads in order",
}

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None
MAX_DIM = 128  # head dim and state dim
MAX_SMEM = 232_448  # dynamic shared memory a block may use on sm_90
MAX_CHUNK_BF16 = 256  # the tensor-core route: 16 row tiles of 16, two per warp
GRAM_TILE = 64  # the G launch's tile: Q is padded up to a multiple
MAX_GRID_Z = 65535  # the bf16 backward's (b, chunk, group) grids: CUDA's limit on z


def workspace_shape(Bt: int, S: int, ng: int, ds: int, Q: int) -> Tuple[int, ...]:
    """Shape of the bf16 route's fp32 workspace, (Bt, ng, nc, Qp * (Qp + 2
    DS)): per chunk G (Qp, Qp), then C and B (Qp, DS) each, in the order the
    kernel's mma fragments read them. nc = ceil(S / Q), Qp = Q rounded up
    to :data:`GRAM_TILE`, DS = ds rounded up to 16, 32, 64 or 128. Raises for
    a chunk the route does not take (Q > :data:`MAX_CHUNK_BF16`)."""
    if not 0 < Q <= MAX_CHUNK_BF16:
        raise ValueError(f"chunk {Q}: the bf16 tensor-core kernel takes chunks of 1 to "
                         f"{MAX_CHUNK_BF16} positions")
    if not 0 < ds <= MAX_DIM:
        raise ValueError(f"state dim {ds}: the kernel takes 1 to {MAX_DIM}")
    Qp = -(-Q // GRAM_TILE) * GRAM_TILE
    DS = next(d for d in (16, 32, 64, 128) if ds <= d)
    return (Bt, ng, -(-S // Q), Qp * (Qp + 2 * DS))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("ssd_chunk")))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_chunk_scan_f32.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.repro_ssd_chunk_scan_bf16.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        # the bf16 route's two launches one at a time (chip_smoke.py times them)
        lib.repro_ssd_gram_bf16.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        lib.repro_ssd_scan_bf16.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
        for fn in (lib.repro_ssd_chunk_scan_f32, lib.repro_ssd_chunk_scan_bf16,
                   lib.repro_ssd_gram_bf16, lib.repro_ssd_scan_bf16):
            fn.restype = i32
        lib.repro_ssd_smem_bytes.argtypes = [i32, i32, i32]
        lib.repro_ssd_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_operands(x, dt, A, Bm, Cm, Q: int) -> Tuple[int, ...]:
    """The forward's operand checks (the backward's too) -> (Bt, S, nh, hd,
    ng, ds)."""
    _check_cuda(x)
    dev = x.device
    _check(x, "x", (torch.float32, torch.bfloat16), dev)
    for t, name in ((dt, "dt"), (A, "A"), (Bm, "Bm"), (Cm, "Cm")):
        _check(t, name, torch.float32, dev)
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"expected x (B, S, nh, hd) and Bm (B, S, ng, ds), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    Bt, S, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bt, S, nh) or A.shape != (nh,) or Bm.shape != (Bt, S, ng, ds)
            or Cm.shape != Bm.shape or ng == 0 or nh % ng):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not pair")
    if min(Bt, S, nh, hd, ds) == 0:
        raise ValueError("empty operands launch nothing: ops.ssd_chunk_scan skips them")
    if hd > MAX_DIM or ds > MAX_DIM or Q <= 0:
        raise ValueError(f"head dim {hd}, state dim {ds} (<= {MAX_DIM}) and chunk {Q} "
                         "(> 0): the kernel does not take them")
    return Bt, S, nh, hd, ng, ds


def ssd_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, Q: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hd) fp32 or bf16; dt (B, S, nh), A (nh,), Bm/Cm
    (B, S, ng, ds) fp32; all contiguous on one CUDA device; nh % ng == 0,
    hd, ds <= 128, no dim empty; ``Q`` the chunk (S need not be a multiple;
    at most 256 for bf16) -> (y (B, S, nh, hd) in x's dtype, h_final
    (B, nh, hd, ds) fp32)."""
    Bt, S, nh, hd, ng, ds = _check_operands(x, dt, A, Bm, Cm, Q)
    dev = x.device
    work = None  # the bf16 route's workspace, checked before the build
    if x.dtype == torch.bfloat16:
        work = torch.empty(workspace_shape(Bt, S, ng, ds, Q), dtype=torch.float32,
                           device=dev)
    y = torch.empty_like(x)
    h = torch.empty((Bt, nh, hd, ds), dtype=torch.float32, device=dev)
    if footprint(x):
        return y, h
    lib = _lib()
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr()]
    if work is None:
        fn = lib.repro_ssd_chunk_scan_f32
        smem = lib.repro_ssd_smem_bytes(hd, ds, Q)
        if smem > MAX_SMEM:
            raise ValueError(f"chunk {Q} at hd {hd}, ds {ds} needs {smem} bytes of shared "
                             f"memory, more than a block's {MAX_SMEM}")
    else:
        fn = lib.repro_ssd_chunk_scan_bf16
        ptrs.append(work.data_ptr())
    with torch.cuda.device(dev):
        err = fn(*ptrs, y.data_ptr(), h.data_ptr(), Bt, S, nh, hd, ng, ds, Q,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        what = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"CUDA launch of ssd_chunk_scan failed: {what} (cudaError {err})")
    LAUNCHES["ssd_chunk_scan"] += 1
    return y, h


def bwd_workspace_shapes(Bt: int, S: int, nh: int, hd: int, ng: int, ds: int, Q: int,
                         dtype: torch.dtype = torch.float32,
                         ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The backward's workspaces by name -> (shape, dtype) for ``x`` of
    ``dtype``, nc = ceil(S / Q): ``Hs``/``dHs`` each chunk's entering state
    and the cotangent of its leaving state (Bt, nh, nc, hd, ds); ``tot``
    each chunk's total decay exponent (Bt, nh, nc); ``dAp`` dA per (b,
    chunk), in fp64 (Bt, nc, nh). fp32 adds ``dBp``/``dCp``, dB and dC per
    head before the sum over a group's heads (Bt, S, nh, ds); bf16 adds
    ``W``, G^T = (C B^T)^T and B and C in fragment order per (b, group,
    chunk) (Bt, ng, nc, Qp * (Qp + 3 DS)), ``cum``, each chunk's prefix
    sum and dt per head (Bt, nh, nc, 2 Qp), and ``P``, the head-summed
    factor's products with B and C, one share per causal tile pair (Bt, nc,
    ng, nt (nt + 1) / 2, 2, 64, DS), with Qp = Q rounded up to
    :data:`GRAM_TILE`, nt = Qp / 64 and DS = ds rounded up to 64 or 128.
    Raises for a bf16 chunk the route does not take (Q >
    :data:`MAX_CHUNK_BF16`), or more than :data:`MAX_GRID_Z` (b, chunk,
    group) triples."""
    nc = -(-S // Q)
    f32 = torch.float32
    out = {"Hs": ((Bt, nh, nc, hd, ds), f32), "dHs": ((Bt, nh, nc, hd, ds), f32),
           "tot": ((Bt, nh, nc), f32)}
    if dtype == torch.bfloat16:
        if not 0 < Q <= MAX_CHUNK_BF16:
            raise ValueError(f"chunk {Q}: the bf16 tensor-core backward takes chunks of 1 "
                             f"to {MAX_CHUNK_BF16} positions")
        if Bt * nc * ng > MAX_GRID_Z:
            raise ValueError(f"{Bt} x {nc} chunks x {ng} groups: the bf16 tensor-core "
                             f"backward takes at most {MAX_GRID_Z} (batch, chunk, group) "
                             f"triples, a CUDA grid's z")
        Qp = -(-Q // GRAM_TILE) * GRAM_TILE
        DS = 64 if ds <= 64 else 128
        nt = Qp // GRAM_TILE
        out["W"] = ((Bt, ng, nc, Qp * (Qp + 3 * DS)), f32)
        out["cum"] = ((Bt, nh, nc, 2 * Qp), f32)
        out["P"] = ((Bt, nc, ng, nt * (nt + 1) // 2, 2, GRAM_TILE, DS), f32)
    else:
        out["dBp"] = ((Bt, S, nh, ds), f32)
        out["dCp"] = ((Bt, S, nh, ds), f32)
    out["dAp"] = ((Bt, nc, nh), torch.float64)
    return out


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("ssd_chunk_bwd")))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd_chunk_scan_bwd_f32.argtypes = [ptr] * 18 + [i32] * 7 + [ptr]
        lib.repro_ssd_chunk_scan_bwd_bf16.argtypes = [ptr] * 19 + [i32] * 7 + [ptr]
        for fn in (lib.repro_ssd_chunk_scan_bwd_f32, lib.repro_ssd_chunk_scan_bwd_bf16):
            fn.restype = i32
        for fn in (lib.repro_ssd_bwd_smem_bytes, lib.repro_ssd_bwd_bf16_smem_bytes):
            fn.argtypes = [i32, i32, i32]
            fn.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _BWD_LIB = lib
    return _BWD_LIB


def ssd_chunk_scan_bwd(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, dy: torch.Tensor, dh_final: Optional[torch.Tensor], Q: int,
) -> Tuple[torch.Tensor, ...]:
    """The vector-Jacobian product of :func:`ssd_chunk_scan` at its
    operands: ``dy`` (B, S, nh, hd) in x's dtype, ``dh_final`` (B, nh, hd,
    ds) fp32 or None (a zero cotangent), all contiguous on x's device ->
    (dx in x's dtype, ddt (B, S, nh), dA (nh,), dBm, dCm (B, S, ng, ds), all
    fp32 but dx). Takes what the forward takes, at any chunk whose shared
    memory fits a block (``repro_ssd_bwd_smem_bytes``, and for bf16
    ``repro_ssd_bwd_bf16_smem_bytes`` and chunks of at most
    :data:`MAX_CHUNK_BF16`)."""
    Bt, S, nh, hd, ng, ds = _check_operands(x, dt, A, Bm, Cm, Q)
    dev = x.device
    _check(dy, "dy", x.dtype, dev)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not shaped as x {tuple(x.shape)}")
    if dh_final is not None:
        _check(dh_final, "dh_final", torch.float32, dev)
        if dh_final.shape != (Bt, nh, hd, ds):
            raise ValueError(f"dh_final {tuple(dh_final.shape)} is not (B, nh, hd, ds) = "
                             f"{(Bt, nh, hd, ds)}")
    bf16 = x.dtype == torch.bfloat16
    shapes = bwd_workspace_shapes(Bt, S, nh, hd, ng, ds, Q, x.dtype)  # raises first
    if not footprint(x):
        lib = _bwd_lib()
        smem = (lib.repro_ssd_bwd_bf16_smem_bytes if bf16 else lib.repro_ssd_bwd_smem_bytes)(
            hd, ds, Q)
        if smem > MAX_SMEM:
            raise ValueError(f"chunk {Q} at hd {hd}, ds {ds} needs {smem} bytes of shared "
                             f"memory, more than a block's {MAX_SMEM}")
    work = {k: torch.empty(shape, dtype=dt_, device=dev) for k, (shape, dt_) in shapes.items()}
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dBm = torch.empty_like(Bm)
    dCm = torch.empty_like(Cm)
    if footprint(x):
        return dx, ddt, dA, dBm, dCm
    if bf16:
        fn = lib.repro_ssd_chunk_scan_bwd_bf16
        ptrs = [x, dt, A, Bm, Cm, dy, dh_final, work["W"], work["cum"], work["Hs"],
                work["dHs"], work["tot"], work["dAp"], work["P"], dx, ddt, dA, dBm, dCm]
    else:
        fn = lib.repro_ssd_chunk_scan_bwd_f32
        ptrs = [x, dt, A, Bm, Cm, dy, dh_final, work["Hs"], work["dHs"], work["tot"],
                work["dBp"], work["dCp"], work["dAp"], dx, ddt, dA, dBm, dCm]
    with torch.cuda.device(dev):
        err = fn(*(None if t is None else t.data_ptr() for t in ptrs), Bt, S, nh, hd, ng, ds, Q,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        what = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"CUDA launch of ssd_chunk_scan_bwd failed: {what} (cudaError {err})")
    LAUNCHES["ssd_chunk_scan_bwd"] += 1
    return dx, ddt, dA, dBm, dCm
