"""ctypes launcher of the hand-written CUDA kernel in ``csrc/ssd_chunk.cu``.

Port of the ``ssd_chunk_scan`` Pallas kernel of ``repro/kernels/ssd_chunk.py``
(the Mamba2 / SSD chunked scan), for fp32 and bf16 ``x``; the source file
holds the kernel's bound and design note. The launcher takes CUDA tensors
only: it checks device, dtype, shape, contiguity and the kernel's shared
memory at this shape, launches on the current stream, raises on the launch's
CUDA error, and counts each launch in :data:`LAUNCHES` (both dtypes under
the kernel's name). The library is built and loaded at the first launch,
never at import. Empty operands and the CPU dispatch live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.gather_reduce import _check

#: kernel launches since the last reset — one is added where a launch
#: succeeds, and nowhere else
LAUNCHES = {"ssd_chunk_scan": 0}

_LIB: Optional[ctypes.CDLL] = None
MAX_DIM = 128  # head dim and state dim
MAX_SMEM = 232_448  # dynamic shared memory a block may use on sm_90


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("ssd_chunk")))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("repro_ssd_chunk_scan_f32", "repro_ssd_chunk_scan_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
            fn.restype = i32
        lib.repro_ssd_smem_bytes.argtypes = [i32, i32, i32]
        lib.repro_ssd_smem_bytes.restype = ctypes.c_longlong
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def ssd_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, Q: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hd) fp32 or bf16; dt (B, S, nh), A (nh,), Bm/Cm
    (B, S, ng, ds) fp32; all contiguous on one CUDA device; nh % ng == 0,
    hd, ds <= 128, no dim empty; ``Q`` the chunk (S need not be a multiple)
    -> (y (B, S, nh, hd) in x's dtype, h_final (B, nh, hd, ds) fp32)."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {x.device} tensor")
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
    lib = _lib()
    smem = lib.repro_ssd_smem_bytes(hd, ds, Q)
    if smem > MAX_SMEM:
        raise ValueError(f"chunk {Q} at hd {hd}, ds {ds} needs {smem} bytes of shared "
                         f"memory, more than a block's {MAX_SMEM}")
    y = torch.empty_like(x)
    h = torch.empty((Bt, nh, hd, ds), dtype=torch.float32, device=dev)
    fn = (lib.repro_ssd_chunk_scan_f32 if x.dtype == torch.float32
          else lib.repro_ssd_chunk_scan_bf16)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), h.data_ptr(), Bt, S, nh, hd, ng, ds, Q,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        what = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"CUDA launch of ssd_chunk_scan failed: {what} (cudaError {err})")
    LAUNCHES["ssd_chunk_scan"] += 1
    return y, h
