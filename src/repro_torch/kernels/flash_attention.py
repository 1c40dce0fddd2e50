"""ctypes launcher of the hand-written CUDA kernel in ``csrc/flash_attention.cu``.

Port of the ``flash_attention`` Pallas kernel of
``repro/kernels/flash_attention.py`` (forward only), for bf16 and fp32
operands; the source file holds the kernels' bound and design note. The
dtype picks the kernel (:data:`ROUTES`): bf16 runs on the tensor cores
(``mma.sync``), fp32 on the FMA kernel (TF32 could not meet fp32's tolerance).
The launcher takes CUDA tensors only: it checks device, dtype, shape and
contiguity, launches on the current stream, raises on the launch's CUDA
error, and counts each launch in :data:`LAUNCHES` (both dtypes under the
kernel's name). The library is built and loaded at the first launch, never
at import (the CPU tests import this module). Empty operands and the CPU
dispatch live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.gather_reduce import _check

#: kernel launches since the last reset — one is added where a launch
#: succeeds, and nowhere else
LAUNCHES = {"flash_attention": 0}

_LIB: Optional[ctypes.CDLL] = None
MAX_HEAD_DIM = 128
#: the kernel of each dtype: what it computes both products with
ROUTES = {torch.bfloat16: "mma.sync m16n8k16 bf16 tensor cores, 128 q rows x 64 keys",
          torch.float32: "fp32 FMAs, 64 q rows x 64 keys"}
_DTYPES = tuple(ROUTES)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("flash_attention")))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("repro_flash_attention_f32", "repro_flash_attention_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 10 + [ptr]
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    window: Optional[int], q_offset: int = 0,
) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, K, hd), contiguous, all fp32 or all
    bf16 on one CUDA device; H % K == 0, hd <= 128, no dim empty ->
    (B, Sq, H, hd) in q's dtype: softmax(q k^T / sqrt(hd)) v over the
    unmasked keys (``causal``: kv_pos <= q_pos; ``window``: q_pos - kv_pos
    < window), query row i at q_pos = ``q_offset`` + i (>= 0)."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {q.device} tensor")
    _check(q, "q", _DTYPES, q.device)
    _check(k, "k", q.dtype, q.device)
    _check(v, "v", q.dtype, q.device)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, Sq, H, hd) and k, v (B, Skv, K, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or H % max(K, 1):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if min(B, Sq, Skv, H, K, hd) == 0:
        raise ValueError("empty operands launch nothing: ops.flash_attention skips them")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}: the kernel does not take it")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0: the kernel does not take it")
    out = torch.empty_like(q)
    lib = _lib()
    fn = (lib.repro_flash_attention_f32 if q.dtype == torch.float32
          else lib.repro_flash_attention_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
                 H, K, hd, int(bool(causal)), int(window is not None),
                 int(window or 0), int(q_offset),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        what = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"CUDA launch of flash_attention failed: {what} (cudaError {err})")
    LAUNCHES["flash_attention"] += 1
    return out
