"""ctypes launchers of the hand-written CUDA kernels in
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

Port of the ``flash_attention`` Pallas kernel of
``repro/kernels/flash_attention.py`` and of its backward (the reference's
``repro/kernels/ops.py: _fa_bwd``, a recompute under ``jax.vjp``), for bf16
and fp32 operands; the source files hold the kernels' bounds and design
notes. The dtype picks the forward kernel (:data:`ROUTES`): bf16 runs on
the tensor cores (``mma.sync``), fp32 on the FMA kernel (TF32 could not
meet fp32's tolerance). Given an fp32 ``lse`` (B, H, Sq), the forward also
writes each query row's log-sum-exp, from which :func:`flash_attention_bwd`
recomputes P; the output is the same with or without it. The backward is
three launches, D = rowsum(dO o O), then dK/dV, then dQ: on the tensor
cores for bf16, on FMAs for fp32.

The launchers take CUDA tensors only: they check device, dtype, shape and
contiguity, launch on the current stream, raise on a launch's CUDA error,
and count each call in :data:`LAUNCHES` (both dtypes under the kernel's
name; the backward's three launches count once). The libraries are built
and loaded at the first launch, never at import (the CPU tests import this
module). Empty operands, the autograd wiring and the CPU dispatch live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.gather_reduce import _check

#: kernel launches since the last reset — one is added where a launch
#: succeeds, and nowhere else
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: the pointer arguments of each library's repro_<name>_{f32,bf16}: q, k,
#: v, o and lse; q, k, v, o, lse, do, dq, dk, dv and the D workspace
_POINTERS = {"flash_attention": 5, "flash_attention_bwd": 10}
_LIBS: Dict[str, ctypes.CDLL] = {}
MAX_HEAD_DIM = 128
#: the forward kernel of each dtype: what it computes both products with
ROUTES = {torch.bfloat16: "mma.sync m16n8k16 bf16 tensor cores, 128 q rows x 64 keys",
          torch.float32: "fp32 FMAs, 64 q rows x 64 keys"}
_DTYPES = tuple(ROUTES)


def _lib(name: str = "flash_attention") -> ctypes.CDLL:
    if name not in _LIBS:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path(name)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for dt in ("f32", "bf16"):
            fn = getattr(lib, f"repro_{name}_{dt}")
            fn.argtypes = [ptr] * _POINTERS[name] + [i32] * 10 + [ptr]
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
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


def _check_stats(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    _check(t, name, dtype, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: {msg} (cudaError {err})")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
    window: Optional[int], q_offset: int = 0, lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, K, hd), contiguous, all fp32 or all
    bf16 on one CUDA device; H % K == 0, hd <= 128, no dim empty ->
    (B, Sq, H, hd) in q's dtype: softmax(q k^T / sqrt(hd)) v over the
    unmasked keys (``causal``: kv_pos <= q_pos; ``window``: q_pos - kv_pos
    < window), query row i at q_pos = ``q_offset`` + i (>= 0). ``lse``: a
    contiguous fp32 (B, H, Sq) tensor that receives each row's
    log-sum-exp of its scaled scores (+inf for a row with every key
    masked), for :func:`flash_attention_bwd`."""
    _check_qkv(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    if lse is not None:
        _check_stats(lse, "lse", (B, H, Sq), torch.float32, q.device)
    out = torch.empty_like(q)
    lib = _lib()
    fn = (lib.repro_flash_attention_f32 if q.dtype == torch.float32
          else lib.repro_flash_attention_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Sq, Skv,
                 H, K, hd, int(bool(causal)), int(window is not None),
                 int(window or 0), int(q_offset),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool, window: Optional[int], q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention` at the same ``causal``,
    ``window`` and ``q_offset``: q, k, v as there, ``o`` its output and
    ``lse`` the log-sum-exp it wrote, ``do`` (B, Sq, H, hd) the output's
    cotangent in q's dtype, all contiguous on one CUDA device -> (dq, dk,
    dv) in q's dtype, dk and dv summed over each kv head's group of query
    heads. P is recomputed from q, k and lse; every sum is fp32."""
    _check_qkv(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    for t, name in ((o, "o"), (do, "do")):
        _check_stats(t, name, q.shape, q.dtype, q.device)
    _check_stats(lse, "lse", (B, H, Sq), torch.float32, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib("flash_attention_bwd")
    fn = (lib.repro_flash_attention_bwd_f32 if q.dtype == torch.float32
          else lib.repro_flash_attention_bwd_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), B, Sq, Skv, H, K, hd, int(bool(causal)),
                 int(window is not None), int(window or 0), int(q_offset),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
