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
three launches, D = rowsum(dO o O), then dK/dV, then dQ: on Hopper's
warpgroup tensor-core products (``wgmma``) for bf16, with a fourth that
sums the dK/dV pass's parts of a GQA group when :func:`bwd_splits` cuts it;
on FMAs for fp32.

The launchers take CUDA tensors (and ``meta`` ones, the dry run's footprint
pass: they allocate what a launch allocates and launch nothing,
``gather_reduce.footprint``) only: they check device, dtype, shape and
contiguity, launch on the current stream, raise on a launch's CUDA error,
and count each call in :data:`LAUNCHES` (both dtypes under the kernel's
name; the backward's launches count once). The libraries are built
and loaded at the first launch, never at import (the CPU tests import this
module). Empty operands, the autograd wiring and the CPU dispatch live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.gather_reduce import _check, _check_cuda, footprint

#: kernel launches since the last reset — one is added where a launch
#: succeeds, and nowhere else
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: the pointer and int arguments of each library's repro_<name>_{f32,bf16}
#: before the stream: q, k, v, o and lse, then B, Sq, Skv, H, K, hd, causal,
#: has_window, window, q_off; the backward's q, k, v, o, lse, do, dq, dk, dv,
#: the D workspace and the split workspace, then those ints and the splits
_ARGS = {"flash_attention": (5, 10), "flash_attention_bwd": (11, 11)}
_LIBS: Dict[str, ctypes.CDLL] = {}
MAX_HEAD_DIM = 128
#: the bf16 backward's dK/dV pass: keys a CTA takes, and the CTAs it aims
#: to give each of the H100 SXM's 132 SMs, one at a time (a constant, so
#: that the split and with it the order of the sums are the same on every
#: card)
BWD_KEYS_PER_CTA = 128
BWD_SMS, BWD_CTAS_PER_SM = 132, 2
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
            fn.argtypes = [ptr] * _ARGS[name][0] + [i32] * _ARGS[name][1] + [ptr]
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    _check_cuda(q)
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
    if footprint(q):
        return out
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


def bwd_splits(B: int, Skv: int, H: int, K: int) -> int:
    """The parts the bf16 backward's dK/dV pass cuts each kv head's group of
    G = H / K query heads into: part i takes heads [i G / n, (i + 1) G / n)
    of the group, one CTA per (block of BWD_KEYS_PER_CTA keys, kv head,
    batch, part), and a second pass sums the parts' fp32 dK and dV in part
    order. As few parts as give BWD_CTAS_PER_SM CTAs per SM, at most G; 1
    (no workspace, no sum) for MHA or when the blocks alone fill the card."""
    G = H // K
    blocks = -(-Skv // BWD_KEYS_PER_CTA) * K * B
    return max(1, min(G, -(-BWD_SMS * BWD_CTAS_PER_SM // blocks)))


def bwd_workspace_shape(B: int, Skv: int, H: int, K: int, hd: int) -> Optional[Tuple[int, ...]]:
    """The fp32 workspace of the bf16 backward (dK's parts, then dV's, each
    (B, Skv, K, hd)), or None when :func:`bwd_splits` gives 1. Its bytes are
    2 x splits x B x Skv x K x hd x 4: at chatglm3-6b's 4 x 4096, 2 kv heads
    x 128, 33.5 MB a part."""
    n = bwd_splits(B, Skv, H, K)
    return None if n == 1 else (2, n, B, Skv, K, hd)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool, window: Optional[int], q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention` at the same ``causal``,
    ``window`` and ``q_offset``: q, k, v as there, ``o`` its output and
    ``lse`` the log-sum-exp it wrote, ``do`` (B, Sq, H, hd) the output's
    cotangent in q's dtype, all contiguous on one CUDA device -> (dq, dk,
    dv) in q's dtype, dk and dv summed over each kv head's group of query
    heads in a fixed order (bf16: :func:`bwd_splits` parts, summed in part
    order; the fp32 workspace of :func:`bwd_workspace_shape`). P is
    recomputed from q, k and lse; every sum is fp32."""
    _check_qkv(q, k, v, q_offset)
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    for t, name in ((o, "o"), (do, "do")):
        _check_stats(t, name, q.shape, q.dtype, q.device)
    _check_stats(lse, "lse", (B, H, Sq), torch.float32, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    shape = bwd_workspace_shape(B, Skv, H, K, hd) if q.dtype == torch.bfloat16 else None
    splits = 1 if shape is None else shape[1]
    ws = None if shape is None else torch.empty(shape, dtype=torch.float32, device=q.device)
    if footprint(q):
        return dq, dk, dv
    lib = _lib("flash_attention_bwd")
    fn = (lib.repro_flash_attention_bwd_f32 if q.dtype == torch.float32
          else lib.repro_flash_attention_bwd_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 delta.data_ptr(), None if ws is None else ws.data_ptr(), B, Sq, Skv, H, K,
                 hd, int(bool(causal)), int(window is not None), int(window or 0),
                 int(q_offset), splits, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
