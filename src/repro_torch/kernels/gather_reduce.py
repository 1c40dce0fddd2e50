"""ctypes launchers of the hand-written CUDA kernels in ``csrc/gather_reduce.cu``.

Port of the fp32 ``gather_reduce`` and ``fill`` Pallas kernels of
``repro/kernels/gather_reduce.py``; the source file holds each kernel's
bound and design note. These launchers take CUDA tensors only: they check
device, dtype (fp32 storage and rows, int32 ids), shape and contiguity,
launch on the current stream, raise on the launch's CUDA error, and count
each launch in :data:`LAUNCHES`. The library is built and loaded at the
first launch, never at import (the CPU tests import this module).
Natural shapes, empty operands and the CPU dispatch live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: kernel launches since the last reset, by kernel name — one is added
#: where a launch succeeds, and nowhere else
LAUNCHES = {"gather_reduce": 0, "fill": 0}

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("gather_reduce")))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.repro_gather_reduce_f32.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.repro_gather_reduce_f32.restype = i32
        lib.repro_fill_f32.argtypes = [ptr, ptr, ptr, i64, i32, i64, ptr]
        lib.repro_fill_f32.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        what = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {kernel} failed: {what} (cudaError {err})")


def gather_reduce(storage: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """storage (N, D) fp32 on a CUDA device; flat_ids (nb, L) int32 with
    every id in [0, N), nb, L > 0 -> (nb, D) fp32 bags."""
    if storage.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {storage.device} tensor")
    _check(storage, "storage", torch.float32, storage.device)
    _check(flat_ids, "slot_ids", torch.int32, storage.device)
    if storage.dim() != 2 or flat_ids.dim() != 2:
        raise ValueError(
            f"expected storage (N, D) and slot_ids (nb, L), got "
            f"{tuple(storage.shape)} and {tuple(flat_ids.shape)}"
        )
    nb, L = flat_ids.shape
    D = storage.shape[1]
    if nb == 0 or L == 0 or D == 0:
        raise ValueError("empty operands launch nothing: ops.gather_reduce skips them")
    out = torch.empty((nb, D), dtype=torch.float32, device=storage.device)
    lib = _lib()
    with torch.cuda.device(storage.device):
        err = lib.repro_gather_reduce_f32(
            storage.data_ptr(), flat_ids.data_ptr(), out.data_ptr(), nb, L, D,
            torch.cuda.current_stream(storage.device).cuda_stream,
        )
    _raise_on(err, "gather_reduce")
    LAUNCHES["gather_reduce"] += 1
    return out


def fill(storage: torch.Tensor, fill_slots: torch.Tensor, rows: torch.Tensor) -> None:
    """In place: storage[s] = rows[i] for every s = fill_slots[i] < N.
    storage (N, D) fp32; fill_slots (F,) int32, non-negative, valid slots
    unique; rows (F, D) fp32; F > 0. All on one CUDA device."""
    if storage.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {storage.device} tensor")
    _check(storage, "storage", torch.float32, storage.device)
    _check(fill_slots, "fill_slots", torch.int32, storage.device)
    _check(rows, "rows", torch.float32, storage.device)
    if storage.dim() != 2 or fill_slots.dim() != 1 or rows.dim() != 2:
        raise ValueError("expected storage (N, D), fill_slots (F,), rows (F, D)")
    (F,) = fill_slots.shape
    N, D = storage.shape
    if rows.shape != (F, D):
        raise ValueError(f"rows {tuple(rows.shape)} != ({F}, {D})")
    if F == 0 or D == 0:
        raise ValueError("empty operands launch nothing: ops.fill skips them")
    lib = _lib()
    with torch.cuda.device(storage.device):
        err = lib.repro_fill_f32(
            storage.data_ptr(), fill_slots.data_ptr(), rows.data_ptr(), F, D, N,
            torch.cuda.current_stream(storage.device).cuda_stream,
        )
    _raise_on(err, "fill")
    LAUNCHES["fill"] += 1
