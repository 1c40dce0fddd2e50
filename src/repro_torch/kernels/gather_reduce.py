"""ctypes launchers of the hand-written CUDA kernels in ``csrc/gather_reduce.cu``.

Port of the ``gather_reduce``, ``gather_reduce_q``, ``fill``,
``fill_gather_reduce`` and ``fill_gather_reduce_q`` Pallas kernels of
``repro/kernels/gather_reduce.py``, for fp32, fp16, bf16 and int8 storage;
the source file holds each kernel's bound and design note. A bf16 storage
(the fp32 path's bf16 scratchpad) has bf16 bags and takes fp32 fill rows,
which its fill kernel rounds to bf16. These launchers take
CUDA tensors only (and ``meta`` ones: the dry run's footprint pass, for
which they allocate what a launch allocates and launch nothing,
:func:`footprint`): they check device, dtype, shape and contiguity, launch
on the current stream, raise on the launch's CUDA error, and count each
launch in :data:`LAUNCHES`, under the kernel's name and storage form. The
library is built and loaded at the first launch, never at import (the CPU
tests import this module). Natural shapes, empty operands and the CPU
dispatch live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

#: kernel launches since the last reset, by kernel and storage form — one
#: is added where a launch succeeds, and nowhere else. The fp32 forms keep
#: the bare kernel names; ``_f16`` is fp16 storage, ``_bf16`` bf16 storage,
#: ``_i8`` an int8 payload (``gather_reduce_q`` and ``fill_gather_reduce_q``
#: are int8 only).
LAUNCHES = {
    "gather_reduce": 0, "gather_reduce_f16": 0, "gather_reduce_bf16": 0,
    "gather_reduce_q": 0,
    "fill": 0, "fill_f16": 0, "fill_bf16": 0, "fill_i8": 0,
    "fill_gather_reduce": 0, "fill_gather_reduce_f16": 0, "fill_gather_reduce_bf16": 0,
    "fill_gather_reduce_q": 0,
}

#: storage dtype -> suffix of its LAUNCHES key
_FORM = {torch.float32: "", torch.float16: "_f16", torch.bfloat16: "_bf16",
         torch.int8: "_i8"}
#: storages the (unscaled) gather and fused kernels take
_FLOAT = (torch.float32, torch.float16, torch.bfloat16)

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("gather_reduce")))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        gather = [ptr, ptr, ptr, i64, i32, i32, ptr]
        fused = [ptr, ptr, ptr, i64, i64, ptr, ptr, i64, i32, i32, ptr]
        for name, argtypes in (
            ("repro_gather_reduce_f32", gather),
            ("repro_gather_reduce_f16", gather),
            ("repro_gather_reduce_bf16", gather),
            ("repro_gather_reduce_q8", [ptr] + gather),
            ("repro_fill", [ptr, ptr, ptr, i64, i32, i64, ptr]),
            ("repro_fill_f32_to_bf16", [ptr, ptr, ptr, i64, i32, i64, ptr]),
            ("repro_fill_gather_reduce_f32", fused),
            ("repro_fill_gather_reduce_f16", fused),
            ("repro_fill_gather_reduce_bf16", fused),
            ("repro_fill_gather_reduce_q8", [ptr, ptr] + fused[1:]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, device: torch.device):
    """``dtype`` is one dtype or a tuple of the accepted ones."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(storage: torch.Tensor) -> None:
    """A CUDA tensor, or a ``meta`` one: the dry run's memory pass
    (``launch/dryrun.py``), for which a launcher allocates what it
    allocates on the card and launches nothing (:func:`footprint`)."""
    if storage.device.type not in ("cuda", "meta"):
        raise ValueError(f"CUDA kernel called on a {storage.device} tensor")


def footprint(t: torch.Tensor) -> bool:
    """Whether a launcher given ``t`` stops after its allocations: a
    ``meta`` tensor, the dry run's abstract card (nothing launches, nothing
    is counted in :data:`LAUNCHES`)."""
    return t.device.type == "meta"


def _check_scale(scale: torch.Tensor, storage: torch.Tensor) -> None:
    _check(scale, "scale", torch.float32, storage.device)
    if tuple(scale.shape) != (storage.shape[0], 1):
        raise ValueError(
            f"scale {tuple(scale.shape)} != ({storage.shape[0]}, 1): one fp32 "
            "scale per storage row"
        )


def _gather_shapes(storage: torch.Tensor, flat_ids: torch.Tensor, what: str):
    if storage.dim() != 2 or flat_ids.dim() != 2:
        raise ValueError(
            f"expected storage (N, D) and slot_ids (nb, L), got "
            f"{tuple(storage.shape)} and {tuple(flat_ids.shape)}"
        )
    nb, L = flat_ids.shape
    D = storage.shape[1]
    if nb == 0 or L == 0 or D == 0:
        raise ValueError(f"empty operands launch nothing: ops.{what} skips them")
    return nb, L, D


def _fill_shapes(storage, fill_slots, rows, what: str):
    if storage.dim() != 2 or fill_slots.dim() != 1 or rows.dim() != 2:
        raise ValueError("expected storage (N, D), fill_slots (F,), rows (F, D)")
    (F,) = fill_slots.shape
    N, D = storage.shape
    if rows.shape != (F, D):
        raise ValueError(f"rows {tuple(rows.shape)} != ({F}, {D})")
    if F == 0 or D == 0:
        raise ValueError(f"empty operands launch nothing: ops.{what} skips them")
    return F, N, D


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        what = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {kernel} failed: {what} (cudaError {err})")


def _bags(storage: torch.Tensor, nb: int, D: int) -> torch.Tensor:
    """The (nb, D) bags a gather of ``storage`` writes: bf16 for a bf16
    storage (the sum rounded once, as the reference casts it to the storage
    dtype), fp32 for every other form (fp16 rows summed in fp32 stay fp32,
    as the reference's fp16 replica path keeps them)."""
    dtype = torch.bfloat16 if storage.dtype == torch.bfloat16 else torch.float32
    return torch.empty((nb, D), dtype=dtype, device=storage.device)


def gather_reduce(storage: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """storage (N, D) fp32, fp16 or bf16 on a CUDA device; flat_ids (nb, L)
    int32 with every id in [0, N) or negative (a masked lookup: a zero row
    in its place), nb, L > 0 -> (nb, D) bags: rows widened exactly, summed
    in fp32 in l order; fp32 bags, bf16 ones for a bf16 storage."""
    _check_cuda(storage)
    _check(storage, "storage", _FLOAT, storage.device)
    _check(flat_ids, "slot_ids", torch.int32, storage.device)
    nb, L, D = _gather_shapes(storage, flat_ids, "gather_reduce")
    out = _bags(storage, nb, D)
    if footprint(storage):
        return out
    lib = _lib()
    fn = {torch.float32: lib.repro_gather_reduce_f32,
          torch.float16: lib.repro_gather_reduce_f16,
          torch.bfloat16: lib.repro_gather_reduce_bf16}[storage.dtype]
    key = "gather_reduce" + _FORM[storage.dtype]
    with torch.cuda.device(storage.device):
        err = fn(storage.data_ptr(), flat_ids.data_ptr(), out.data_ptr(), nb, L, D,
                 _stream(storage))
    _raise_on(err, key)
    LAUNCHES[key] += 1
    return out


def gather_reduce_q(
    storage: torch.Tensor, scale: torch.Tensor, flat_ids: torch.Tensor
) -> torch.Tensor:
    """Dequantizing gather: storage (N, D) int8 payload and scale (N, 1)
    fp32 on a CUDA device; flat_ids (nb, L) int32 with every id in [0, N),
    nb, L > 0 -> (nb, D) fp32 bags, each addend ``q * scale[id]``."""
    _check_cuda(storage)
    _check(storage, "storage", torch.int8, storage.device)
    _check_scale(scale, storage)
    _check(flat_ids, "slot_ids", torch.int32, storage.device)
    nb, L, D = _gather_shapes(storage, flat_ids, "gather_reduce_q")
    out = torch.empty((nb, D), dtype=torch.float32, device=storage.device)
    if footprint(storage):
        return out
    with torch.cuda.device(storage.device):
        err = _lib().repro_gather_reduce_q8(
            storage.data_ptr(), scale.data_ptr(), flat_ids.data_ptr(),
            out.data_ptr(), nb, L, D, _stream(storage),
        )
    _raise_on(err, "gather_reduce_q")
    LAUNCHES["gather_reduce_q"] += 1
    return out


def _rows_dtype(storage: torch.Tensor) -> torch.dtype:
    """The fill rows a storage takes: fp32 ones for a bf16 storage (the
    kernel rounds them), the storage's own dtype otherwise."""
    return torch.float32 if storage.dtype == torch.bfloat16 else storage.dtype


def fill(storage: torch.Tensor, fill_slots: torch.Tensor, rows: torch.Tensor) -> None:
    """In place: storage[s] = rows[i] for every s = fill_slots[i] < N.
    storage (N, D) fp32, fp16, bf16 or int8; fill_slots (F,) int32,
    non-negative, valid slots unique; rows (F, D) of the storage's dtype,
    fp32 for a bf16 storage; F > 0. All on one CUDA device. One byte-copy
    kernel serves fp32, fp16 and int8; a bf16 storage's kernel rounds each
    fp32 value to bf16 (nearest even) as it writes it."""
    _check_cuda(storage)
    _check(storage, "storage", tuple(_FORM), storage.device)
    _check(fill_slots, "fill_slots", torch.int32, storage.device)
    _check(rows, "rows", _rows_dtype(storage), storage.device)
    F, N, D = _fill_shapes(storage, fill_slots, rows, "fill")
    key = "fill" + _FORM[storage.dtype]
    if footprint(storage):
        return
    lib = _lib()
    with torch.cuda.device(storage.device):
        if storage.dtype == torch.bfloat16:
            err = lib.repro_fill_f32_to_bf16(
                storage.data_ptr(), fill_slots.data_ptr(), rows.data_ptr(), F, D, N,
                _stream(storage),
            )
        else:
            err = lib.repro_fill(
                storage.data_ptr(), fill_slots.data_ptr(), rows.data_ptr(), F,
                D * storage.element_size(), N, _stream(storage),
            )
    _raise_on(err, key)
    LAUNCHES[key] += 1


def _check_fused(storage, fill_slots, rows, flat_ids, what):
    _check(fill_slots, "fill_slots", torch.int32, storage.device)
    _check(rows, "rows", _rows_dtype(storage), storage.device)
    _check(flat_ids, "slot_ids", torch.int32, storage.device)
    if flat_ids.dim() != 2:
        raise ValueError(f"expected slot_ids (nb, L), got {tuple(flat_ids.shape)}")
    F, N, D = _fill_shapes(storage, fill_slots, rows, what)
    nb, L = flat_ids.shape
    if nb == 0 or L == 0:
        raise ValueError(f"empty operands launch nothing: ops.{what} skips them")
    return F, N, D, nb, L


def fill_gather_reduce(
    storage: torch.Tensor,
    fill_slots: torch.Tensor,
    rows: torch.Tensor,
    flat_ids: torch.Tensor,
) -> torch.Tensor:
    """ONE cooperative launch: the fill (in place, as :func:`fill`), then
    the bag gather-reduce over the post-fill storage -> (nb, D) bags, as
    :func:`gather_reduce` gives them. storage (N, D) fp32, fp16 or bf16;
    fill_slots (F,) int32, non-negative, valid slots unique; rows (F, D) of
    the storage's dtype (fp32 for a bf16 storage); flat_ids (nb, L) int32
    with every id in [0, N); F, nb, L > 0. All on one CUDA device."""
    _check_cuda(storage)
    _check(storage, "storage", _FLOAT, storage.device)
    F, N, D, nb, L = _check_fused(storage, fill_slots, rows, flat_ids,
                                  "fill_gather_reduce")
    out = _bags(storage, nb, D)
    if footprint(storage):
        return out
    lib = _lib()
    fn = {torch.float32: lib.repro_fill_gather_reduce_f32,
          torch.float16: lib.repro_fill_gather_reduce_f16,
          torch.bfloat16: lib.repro_fill_gather_reduce_bf16}[storage.dtype]
    key = "fill_gather_reduce" + _FORM[storage.dtype]
    with torch.cuda.device(storage.device):
        err = fn(storage.data_ptr(), fill_slots.data_ptr(), rows.data_ptr(), F, N,
                 flat_ids.data_ptr(), out.data_ptr(), nb, L, D, _stream(storage))
    _raise_on(err, key)
    LAUNCHES[key] += 1
    return out


def fill_gather_reduce_q(
    storage: torch.Tensor,
    scale: torch.Tensor,
    fill_slots: torch.Tensor,
    rows: torch.Tensor,
    flat_ids: torch.Tensor,
) -> torch.Tensor:
    """ONE cooperative launch of the int8 form: fill the payload rows (in
    place), then the dequantizing gather over the post-fill payload ->
    (nb, D) fp32 bags. ``scale`` (N, 1) fp32 must ALREADY hold the fill
    rows' scales; the kernel only reads it. storage (N, D) int8; rows
    (F, D) int8; the rest as :func:`fill_gather_reduce`."""
    _check_cuda(storage)
    _check(storage, "storage", torch.int8, storage.device)
    _check_scale(scale, storage)
    F, N, D, nb, L = _check_fused(storage, fill_slots, rows, flat_ids,
                                  "fill_gather_reduce_q")
    out = torch.empty((nb, D), dtype=torch.float32, device=storage.device)
    if footprint(storage):
        return out
    with torch.cuda.device(storage.device):
        err = _lib().repro_fill_gather_reduce_q8(
            storage.data_ptr(), scale.data_ptr(), fill_slots.data_ptr(),
            rows.data_ptr(), F, N, flat_ids.data_ptr(), out.data_ptr(), nb, L, D,
            _stream(storage),
        )
    _raise_on(err, "fill_gather_reduce_q")
    LAUNCHES["fill_gather_reduce_q"] += 1
    return out
