"""Replica precisions: names, byte accounting, the host-side (numpy)
quantize/dequantize of scratchpad rows and the device-side re-quantization
of in-cache updates.

Port of ``repro/core/quantize.py``. The numpy half (``PRECISIONS``,
``SLOT_MULTIPLIER``, ``check_precision``, ``row_bytes``,
``quantize_rows_np``, ``_snap_scale_np``, ``dequantize_rows_np``) is copied
unchanged. The device half (``ROUNDINGS``, ``check_rounding``,
``QuantStorage``, ``_snap_scale``, ``_int8_scale``, ``quantize_int8``,
``quantize_f16``, ``requantize_update``) is PyTorch on the storage's
device, with two differences from the reference's jnp half:

  * randomness comes from an explicit ``torch.Generator`` on the storage's
    device, never from global state (the reference takes a jax key). The
    two give different numbers, so stochastic rounding is held to the
    reference statistically; ``nearest`` is bitwise;
  * ``requantize_update`` works on the unique TOUCHED rows only — it
    gathers them, dequantizes, adds their coalesced delta, re-scales,
    quantizes and writes them back in place. The reference builds a dense
    (num_slots, D) fp32 delta and a ``where`` over the whole storage; its
    untouched rows come back bit-exact and every other step is row-local,
    so the result is the same, without a 2 GB fp32 buffer per step for a
    4M-slot int8 scratchpad.

The host table always keeps fp32 *master* rows; the scratchpad may hold a
reduced-precision *replica* of each resident row. ``fp16`` rows are plain
``float16`` (round-to-nearest-even); ``int8`` rows carry a symmetric
per-row fp32 scale ``max|row| / 127`` (1.0 for all-zero rows), SNAPPED to
16 explicit mantissa bits so every dequant product ``payload * scale`` is
exact in fp32. ``SLOT_MULTIPLIER`` counts row payload only; ``row_bytes``
counts the int8 scale column too.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PRECISIONS = ("fp32", "fp16", "int8")
ROUNDINGS = ("nearest", "stochastic")

#: rows held per fp32-row of byte budget (payload bytes only; see module doc)
SLOT_MULTIPLIER = {"fp32": 1, "fp16": 2, "int8": 4}

_INT8_MAX = 127.0
_F16_MAX = 65504.0
# f32 has 23 mantissa bits, f16 has 10: stochastic rounding to f16 adds
# U[0, 2^13) to the low bits then truncates them.
_F16_DROP_BITS = 13
# int8 scale snap: keep 16 explicit mantissa bits so the dequant product
# payload*scale is exact in fp32; clamp out of the subnormal range so the
# product's exactness argument holds everywhere.
_SCALE_DROP_BITS = 23 - 16
_SCALE_MASK = np.uint32((0xFFFFFFFF >> _SCALE_DROP_BITS) << _SCALE_DROP_BITS)
_F32_MIN_NORMAL = np.float32(2.0 ** -126)
# the same masks as int32 bit patterns, for the torch bit ops
# (0xFFFFFF80 is -128 and ~0x1FFF is -8192 as int32)
_SCALE_MASK_I32 = int(_SCALE_MASK.astype(np.int64)) - (1 << 32)
_F16_KEEP_MASK_I32 = ~((1 << _F16_DROP_BITS) - 1)


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    return precision


def check_rounding(rounding: str) -> str:
    if rounding not in ROUNDINGS:
        raise ValueError(
            f"rounding must be one of {ROUNDINGS}, got {rounding!r}"
        )
    return rounding


class QuantStorage(NamedTuple):
    """int8 scratchpad storage: row payload + per-row fp32 scale column,
    both on one device. The tuple is immutable; its tensors are updated in
    place."""

    data: torch.Tensor   # (num_slots, dim) int8
    scale: torch.Tensor  # (num_slots, 1) fp32


def row_bytes(dim: int, precision: str, itemsize: int = 4) -> int:
    """Bytes ONE row moves over a link (or occupies at rest), including the
    int8 per-row scale metadata. ``itemsize`` is the fp32-path element size
    (4 unless an experiment stores bf16 masters)."""
    check_precision(precision)
    if precision == "fp16":
        return dim * 2
    if precision == "int8":
        return dim * 1 + 4  # payload + fp32 scale
    return dim * itemsize


# --------------------------------------------------------------------------- #
# host-side (numpy) quantize/dequantize — the [Collect]/write-back halves
# --------------------------------------------------------------------------- #
def quantize_rows_np(rows: np.ndarray, precision: str):
    """Quantize a (n, dim) block of fp32 master rows for the h2d fill.

    Returns the rows unchanged for fp32, a float16 array for fp16, and an
    ``(int8 data, fp32 scale (n, 1))`` pair for int8. Deterministic
    round-to-nearest: fill quantization re-encodes the master, so there is
    no accumulated-update bias for stochastic rounding to fix.
    """
    check_precision(precision)
    if precision == "fp32":
        return rows
    rows = np.asarray(rows, dtype=np.float32)
    if precision == "fp16":
        return rows.astype(np.float16)
    absmax = np.max(np.abs(rows), axis=1, keepdims=True)
    scale = np.where(absmax > 0, absmax / _INT8_MAX, np.float32(1.0))
    scale = _snap_scale_np(scale.astype(np.float32))
    q = np.clip(np.round(rows / scale), -_INT8_MAX, _INT8_MAX)
    return q.astype(np.int8), scale


def _snap_scale_np(scale: np.ndarray) -> np.ndarray:
    """Clamp to the fp32 normal range and truncate to 16 explicit mantissa
    bits — the exact-product discipline (module doc). Rows whose absmax is
    subnormal quantize against the clamped (larger) scale, i.e. to a zero
    payload: the documented sub-1e-36 edge case."""
    s = np.maximum(scale.astype(np.float32), _F32_MIN_NORMAL)
    return (s.view(np.uint32) & _SCALE_MASK).view(np.float32)


def dequantize_rows_np(rows, precision: str) -> np.ndarray:
    """Write-back half: replica rows (as produced by ``quantize_rows_np`` or
    read back from a quantized scratchpad) -> fp32 rows for the master."""
    check_precision(precision)
    if precision == "fp32":
        return np.asarray(rows)
    if precision == "fp16":
        return np.asarray(rows, dtype=np.float16).astype(np.float32)
    data, scale = rows
    return np.asarray(data, dtype=np.float32) * np.asarray(
        scale, dtype=np.float32
    )


# --------------------------------------------------------------------------- #
# device-side (torch) re-quantization — the in-cache update epilogue
# --------------------------------------------------------------------------- #
def _snap_scale(scale: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``_snap_scale_np``: the same bit manipulation, on an
    int32 view."""
    s = torch.clamp(scale.to(torch.float32), min=float(_F32_MIN_NORMAL))
    return (s.view(torch.int32) & _SCALE_MASK_I32).view(torch.float32)


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    # A subnormal maximum counts as zero (scale 1.0, zero payload), as in
    # the reference: XLA flushes subnormals to zero on the CPU and the TPU,
    # so its ``absmax > 0`` is false there. Either way the row dequantizes
    # to zeros; this keeps the scale bitwise equal too.
    absmax = x.abs().amax(dim=-1, keepdim=True)
    return _snap_scale(
        torch.where(absmax >= float(_F32_MIN_NORMAL), absmax / _INT8_MAX,
                    torch.ones_like(absmax))
    )


def quantize_int8(
    x: torch.Tensor, scale: torch.Tensor, rounding: str,
    generator: torch.Generator = None,
) -> torch.Tensor:
    """fp32 -> int8 against a given per-row scale. ``stochastic`` uses
    ``floor(y + u)``, u ~ U[0, 1) drawn from ``generator``: unbiased for y
    within the clip range. ``nearest`` rounds half to even (as
    ``jnp.round``)."""
    check_rounding(rounding)
    y = x.to(torch.float32) / scale
    if rounding == "stochastic":
        u = torch.rand(y.shape, generator=generator, dtype=torch.float32,
                       device=y.device)
        q = torch.floor(y + u)
    else:
        q = torch.round(y)
    return torch.clamp(q, -_INT8_MAX, _INT8_MAX).to(torch.int8)


def quantize_f16(
    x: torch.Tensor, rounding: str, generator: torch.Generator = None
) -> torch.Tensor:
    """fp32 -> fp16. ``stochastic`` adds U[0, 2^13) from ``generator`` to
    the low f32 mantissa bits then truncates them — unbiased for values in
    the f16 normal range (subnormal results re-round on the final cast, a
    bias below one f16 subnormal ulp)."""
    check_rounding(rounding)
    x = torch.clamp(x.to(torch.float32), -_F16_MAX, _F16_MAX)
    if rounding == "nearest":
        return x.to(torch.float16)
    # int32 add wraps as the reference's uint32 add does; |x| <= 65504
    # keeps every pattern far from the int32 overflow point
    noise = torch.randint(0, 1 << _F16_DROP_BITS, x.shape, generator=generator,
                          dtype=torch.int32, device=x.device)
    bits = (x.view(torch.int32) + noise) & _F16_KEEP_MASK_I32
    out = bits.view(torch.float32).to(torch.float16)
    # rounding up at the very top of the f16 range can overflow to inf
    return torch.clamp(out, -_F16_MAX, _F16_MAX)


def requantize_update(
    storage,
    rows: torch.Tensor,
    delta: torch.Tensor,
    precision: str,
    rounding: str,
    generator: torch.Generator = None,
):
    """Apply a coalesced fp32 ``delta`` (U, D) to the UNIQUE touched
    ``rows`` (U,) of a quantized storage, IN PLACE, and return the storage.

    Every other row is left as it was, bit for bit. int8 rows recompute
    their per-row scale from the updated fp32 value, so zero-born rows start
    learning and saturated rows re-range instead of clipping forever. The
    stochastic noise is drawn over the (U, D) block in the order of
    ``rows``."""
    check_precision(precision)
    if rows.numel() == 0:
        return storage
    idx = rows.long()
    if precision == "fp16":
        x = storage[idx].to(torch.float32) + delta
        storage[idx] = quantize_f16(x, rounding, generator)
        return storage
    if precision != "int8":
        raise ValueError("requantize_update takes fp16 or int8 storage")
    data, scale = storage
    x = data[idx].to(torch.float32) * scale[idx] + delta
    new_scale = _int8_scale(x)
    data[idx] = quantize_int8(x, new_scale, rounding, generator)
    scale[idx] = new_scale
    return storage
