"""Replica precisions: names, byte accounting and the host-side (numpy)
quantize/dequantize of scratchpad rows.

Port of the numpy half of ``repro/core/quantize.py`` (``PRECISIONS``,
``SLOT_MULTIPLIER``, ``check_precision``, ``row_bytes``,
``quantize_rows_np``, ``_snap_scale_np``, ``dequantize_rows_np``), copied
unchanged. The device-side re-quantization of in-cache updates comes with
the mixed-precision slice.

The host table always keeps fp32 *master* rows; the scratchpad may hold a
reduced-precision *replica* of each resident row. ``fp16`` rows are plain
``float16`` (round-to-nearest-even); ``int8`` rows carry a symmetric
per-row fp32 scale ``max|row| / 127`` (1.0 for all-zero rows), SNAPPED to
16 explicit mantissa bits so every dequant product ``payload * scale`` is
exact in fp32. ``SLOT_MULTIPLIER`` counts row payload only; ``row_bytes``
counts the int8 scale column too.
"""
from __future__ import annotations

import numpy as np

PRECISIONS = ("fp32", "fp16", "int8")

#: rows held per fp32-row of byte budget (payload bytes only; see module doc)
SLOT_MULTIPLIER = {"fp32": 1, "fp16": 2, "int8": 4}

_INT8_MAX = 127.0
# int8 scale snap: keep 16 explicit mantissa bits so the dequant product
# payload*scale is exact in fp32; clamp out of the subnormal range so the
# product's exactness argument holds everywhere.
_SCALE_DROP_BITS = 23 - 16
_SCALE_MASK = np.uint32((0xFFFFFFFF >> _SCALE_DROP_BITS) << _SCALE_DROP_BITS)
_F32_MIN_NORMAL = np.float32(2.0 ** -126)


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}"
        )
    return precision


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
