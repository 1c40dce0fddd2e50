"""Device scratchpad Storage array + its embedding primitives.

Port of ``repro/core/scratchpad.py``: ``make_storage``, ``fill``, ``read``,
``gather_reduce``, ``apply_grad``, ``fill_gather_reduce``,
``storage_bytes`` and ``storage_precision``, and the reduced-precision
primitives ``gather_reduce_q``, ``apply_grad_q`` and
``fill_gather_reduce_q``. The reference's ``kernel="xla" | "pallas"`` axis
does not carry over: the kernel follows the storage's device
(``kernels/ops.py``) — the hand-written CUDA kernels on the card, their
plain PyTorch versions on the CPU. Every update (fill, apply_grad, the
fused fill, their ``_q`` twins) is IN PLACE on the storage tensors, where
the reference donates the buffer to a functional update; the contents are
the same. ``read`` stays plain indexing, as the reference leaves it to XLA:
it feeds the victim write-back over PCIe, not an HBM hot loop.

bf16 storage (``make_storage(..., dtype=torch.bfloat16)``, the reference's
``storage_dtype`` knob of the fp32 path): the same fp32-path primitives on
a bf16 tensor, through the kernels' bf16 forms. The gather returns bf16
bags (the fp32 sum rounded once), the fill rounds fp32 rows into their
slots, and the update rounds the pre-rounded bf16 deltas and every add to
bf16, as the reference's bf16 storage does. ``storage_precision`` reports
it as "fp32", as the reference's does: it rides the fp32 path, not the
quantized one.

Mixed precision (``core/quantize.py``): the storage may be an fp16 tensor
or an int8 :class:`QuantStorage` (payload + per-row fp32 scale column). The
gather dequantizes in the kernel and yields fp32 bags; the backward
coalesces fp32 deltas of the touched rows with the same scatter kernel as
the fp32 path, then re-quantizes those rows only
(``quantize.requantize_update``).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.quantize import QuantStorage
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def make_storage(num_slots: int, dim: int, *, precision: str = "fp32",
                 dtype=None, device="cuda"):
    """Zeroed scratchpad of ``num_slots`` resident rows on ``device``: an
    fp32 or fp16 tensor, or for ``precision="int8"`` a
    :class:`QuantStorage` whose scale column starts at 1.0 (dequantized
    zeros are zeros, and no scale is ever 0). At fp32 precision ``dtype``
    (the runtimes' ``storage_dtype``: torch.float32, the default, or
    torch.bfloat16) is the tensor's dtype, as the reference's ``dtype``; a
    reduced precision takes none, and any other dtype raises."""
    qz.check_precision(precision)
    if precision != "fp32" and dtype is not None:
        raise ValueError("storage_dtype is the fp32-path experiment knob; "
                         "reduced precision is selected with precision= alone")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(
            f"storage_dtype={dtype!r}: the fp32 path stores torch.float32 or "
            "torch.bfloat16 rows; other storage dtypes are not ported yet "
            "(ROADMAP.md Queue 1 item 26, the options the port refuses)"
        )
    dt = torch.float32 if dtype is None else dtype
    dev = resolve_device(device)
    shape = (int(num_slots), int(dim))
    if precision == "int8":
        return QuantStorage(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.ones((shape[0], 1), dtype=torch.float32, device=dev),
        )
    if precision == "fp16":
        dt = torch.float16
    return torch.zeros(shape, dtype=dt, device=dev)


def _scatter_scale(scale: torch.Tensor, slots: torch.Tensor, rows_scale) -> None:
    """The int8 scale column's drop-mode scatter: torch indexing does not
    drop out-of-range slots, so the pad sentinels (>= N) are masked out."""
    keep = slots < scale.shape[0]
    scale[slots[keep].long()] = rows_scale[keep]


def fill(storage, slots: torch.Tensor, rows):
    """[Insert]: write fetched rows into their allocated slots, IN PLACE, and
    return ``storage``. The reference donates the buffer to a functional
    scatter instead (``repro/core/scratchpad.py: fill``); the result is the
    same array contents. ``slots`` may be padded with positive out-of-bounds
    sentinels (== num_slots, dropped) — never with -1. For an int8
    :class:`QuantStorage`, ``rows`` is the host-quantized ``(payload,
    scale (F, 1))`` pair: the scale column is a plain indexed scatter
    (metadata, not a hot loop) and the payload goes through the fill
    kernel."""
    if isinstance(storage, QuantStorage):
        rows_data, rows_scale = rows
        _scatter_scale(storage.scale, slots, rows_scale)
        ops.fill(storage.data, slots, rows_data)
        return storage
    return ops.fill(storage, slots, rows)


def gather_reduce(storage: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-bag forward: (B, T, L) slots -> (B, T, D) summed bags."""
    return ops.gather_reduce(storage, slot_ids)


def read(storage, slots: torch.Tensor):
    """[Collect]: read victim rows for write-back -> a (len(slots), D) copy.
    Later in-place updates of ``storage`` do not reach it. A quantized
    storage reads back its QUANTIZED rows — ``(payload, scale)`` for int8 —
    so the d2h transfer moves the small replica bytes; the host dequantizes
    into the fp32 master (``quantize.dequantize_rows_np``)."""
    idx = slots.long()
    if isinstance(storage, QuantStorage):
        return storage.data[idx], storage.scale[idx]
    return storage[idx]


def apply_grad(
    storage: torch.Tensor, slot_ids: torch.Tensor, bag_grads: torch.Tensor, lr: float
) -> torch.Tensor:
    """Backward, in place: duplicate bag grads to each looked-up row,
    coalesce duplicates (scatter-add), apply SGD. slot_ids (B,T,L),
    bag_grads (B,T,D). Returns ``storage``."""
    return ops.coalesce_apply(storage, slot_ids, bag_grads, lr)


def fill_gather_reduce(
    storage: torch.Tensor,
    fill_slots: torch.Tensor,
    fill_rows: torch.Tensor,
    slot_ids: torch.Tensor,
):
    """Fused [Insert]-fill + embedding-bag forward for one pipeline cycle:
    the fill lands (in place) before the gather — the split engine's
    intra-cycle order. Returns (storage, (B, T, D) bags); on the card ONE
    kernel launch (the fused cycle kernel)."""
    return ops.fill_gather_reduce(storage, fill_slots, fill_rows, slot_ids)


# --------------------------------------------------------------------------- #
# mixed-precision primitives (fp16 tensor / int8 QuantStorage -> fp32 bags)
# --------------------------------------------------------------------------- #
def _payload_and_scale(storage):
    if isinstance(storage, QuantStorage):
        return storage.data, storage.scale
    return storage, None


def gather_reduce_q(storage, slot_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-bag forward over a reduced-precision storage: dequantize in
    the kernel, return fp32 bags (the MLP always consumes fp32)."""
    data, scale = _payload_and_scale(storage)
    return ops.gather_reduce_q(data, scale, slot_ids)


def apply_grad_q(
    storage,
    slot_ids: torch.Tensor,
    bag_grads: torch.Tensor,
    lr: float,
    generator: torch.Generator = None,
    *,
    rounding: str = "stochastic",
):
    """Quantized backward, in place: coalesce the per-bag fp32 deltas
    ``-lr * g`` onto the unique touched rows (the SAME scatter kernel as the
    fp32 path, into a zeroed (U, D) fp32 buffer), then dequantize + apply +
    re-quantize those rows only (``quantize.requantize_update``; the noise
    of ``rounding="stochastic"`` comes from ``generator``, which the
    trainer seeds per step). Returns ``storage``.

    The buffer holds one row per unique touched slot in sorted slot order,
    where the reference's holds every slot: each row still receives
    ``0 + d_first + d_next + ...`` in flat bag-major order, so its values
    are the same bit for bit."""
    data, _ = _payload_and_scale(storage)
    L = slot_ids.shape[-1]
    if L == 0 or slot_ids.numel() == 0:
        return storage
    D = data.shape[1]
    flat = slot_ids.reshape(-1)
    rows, inv = torch.unique(flat, sorted=True, return_inverse=True)
    deltas = ((-lr) * bag_grads).to(torch.float32).reshape(-1, D)
    buf = torch.zeros((rows.numel(), D), dtype=torch.float32, device=data.device)
    ops.coalesce_deltas(buf, inv.to(torch.int32).reshape(-1, L), deltas)
    precision = "int8" if isinstance(storage, QuantStorage) else "fp16"
    return qz.requantize_update(storage, rows, buf, precision, rounding, generator)


def fill_gather_reduce_q(
    storage,
    fill_slots: torch.Tensor,
    fill_rows,
    slot_ids: torch.Tensor,
):
    """Fused [Insert]-fill + dequantizing gather for one cycle, in place.
    For int8, ``fill_rows`` is the host-quantized ``(payload, scale)`` pair
    and the scale column is scattered BEFORE the fused launch, so
    intra-cycle gathers of just-filled rows see payload (written in the
    launch) and scale consistently. Returns (storage, fp32 bags) — one
    kernel launch on the card."""
    if isinstance(storage, QuantStorage):
        rows_data, rows_scale = fill_rows
        _scatter_scale(storage.scale, fill_slots, rows_scale)
        _, bags = ops.fill_gather_reduce_q(
            storage.data, storage.scale, fill_slots, rows_data, slot_ids
        )
        return storage, bags
    return ops.fill_gather_reduce_q(storage, None, fill_slots, fill_rows, slot_ids)


# --------------------------------------------------------------------------- #
# byte accounting
# --------------------------------------------------------------------------- #
def storage_bytes(storage) -> int:
    """TRUE resident bytes of a storage, INCLUDING quantization metadata
    (the int8 per-row scale column)."""
    if isinstance(storage, QuantStorage):
        return sum(t.numel() * t.element_size() for t in storage)
    return storage.numel() * storage.element_size()


def storage_precision(storage) -> str:
    """The replica precision a storage operand encodes (a bf16 storage
    reports "fp32": it rides the fp32 path, as in the reference)."""
    if isinstance(storage, QuantStorage):
        return "int8"
    if storage.dtype == torch.float16:
        return "fp16"
    return "fp32"
