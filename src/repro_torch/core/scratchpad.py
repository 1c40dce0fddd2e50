"""Device scratchpad Storage array + its embedding primitives (fp32).

Port of the fp32 half of ``repro/core/scratchpad.py``: ``make_storage``,
``fill``, ``read``, ``gather_reduce``, ``apply_grad``, ``fill_gather_reduce``
and ``storage_bytes``. The reference's ``kernel="xla" | "pallas"`` axis
does not carry over: the kernel follows the storage's device
(``kernels/ops.py``) — the hand-written CUDA kernels on the card, their
plain PyTorch versions on the CPU. Every update (fill, apply_grad, the
fused fill) is IN PLACE on the storage tensor, where the reference donates
the buffer to a functional update; the contents are the same.
``read`` stays plain indexing, as the reference leaves it to XLA: it feeds
the victim write-back over PCIe, not an HBM hot loop. Reduced-precision
storages come with the mixed-precision slice.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def make_storage(num_slots: int, dim: int, *, device="cuda") -> torch.Tensor:
    """Zeroed fp32 scratchpad of ``num_slots`` resident rows on ``device``."""
    return torch.zeros(
        (int(num_slots), int(dim)), dtype=torch.float32, device=resolve_device(device)
    )


def fill(storage: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Insert]: write fetched rows into their allocated slots, IN PLACE, and
    return ``storage``. The reference donates the buffer to a functional
    scatter instead (``repro/core/scratchpad.py: fill``); the result is the
    same array contents. ``slots`` may be padded with positive out-of-bounds
    sentinels (== num_slots, dropped) — never with -1."""
    return ops.fill(storage, slots, rows)


def gather_reduce(storage: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Embedding-bag forward: (B, T, L) slots -> (B, T, D) fp32 summed bags."""
    return ops.gather_reduce(storage, slot_ids)


def storage_bytes(storage: torch.Tensor) -> int:
    """Resident bytes of a storage."""
    return storage.numel() * storage.element_size()


def read(storage: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[Collect]: read victim rows for write-back -> a (len(slots), D) copy.
    Later in-place updates of ``storage`` do not reach it."""
    return storage[slots.long()]


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
