"""Device scratchpad Storage array + its embedding primitives (fp32).

Port of the fp32 half of ``repro/core/scratchpad.py``: ``make_storage``,
``fill``, ``gather_reduce`` and ``storage_bytes``. The reference's
``kernel="xla" | "pallas"`` axis does not carry over: the kernel follows
the storage's device (``kernels/ops.py``) — the hand-written CUDA kernels
on the card, their plain PyTorch versions on the CPU. Reduced-precision
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
