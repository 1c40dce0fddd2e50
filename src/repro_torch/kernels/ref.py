"""Plain PyTorch versions of the port's kernels, in the reference's op order.

Port of the fp32 ``gather_reduce_ref`` and ``fill_ref`` of
``repro/kernels/ref.py``. They are what ``kernels/ops.py`` runs for tensors
on the CPU, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card (bitwise: the kernels do the same fp32 adds in the same order).

  * ``gather_reduce_ref`` starts each bag from its ``l = 0`` row and adds
    rows ``l = 1 .. L-1`` in order, in fp32 — a plain ``sum`` would be free
    to reassociate and could never be bit-identical to the kernel.
  * ``fill_ref`` drops slots ``>= N`` (the planner's pad sentinel is
    ``== num_slots``, ``core/plan.py: pad_index``). Torch's index ops do
    not drop out-of-range indices, so the version masks them explicitly.
    It writes in place (the reference returns a new array).
"""
from __future__ import annotations

import torch


def gather_reduce_ref(storage: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """storage (N, D); slot_ids (..., L) -> (..., D) summed bags, cast back
    to the storage dtype."""
    if slot_ids.shape[-1] == 0 or slot_ids.numel() == 0:
        return torch.zeros(
            slot_ids.shape[:-1] + (storage.shape[-1],),
            dtype=storage.dtype,
            device=storage.device,
        )
    emb = storage[slot_ids.long()].to(torch.float32)
    out = emb[..., 0, :]
    for l in range(1, emb.shape[-2]):
        out = out + emb[..., l, :]
    return out.to(storage.dtype)


def fill_ref(
    storage: torch.Tensor, fill_slots: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """[Insert]-fill, in place: ``storage[s] = rows[i]`` for every
    ``s = fill_slots[i] < N``; slots ``>= N`` are dropped. Valid slots must
    be non-negative and unique within one call (the planner assigns each
    slot once per plan). Returns ``storage``."""
    keep = fill_slots < storage.shape[0]
    storage[fill_slots[keep].long()] = rows[keep].to(storage.dtype)
    return storage
