"""Public wrappers of the port's kernels: dispatch by the tensor's device.

Port of the fp32 ``gather_reduce`` and ``fill`` of ``repro/kernels/ops.py``.
The wrappers own what the raw launchers do not take:

  * natural shapes — leading batch/table dims of ``slot_ids`` are flattened
    to (nb, L) and restored on the way out;
  * empty operands — zero bags, zero lookups or zero fill rows launch
    nothing;
  * dispatch — a CUDA tensor goes to the hand-written kernel
    (``kernels/gather_reduce.py``) or the call raises; a CPU tensor goes to
    the plain PyTorch version (``kernels/ref.py``). There is no knob and no
    fallback from one to the other.

The reference pads the lane dim to its TPU tile; the CUDA kernels take any
``D``, so the port does not pad.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import gather_reduce as _gr
from repro_torch.kernels import ref as _ref


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_gr.LAUNCHES)


def reset_launch_counts() -> None:
    for k in _gr.LAUNCHES:
        _gr.LAUNCHES[k] = 0


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for {t.device} tensors: use cuda or cpu")
    return t.device.type


def gather_reduce(storage: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """storage (N, D); slot_ids (..., L) int32 -> (..., D) summed bags."""
    lead = tuple(slot_ids.shape[:-1])
    L = slot_ids.shape[-1]
    D = storage.shape[1]
    if L == 0 or slot_ids.numel() == 0:  # empty cycle: no launch
        return torch.zeros(lead + (D,), dtype=storage.dtype, device=storage.device)
    flat = slot_ids.reshape(-1, L)
    if _route(storage) == "cuda":
        out = _gr.gather_reduce(storage, flat)
    else:
        out = _ref.gather_reduce_ref(storage, flat)
    return out.reshape(*lead, D)


def fill(
    storage: torch.Tensor, fill_slots: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """In place: storage (N, D); fill_slots (F,) int32 padded with positive
    sentinels (>= N, dropped); rows (F, D). Valid slots must be unique
    within the call; negative slots are rejected. Returns ``storage``."""
    if fill_slots.numel() == 0:  # empty cycle: no launch
        return storage
    if bool((fill_slots < 0).any()):
        raise ValueError("fill_slots must be non-negative (pad with num_slots)")
    if _route(storage) == "cuda":
        _gr.fill(storage, fill_slots, rows)
        return storage
    return _ref.fill_ref(storage, fill_slots, rows)
