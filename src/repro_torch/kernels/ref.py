"""Plain PyTorch versions of the port's kernels, in the reference's op order.

Port of ``repro/kernels/ref.py``'s embedding half: ``gather_reduce_ref``,
``fill_ref``, ``fill_gather_reduce_ref``, ``scatter_deltas``,
``coalesce_apply_ref``, ``gather_reduce_q_ref`` and
``fill_gather_reduce_q_ref``, plus ``scatter_add_ref``, the plain version
of the backward kernel. They are what ``kernels/ops.py`` runs for tensors
on the CPU, and what ``chip_smoke.py`` holds each CUDA kernel against on
the card (bitwise: the kernels do the same fp32 adds in the same order).

  * ``gather_reduce_ref`` starts each bag from its ``l = 0`` row and adds
    rows ``l = 1 .. L-1`` in order, in fp32 — a plain ``sum`` would be free
    to reassociate and could never be bit-identical to the kernel.
  * ``gather_reduce_q_ref`` dequantizes each addend first —
    ``row.float()``, times the row's scale for int8 storage — and then
    sums in the same order; its bags stay fp32 (``gather_reduce_ref``
    casts back to the storage dtype, so it must not be reused for fp16).
    The int8 product is exact (snapped scales, ``core/quantize.py``), so
    the order of mul and add cannot change a bit.
  * ``fill_ref`` drops slots ``>= N`` (the planner's pad sentinel is
    ``== num_slots``, ``core/plan.py: pad_index``). Torch's index ops do
    not drop out-of-range indices, so the version masks them explicitly.
    It writes in place (the reference returns a new array).
  * ``scatter_add_ref`` updates every looked-up row as
    ``row + d_first + d_next + ...`` with the deltas in flat bag-major
    order — what the reference's ``storage.at[flat].add(dup)`` does. Torch's
    ``index_add_`` keeps that order on the CPU but not on the card (atomics),
    so the version orders it explicitly: a stable sort by slot ranks every
    lookup among the lookups of its row, and rank level ``r`` adds the
    ``r``-th delta of every row at once (the rows of one level are unique,
    so the level is a plain gather-add-scatter with no race). It writes in
    place, and so does ``coalesce_apply_ref``.
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


def fill_gather_reduce_ref(
    storage: torch.Tensor,
    fill_slots: torch.Tensor,
    fill_rows: torch.Tensor,
    slot_ids: torch.Tensor,
):
    """Fused [Insert]-fill + [Train]-gather forward: the fill lands (in
    place) before the gather — the split engine's intra-cycle order.
    Returns (storage, bags)."""
    storage = fill_ref(storage, fill_slots, fill_rows)
    return storage, gather_reduce_ref(storage, slot_ids)


def gather_reduce_q_ref(
    storage: torch.Tensor, scale, slot_ids: torch.Tensor
) -> torch.Tensor:
    """Quantized-storage gather: storage (N, D) fp16, or int8 with its
    (N, 1) fp32 ``scale`` column (``None`` for fp16); slot_ids (..., L) ->
    (..., D) fp32 bags. Each addend is ``row.float() [* scale_row]``; the
    sum runs over l in order from the l=0 addend."""
    if slot_ids.shape[-1] == 0 or slot_ids.numel() == 0:
        return torch.zeros(
            slot_ids.shape[:-1] + (storage.shape[-1],),
            dtype=torch.float32,
            device=storage.device,
        )
    idx = slot_ids.long()
    emb = storage[idx].to(torch.float32)
    if scale is not None:
        emb = emb * scale[idx]
    out = emb[..., 0, :]
    for l in range(1, emb.shape[-2]):
        out = out + emb[..., l, :]
    return out


def fill_gather_reduce_q_ref(
    storage: torch.Tensor,
    scale,
    fill_slots: torch.Tensor,
    fill_rows: torch.Tensor,
    slot_ids: torch.Tensor,
):
    """Fused quantized fill + gather: the (already quantized) rows land in
    the payload first (in place), then the dequantizing gather runs, so
    bags see this call's fills. ``scale`` must ALREADY hold the fill rows'
    scales (``core/scratchpad.py`` scatters it first). Returns (payload
    storage, fp32 bags)."""
    storage = fill_ref(storage, fill_slots, fill_rows)
    return storage, gather_reduce_q_ref(storage, scale, slot_ids)


def scatter_deltas(
    storage: torch.Tensor, bag_grads: torch.Tensor, lr: float
) -> torch.Tensor:
    """The canonical pre-rounded per-bag SGD delta ``-lr * bag_grads`` in the
    storage dtype, rounded once per bag before any accumulation (an
    in-kernel ``acc += -lr * g`` could contract to an FMA)."""
    return ((-lr) * bag_grads).to(storage.dtype)


def scatter_add_ref(
    storage: torch.Tensor, slot_ids: torch.Tensor, bag_deltas: torch.Tensor
) -> torch.Tensor:
    """In place: ``storage[slot_ids[b, l]] += bag_deltas[b]`` for every
    (b, l), duplicates accumulated in flat bag-major order. storage (N, D);
    slot_ids (nb, L) with ids in [0, N); bag_deltas (nb, D) in the storage
    dtype. Returns ``storage``."""
    L = slot_ids.shape[-1]
    flat = slot_ids.reshape(-1).long()
    n = flat.numel()
    if n == 0:
        return storage
    keys, perm = torch.sort(flat, stable=True)
    pos = torch.arange(n, device=flat.device)
    head = torch.ones(n, dtype=torch.bool, device=flat.device)
    head[1:] = keys[1:] != keys[:-1]
    seg_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), 0).values
    rank = pos - seg_start  # lookups of the same row before this one
    order = torch.argsort(rank, stable=True)
    keys, bags = keys[order], (perm // L)[order]
    start = 0
    for count in torch.bincount(rank).tolist():
        s = keys[start:start + count]  # unique within one rank level
        storage[s] = storage[s] + bag_deltas[bags[start:start + count]]
        start += count
    return storage


def coalesce_apply_ref(
    storage: torch.Tensor, slot_ids: torch.Tensor, bag_grads: torch.Tensor, lr: float
) -> torch.Tensor:
    """In place: storage (N, D); slot_ids (..., L); bag_grads (..., D).
    Gradient duplication (bag -> each looked-up row), coalescing of duplicate
    rows (scatter-add in flat bag-major order) and the SGD update."""
    L = slot_ids.shape[-1]
    D = bag_grads.shape[-1]
    if L == 0 or slot_ids.numel() == 0:
        return storage
    deltas = scatter_deltas(storage, bag_grads, lr).reshape(-1, D)
    return scatter_add_ref(storage, slot_ids.reshape(-1, L), deltas)
