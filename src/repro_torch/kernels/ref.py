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

And of its LM half, held to a tolerance (the kernels sum in another order):

  * ``flash_attention_ref`` — ``repro/kernels/ref.py: flash_attention_ref``:
    a direct softmax over the (Sq, Skv) scores in fp32, masked where
    ``kv_pos > q_pos`` (causal) or ``q_pos - kv_pos >= window``; p is
    rounded to v's dtype before the PV product.
  * ``ssd_chunk_scan_ref`` — the chunk loop of ``repro/models/mamba2.py:
    ssd_scan`` with ``h0=None, low_prec=False``, in the same einsum order
    (the three-operand state einsum as ``x . (B * wj)``, the TPU kernel's
    order), computed in dt's dtype (fp32 on the serving path). The prefix
    sum of ``dt * A`` is accumulated in fp64 and rounded once — what torch's
    CPU ``cumsum`` does anyway — so the card's plain version and the kernel
    see the same ``cum``. In fp32 at Q = 256, y lies about 5e-4 from the
    exact recurrence, as the reference's does (tests/test_torch_lm_kernels.
    py), more than the 2e-4 the kernel is held to against this version.
"""
from __future__ import annotations

import math

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


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window=None, q_offset: int = 0,
) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Skv, K, hd) with H % K == 0 -> (B, Sq, H,
    hd) in q's dtype. Direct softmax attention; kv head h // (H // K); query
    row i at position ``q_offset`` + i (``layers.chunked_attention``'s)."""
    B, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bjhd->bhqj", q.float(), k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kv_pos <= q_pos
    if window is not None:
        valid &= q_pos - kv_pos < window
    s = torch.where(valid[None, None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqj,bjhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def ssd_chunk_scan_ref(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh) fp32, post-softplus
    A: torch.Tensor,  # (nh,) fp32, negative
    Bm: torch.Tensor,  # (B, S, ng, ds) fp32
    Cm: torch.Tensor,  # (B, S, ng, ds) fp32
    chunk: int,
):
    """Returns (y (B, S, nh, hd) in x's dtype, h_final (B, nh, hd, ds) in
    dt's dtype). S is zero-padded to a chunk multiple (dt = 0 leaves the state
    unchanged), as in the reference."""
    Bt, S, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // ng
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // Q
    # chunked views, group-major head layout (B, nc, Q, ng, hpg, ...)
    xg = x.reshape(Bt, nc, Q, ng, hpg, hd)
    dtg = dt.reshape(Bt, nc, Q, ng, hpg)
    Bg = Bm.reshape(Bt, nc, Q, ng, ds)
    Cg = Cm.reshape(Bt, nc, Q, ng, ds)
    Ag = A.reshape(ng, hpg)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[
        None, :, :, None, None]  # i >= j
    neg_inf = torch.full((), -math.inf, device=x.device)
    h = torch.zeros((Bt, ng, hpg, hd, ds), dtype=dt.dtype, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xg[:, c].to(dt.dtype), dtg[:, c], Bg[:, c], Cg[:, c]
        a = dtc * Ag  # (B, Q, ng, hpg), <= 0
        cum = torch.cumsum(a, dim=1, dtype=torch.float64).to(dt.dtype)
        total = cum[:, -1]  # (B, ng, hpg)
        # intra-chunk quadratic form; the i < j exponent is positive and
        # would overflow -> mask inside the exp (masking after gives inf*0)
        G = torch.einsum("bigs,bjgs->bgij", Cc, Bc)
        expo = cum[:, :, None] - cum[:, None, :]  # (B, i, j, ng, hpg)
        decay = torch.exp(torch.where(tri, expo, neg_inf))
        w_ij = decay * dtc[:, None, :]
        s = G[..., None] * w_ij.permute(0, 3, 1, 2, 4)  # (B, ng, i, j, hpg)
        y_intra = torch.einsum("bgijn,bjgnd->bignd", s, xc)
        # inter-chunk: contribution of the incoming state
        y_inter = torch.einsum("bigs,bgnds->bignd", Cc, h) * torch.exp(cum)[..., None]
        # state update
        wj = torch.exp(total[:, None] - cum) * dtc  # (B, Q, ng, hpg)
        Bw = Bc[:, :, :, None, :] * wj[..., None]  # (B, Q, ng, hpg, ds)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjgnd,bjgns->bgnds", xc, Bw)
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, 1).reshape(Bt, nc * Q, nh, hd)[:, :S]
    return y, h.reshape(Bt, nh, hd, ds)
