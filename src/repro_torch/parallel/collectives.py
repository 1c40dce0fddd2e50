"""Explicit-collective building blocks of the port, on ``torch.distributed``.

Port of ``repro/parallel/collectives.py``. The reference runs its
collectives inside ``shard_map`` bodies; the port runs them on the process
groups of a ``DeviceMesh`` (``launch/mesh.py: make_host_mesh``: NCCL on the
card, gloo ranks on the CPU), each rank holding its own shard:

  * ``sharded_logits`` / ``sharded_xent_loss`` — decode-time logits and the
    chunked cross entropy of LM training. With ``mesh=None`` (one card) the
    vocab is not sharded and the reference's per-shard log-sum-exp is the
    whole row's, as before; with a mesh whose "model" axis is wider than 1
    the head is this rank's column shard and the forms are vocab-parallel
    (:func:`vocab_parallel_logits`, :func:`vocab_parallel_xent_loss`):
    log-sum-exp and the label's logit reduced over "model";
  * ``vocab_sharded_lookup`` — the model-parallel embedding gather: a masked
    local take, then a sum over "model"; its backward is the identity
    through the sum and the masked local scatter (an ``autograd.Function``
    of its own: ``torch.distributed.nn``'s all-reduce sums the gradients in
    its backward, which would scale each shard's table gradient by the TP
    width);
  * ``hierarchical_psum`` — cross-pod gradient sync: reduce-scatter over
    "data", all-reduce over "pod" on 1/N of the bytes, all-gather over
    "data";
  * ``ef_int8_psum`` — error-feedback int8 compression of the cross-pod hop;
  * ``psum_tree_hierarchical`` — one of the three syncs over a tree;
  * the partitioned LM step's pieces: ``sum_over_axis`` / ``copy_to_axis``
    (tensor parallelism's all-reduce and its conjugate), ``psum`` (an
    all-reduce both ways: a statistic of a sharded dim used per shard),
    ``gather_from_axis`` (a sharded activation gathered into work every
    rank repeats whole; the backward keeps the rank's block), ``fsdp_gather`` /
    ``gather_tree_over_data`` (a weight's data-sharded dim gathered, its
    gradient reduce-scattered back), ``sum_over_data`` (a rank's loss
    addend summed over the data ranks, identity backward) and
    ``sum_tree_over_data`` (the gradients of data-replicated leaves summed
    in place);
  * serving's piece: ``merge_attention_partials`` (decode attention over a
    KV cache sharded over the sequence: each rank's softmax partials
    all-gathered and combined in rank order).

Every collective call records its kind, count and the bytes in and out of
this rank (:func:`collective_records`), which ``launch/hlo_stats.py:
collective_stats`` reads in the reference's dict shape. The collectives
use the list forms of ``torch.distributed`` (``all_gather``,
``reduce_scatter``), which gloo and NCCL both take.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.optim.optimizers import tree_map
from repro_torch.parallel.sharding import (data_dims, mesh_axes, model_size, shard_start,
                                           tree_map_specs)


# ---------------------------------------------------------------------------
# records of the collectives a rank ran (launch/hlo_stats.py reads them)
# ---------------------------------------------------------------------------

_RECORDS: Dict[str, Dict[str, int]] = defaultdict(
    lambda: {"count": 0, "bytes_in": 0, "bytes_out": 0})


def _record(kind: str, bytes_in: int, bytes_out: int) -> None:
    rec = _RECORDS[kind]
    rec["count"] += 1
    rec["bytes_in"] += int(bytes_in)
    rec["bytes_out"] += int(bytes_out)


def collective_records() -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes_in", "bytes_out"}} since the last reset, the
    kinds named as the reference's HLO names them ("all-reduce",
    "all-gather", "reduce-scatter"), the bytes this rank's."""
    return {k: dict(v) for k, v in _RECORDS.items()}


def reset_collective_records() -> None:
    _RECORDS.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(axis)]


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced (sum or max) over the ranks of ``axis``."""
    import torch.distributed as dist

    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=_group(mesh, axis))
    _record("all-reduce", _nbytes(out), _nbytes(out))
    return out


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0, tiled: bool = True):
    """The ranks' ``t`` over ``axis`` in rank order: concatenated along
    ``dim`` (``tiled``), else stacked on a new leading dim."""
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_axis_size(mesh, axis))]
    dist.all_gather(parts, t, group=_group(mesh, axis))
    if not tiled:
        out = torch.stack(parts)
    else:  # one part is the whole: no second copy
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)
    _record("all-gather", _nbytes(t), _nbytes(out))
    return out


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t`` summed over the ranks of ``axis`` (``t``
    cut into equal blocks along ``dim``, block i to the rank of index i)."""
    import torch.distributed as dist

    n = _axis_size(mesh, axis)
    parts = [p.contiguous() for p in torch.chunk(t, n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=_group(mesh, axis))
    _record("reduce-scatter", _nbytes(t), _nbytes(out))
    return out


class _SumOverAxis(torch.autograd.Function):
    """Forward: the sum over the ranks of ``axis``; backward: the identity.
    Every rank of the axis goes on with the same (replicated) sum, so the
    gradient each rank receives is already the whole one for its own
    addend."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    """Forward: the identity on a tensor replicated over ``axis``;
    backward: the sum of the ranks' gradients (each rank used the copy in
    a product with its own shard)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _GatherFromAxis(torch.autograd.Function):
    """Forward: the ranks' blocks of ``axis`` concatenated along ``dim``;
    backward: this rank's block of the gradient. For a sharded activation
    gathered into work that every rank of the axis repeats whole, so that
    each rank's gradient of the gathered tensor is already the whole one."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return all_gather(t, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo = shard_start(ctx.mesh, ctx.n, ctx.axis)
        return g.narrow(ctx.dim, lo, ctx.n), None, None, None


def sum_over_axis(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _SumOverAxis.apply(t, mesh, axis)


def copy_to_axis(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    return _CopyToAxis.apply(t, mesh, axis)


def psum(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum over the ranks of ``axis``, its backward a sum over them too:
    for a statistic of a sharded dim (a sum of squares over a d_inner block)
    that each rank then uses on its own block, so that each rank's gradient
    of the sum is only its block's share. One all-reduce each way."""
    return copy_to_axis(sum_over_axis(t, mesh, axis), mesh, axis)


def gather_from_axis(t: torch.Tensor, mesh, axis: str = "model", dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``dim``, gathered over ``axis``; the
    backward keeps this rank's block (:class:`_GatherFromAxis`)."""
    return _GatherFromAxis.apply(t, mesh, axis, dim % t.dim())


def merge_attention_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, mesh,
                             axis: str = "model") -> torch.Tensor:
    """Attention over keys split between the ranks of ``axis``: each rank's
    fp32 softmax partials over its own keys — the row max ``m`` (...), the
    sum of exp(s - m) ``l`` (...) and the unnormalised output ``o`` (...,
    hd) — all-gathered in one call and combined in rank order (the max,
    then each rank's share rescaled by exp(m_r - max) and added, rank 0
    first), so every rank of the axis holds the same bits. Returns the
    normalised output (..., hd), fp32."""
    parts = all_gather(torch.cat([m[..., None], l[..., None], o], dim=-1), mesh, axis,
                       tiled=False)
    top = parts[0, ..., 0]
    for r in range(1, parts.shape[0]):
        top = torch.maximum(top, parts[r, ..., 0])
    den = torch.zeros_like(top)
    num = torch.zeros_like(o)
    for r in range(parts.shape[0]):
        w = torch.exp(parts[r, ..., 0] - top)
        den = den + parts[r, ..., 1] * w
        num = num + parts[r, ..., 2:] * w[..., None]
    return num / den[..., None]


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.mesh_dim_names if n in ("pod", "data"))


def data_size(mesh) -> int:
    """The number of data-parallel ranks: the product of "pod" and "data"."""
    out = 1
    for a in _dp_axes(mesh):
        out *= _axis_size(mesh, a)
    return out


def mean_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of the data ranks' ``t`` (sum over each data axis)."""
    for a in _dp_axes(mesh):
        t = all_reduce(t, mesh, a)
    return t / data_size(mesh)


def gather_over_data(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The data ranks' ``t`` concatenated along ``dim`` in rank order (a
    dim sharded over ("pod", "data") is pod major)."""
    for a in reversed(_dp_axes(mesh)):  # the minor axis first
        t = all_gather(t, mesh, a, dim=dim)
    return t


class _GatherOverAxis(torch.autograd.Function):
    """Forward: the ranks' blocks of ``axis`` concatenated along ``dim``;
    backward: the reduce-scatter, each rank's block of the gradients summed
    over the axis (FSDP: every data rank used the whole weight)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(t, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, dim=ctx.dim), None, None, None


def fsdp_gather(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The whole of a weight whose ``dim`` is sharded over the data axes
    (FSDP), gathered minor axis first so that the blocks come pod major;
    its gradient is reduce-scattered back, summed over the data ranks."""
    for a in reversed(_dp_axes(mesh)):
        t = _GatherOverAxis.apply(t, mesh, a, dim)
    return t


def gather_tree_over_data(tree, spec_tree, mesh):
    """``tree`` (this rank's shards under ``spec_tree``) with every dim that
    its spec shards over the data axes gathered (:func:`fsdp_gather`);
    leaves without one as they are."""
    ax = mesh_axes(mesh)

    def one(spec, t):
        for d in data_dims(spec, ax):
            t = fsdp_gather(t, mesh, d)
        return t

    return tree_map_specs(one, spec_tree, tree)


def sum_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the data ranks' ``t`` (:func:`sum_over_axis` over "pod"
    and "data"); the backward is the identity: each rank's gradient is that
    of its own addend."""
    for a in _dp_axes(mesh):
        t = sum_over_axis(t, mesh, a)
    return t


def sum_tree_over_data(grads, spec_leaves_, mesh) -> None:
    """In place: each gradient whose leaf is replicated over the data axes
    (its spec, in ``spec_leaves_``, names none of them) summed over the data
    ranks; a leaf sharded over them (FSDP) arrives summed already, by the
    reduce-scatter of :func:`fsdp_gather`. ``grads`` and ``spec_leaves_``
    are flat lists in the same order (``tree_leaves`` / ``spec_leaves``)."""
    import torch.distributed as dist

    ax = mesh_axes(mesh)
    for g, (_, spec) in zip(grads, spec_leaves_):
        if data_dims(spec, ax):
            continue
        for a in ax.data:
            dist.all_reduce(g, group=_group(mesh, a))
            _record("all-reduce", _nbytes(g), _nbytes(g))


# ---------------------------------------------------------------------------
# Vocab-sharded (row-partitioned) embedding lookup
# ---------------------------------------------------------------------------


def vocab_sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh) -> torch.Tensor:
    """table: this rank's (V / TP, D) row shard of a (V, D) table sharded
    over "model" (contiguous row blocks in rank order); ids (...) int: this
    rank's data shard of global row ids. Returns (..., D) embeddings,
    replicated over "model": the masked local take (rows outside the shard
    are zeros), summed over "model". Backward: the identity through the sum,
    then the masked local scatter-add into the shard — the paper's gradient
    "scatter" primitive, shard-local, not scaled by the TP width."""
    rows_local = table.shape[0]
    loc = ids.long() - shard_start(mesh, rows_local)
    ok = (loc >= 0) & (loc < rows_local)
    emb = table[torch.where(ok, loc, torch.zeros_like(loc))]
    emb = torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))
    return sum_over_axis(emb, mesh, "model")


def _mask_padding(logits: torch.Tensor, true_vocab: int) -> torch.Tensor:
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < true_vocab, logits,
                       torch.full((), -torch.inf, device=logits.device))


def sharded_logits(x: torch.Tensor, head_w: torch.Tensor, true_vocab: int,
                   mesh=None) -> torch.Tensor:
    """x (B, D) @ head_w (D, Vpad) -> (B, Vpad) fp32 logits (products and
    sums in fp32), the padding columns ``>= true_vocab`` set to -inf. With
    a mesh wider than 1 over "model", :func:`vocab_parallel_logits`."""
    if model_size(mesh) > 1:
        return vocab_parallel_logits(x, head_w, true_vocab, mesh)
    return _mask_padding(x.float() @ head_w.float(), true_vocab)


def _mask_padding_from(logits: torch.Tensor, true_vocab: int, lo: int) -> torch.Tensor:
    """``_mask_padding`` of a column shard whose first column is global
    column ``lo``."""
    cols = lo + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < true_vocab, logits,
                       torch.full((), -torch.inf, device=logits.device))


def vocab_parallel_logits(x: torch.Tensor, head_shard: torch.Tensor, true_vocab: int,
                          mesh) -> torch.Tensor:
    """Decode-time logits with the head a column shard over "model": this
    rank's (B, Vpad / TP) fp32 logits, all-gathered over "model" into the
    (B, Vpad) row every rank then holds."""
    lo = shard_start(mesh, head_shard.shape[1])
    local = _mask_padding_from(x.float() @ head_shard.float(), true_vocab, lo)
    return all_gather(local, mesh, "model", dim=-1)


def _vp_chunk_loss(xs, head32, ls, ms, true_vocab: int, lo: int, mesh) -> torch.Tensor:
    """:func:`_chunk_loss` with the head a column shard: the row max, the
    sum of exponentials and the label's logit reduced over "model"."""
    logits = _mask_padding_from(copy_to_axis(xs, mesh).float() @ head32, true_vocab, lo)
    m = all_reduce(torch.amax(logits, dim=-1).detach(), mesh, "model", op="max")
    s = sum_over_axis(torch.sum(torch.exp(logits - m[..., None]), dim=-1), mesh)
    lse = m + torch.log(s)
    cols = lo + torch.arange(logits.shape[-1], device=logits.device)
    label_logit = sum_over_axis(
        torch.sum(torch.where(cols == ls[..., None].long(), logits, 0.0), dim=-1), mesh)
    return torch.sum((lse - label_logit) * ms)


def vocab_parallel_xent_loss(x, head_shard, labels, mask=None, *, true_vocab: int, mesh,
                             seq_chunk: int = 512, denominator=None) -> torch.Tensor:
    """:func:`sharded_xent_loss` with ``head_shard`` this rank's (D, Vpad /
    TP) column block of the head over "model" (contiguous in rank order);
    x, labels and mask are this rank's data shard, replicated over "model".
    Per chunk: fp32 logits of the shard, the row max all-reduced (max) over
    "model", the sum of exp(logits - max) and the label's logit all-reduced
    (sum): lse = max + log(sum). The loss is replicated over "model"; the
    gradient of x is summed over "model" (each rank's product with its own
    shard). Chunks recompute in the backward, collectives included, in the
    same order on every rank. ``denominator`` as in :func:`sharded_xent_loss`."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float()
    head32 = head_shard.float()
    lo = shard_start(mesh, head_shard.shape[1])
    chunk = min(seq_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        total = total + checkpoint(_vp_chunk_loss, x[:, c0:c1], head32, labels[:, c0:c1],
                                   mask[:, c0:c1], true_vocab, lo, mesh, use_reentrant=False)
    return total / _denominator(mask, denominator)


def _denominator(mask: torch.Tensor, denominator) -> torch.Tensor:
    if denominator is None:
        return torch.clamp(torch.sum(mask), min=1.0)
    return denominator


def _chunk_loss(xs, head_w32, ls, ms, true_vocab: int) -> torch.Tensor:
    """sum over (B, c) of (logsumexp(logits) - logits[label]) * mask, the
    fp32 logits ``xs @ head_w`` of one sequence chunk (padding columns
    -inf)."""
    logits = _mask_padding(xs.float() @ head_w32, true_vocab)
    lse = torch.logsumexp(logits, dim=-1)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    # the label's logit as the reference takes it: a masked sum, whose
    # backward is elementwise (a gather's would scatter with atomics)
    label_logit = torch.sum(torch.where(cols == ls[..., None].long(), logits, 0.0), dim=-1)
    return torch.sum((lse - label_logit) * ms)


def sharded_xent_loss(
    x: torch.Tensor,
    head_w: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    true_vocab: int,
    seq_chunk: int = 512,
    mesh=None,
    denominator=None,
) -> torch.Tensor:
    """Mean token cross entropy without the (B, S, V) logits: x (B, S, D)
    activations, head_w (D, Vpad), labels (B, S) int, mask (B, S) {0, 1}
    (all ones when None) -> an fp32 scalar, the masked sum over chunks of
    ``min(seq_chunk, S)`` positions (the remainder chunk last) divided by
    ``max(sum(mask), 1)``. Each chunk's fp32 logits are recomputed in the
    backward (``torch.utils.checkpoint``), so at most one chunk's (B, c,
    Vpad) logits exist at a time. Columns ``>= true_vocab`` are padding,
    outside the softmax. The logits product is a plain ``torch.matmul`` in
    fp32 (bf16 operands' products are exact there), as the reference leaves
    its einsum to XLA. The reference's ``unroll`` (a ``lax.scan`` knob) has
    no counterpart: the chunks are a Python loop. With a mesh wider than 1
    over "model", :func:`vocab_parallel_xent_loss`. ``denominator`` (an fp32
    0-dim tensor) replaces ``max(sum(mask), 1)``: a data rank's share of a
    batch's mean divides by the mask count of the whole batch."""
    if model_size(mesh) > 1:
        return vocab_parallel_xent_loss(x, head_w, labels, mask, true_vocab=true_vocab,
                                        mesh=mesh, seq_chunk=seq_chunk,
                                        denominator=denominator)
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float()
    head_w32 = head_w.float()
    chunk = min(seq_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):  # n full chunks, then the remainder
        hi = min(lo + chunk, S)
        total = total + checkpoint(_chunk_loss, x[:, lo:hi], head_w32, labels[:, lo:hi],
                                   mask[:, lo:hi], true_vocab, use_reentrant=False)
    return total / _denominator(mask, denominator)


# ---------------------------------------------------------------------------
# Hierarchical / compressed gradient sync (explicit, for DP-only trees)
# ---------------------------------------------------------------------------


def _psum_dp(g: torch.Tensor, mesh, pod_axis: str, data_axis: str) -> torch.Tensor:
    return all_reduce(all_reduce(g, mesh, data_axis), mesh, pod_axis)


def hierarchical_psum(g: torch.Tensor, mesh, *, pod_axis: str = "pod",
                      data_axis: str = "data") -> torch.Tensor:
    """This rank's ``g`` summed over (pod, data) with the least cross-pod
    bytes: reduce-scatter over ``data_axis`` (dim 0), all-reduce over
    ``pod_axis`` on 1/N of the tensor, all-gather back over ``data_axis``.
    A tensor whose leading dim does not divide over ``data_axis`` (or a
    scalar) takes the plain sum, over ``data_axis`` then ``pod_axis``."""
    n = _axis_size(mesh, data_axis)
    if g.dim() == 0 or g.shape[0] % n != 0:
        return _psum_dp(g, mesh, pod_axis, data_axis)
    shard = reduce_scatter(g, mesh, data_axis)
    shard = all_reduce(shard, mesh, pod_axis)
    return all_gather(shard, mesh, data_axis)


def ef_int8_quantize(compensated: torch.Tensor):
    """The reference's per-tensor int8 code of the cross-pod hop: scale =
    max(max |c|, 1e-8) / 127, q = clip(round(c / scale), -127, 127) (round
    half to even), the residual c - q * scale. -> (q int8, scale 0-dim,
    residual)."""
    scale = torch.clamp(torch.max(torch.abs(compensated)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(compensated / scale), -127, 127).to(torch.int8)
    return q, scale, compensated - q.to(compensated.dtype) * scale


def ef_int8_psum(g: torch.Tensor, err=None, mesh=None, *, pod_axis: str = "pod",
                 data_axis: str = "data", codes: Optional[list] = None):
    """Error-feedback int8 compression on the cross-pod hop. In-pod: an
    exact reduce-scatter over ``data_axis``. Cross-pod: this rank's shard
    plus the carried residual ``err`` quantized to int8 with one scale
    (:func:`ef_int8_quantize`), the codes and scales all-gathered over
    ``pod_axis`` (int8 on the wire), their dequantized sum (pod order),
    all-gathered back over ``data_axis``. Returns (synced g, the new
    residual, shaped as the in-pod shard); ``err`` None on the first step.
    A tensor whose leading dim does not divide takes the plain sum and
    returns ``err`` unchanged. ``codes``, a list, receives this rank's int8
    codes."""
    n = _axis_size(mesh, data_axis)
    if g.dim() == 0 or g.shape[0] % n != 0:
        return _psum_dp(g, mesh, pod_axis, data_axis), err
    shard = reduce_scatter(g, mesh, data_axis)
    compensated = shard if err is None else shard + err
    q, scale, new_err = ef_int8_quantize(compensated)
    if codes is not None:
        codes.append(q)
    q_all = all_gather(q, mesh, pod_axis, tiled=False)  # (npod, ...)
    s_all = all_gather(scale.reshape(1), mesh, pod_axis)  # (npod,)
    deq = s_all[0] * q_all[0].to(compensated.dtype)
    for p in range(1, q_all.shape[0]):
        deq = deq + s_all[p] * q_all[p].to(compensated.dtype)
    return all_gather(deq, mesh, data_axis), new_err


def psum_tree_hierarchical(grads, errs=None, *, mesh, mode: str = "hierarchical"):
    """The chosen sync on every leaf of ``grads`` over (pod, data):
    ``plain`` (all-reduce), ``hierarchical`` (:func:`hierarchical_psum`) or
    ``ef_int8`` (:func:`ef_int8_psum`, ``errs`` a tree of residuals shaped
    as ``grads``, None leaves on the first step). -> (grads, errs)."""
    if mode == "plain":
        return tree_map(lambda g: _psum_dp(g, mesh, "pod", "data"), grads), errs
    if mode == "hierarchical":
        return tree_map(lambda g: hierarchical_psum(g, mesh), grads), errs
    if mode == "ef_int8":
        if errs is None:
            errs = tree_map(lambda g: None, grads)
        pairs = tree_map(lambda g, e: ef_int8_psum(g, e, mesh), grads, errs)
        return _split(pairs, 0), _split(pairs, 1)
    raise ValueError(f"unknown grad sync mode {mode!r}")


def _split(pairs, i: int):
    """Element ``i`` of every (grad, err) pair leaf."""
    if isinstance(pairs, dict):
        return {k: _split(v, i) for k, v in pairs.items()}
    if isinstance(pairs, list):
        return [_split(v, i) for v in pairs]
    return pairs[i]
