"""The collectives of ``repro/parallel/collectives.py`` at one card (TP = 1).

  * ``sharded_logits`` — decode-time logits: the vocab is not sharded, so
    there is nothing to gather;
  * ``sharded_xent_loss`` — the chunked cross entropy of LM training: the
    vocab is not sharded either, so the reference's per-shard log-sum-exp
    is the whole row's.

The vocab-sharded lookup and the gradient syncs (``hierarchical_psum``,
``ef_int8_psum``) have no meaning on one card (ROADMAP.md Queue 1 item 19).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def _mask_padding(logits: torch.Tensor, true_vocab: int) -> torch.Tensor:
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(cols < true_vocab, logits,
                       torch.full((), -torch.inf, device=logits.device))


def sharded_logits(x: torch.Tensor, head_w: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """x (B, D) @ head_w (D, Vpad) -> (B, Vpad) fp32 logits (products and
    sums in fp32), the padding columns ``>= true_vocab`` set to -inf."""
    return _mask_padding(x.float() @ head_w.float(), true_vocab)


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
    no counterpart: the chunks are a Python loop."""
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
    return total / torch.clamp(torch.sum(mask), min=1.0)
