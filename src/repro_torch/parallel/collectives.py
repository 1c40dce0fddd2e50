"""Decode-time logits at one card.

Port of ``sharded_logits`` of ``repro/parallel/collectives.py`` at TP = 1:
the vocab is not sharded, so there is nothing to gather. The rest of the
module (vocab-sharded lookup and loss, gradient sync) comes with LM
training (ROADMAP.md Queue 1 items 18-19).
"""
from __future__ import annotations

import torch


def sharded_logits(x: torch.Tensor, head_w: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """x (B, D) @ head_w (D, Vpad) -> (B, Vpad) fp32 logits (products and
    sums in fp32), the padding columns ``>= true_vocab`` set to -inf."""
    logits = x.float() @ head_w.float()
    cols = torch.arange(logits.shape[1], device=logits.device)
    return torch.where(cols < true_vocab, logits,
                       torch.full((), -torch.inf, device=logits.device))
