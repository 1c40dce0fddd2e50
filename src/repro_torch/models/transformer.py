"""Token embedding of the LM families.

Port of ``embed_tokens`` of ``repro/models/transformer.py``, all that
``models/hybrid.py`` uses (one card: no vocab-sharded lookup). The dense,
encoder, vlm and MoE transformer families come later (ROADMAP.md Queue 1
items 15 and 17).
"""
from __future__ import annotations

import torch


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D) rows of ``params["embed"]`` in the
    compute dtype."""
    return params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))
