"""Mamba2 LM (attention-free, mamba2-2.7b), serving half: embedding +
mamba2 blocks + tied head.

Port of ``init_params``, ``init_cache``, ``prefill`` and ``decode_step`` of
``repro/models/ssm_lm.py`` (one card: no mesh). The reference stacks the
layers on a leading [L] axis and scans them; the port keeps a list of
per-layer parameter dicts (``params["layers"][i]``) and a list of per-layer
decode states (``cache["layers"][i]``, each ``{"conv_x", "conv_B",
"conv_C", "ssm"}``) and loops. Prefill reaches the SSD kernel once per
layer (``mamba2.prefill_stack``, which the hybrid family shares); decode is
plain torch against the states, which it updates in place. The SSM state
is O(1) in the sequence length, so the cache never grows. ``forward_hidden``
and ``loss_fn`` belong to the ssm family's training, which needs a backward
of the SSD kernel (ROADMAP.md Queue 1 item 20).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C


def init_params(cfg, gen: torch.Generator, vocab_pad: int, device=None):
    """Random params from ``gen`` (draws on ``device``, the generator's by
    default), scaled as in the reference."""
    device = device or gen.device
    dt = getattr(torch, cfg.param_dtype)
    params = {
        "embed": L.normal(gen, (vocab_pad, cfg.d_model), 0.02, dt, device),
        "layers": [M.init_mamba_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (cfg.d_model, vocab_pad), 0.02, dt, device)
    return params


def init_cache(cfg, batch_size: int, seq_len: int = 0, device="cpu"):
    """Zero decode states, one per layer (``seq_len`` is not used: the SSM
    state is O(1) in the sequence length)."""
    return {"layers": [M.init_mamba_state(cfg, batch_size, device)
                       for _ in range(cfg.num_layers)]}


def prefill(params, cfg, batch):
    """Run the prompt through the layers (one SSD scan each). Returns (last-
    position logits (B, Vpad) fp32, the cache of each layer's conv tails
    and final SSM state)."""
    x = T.embed_tokens(params, cfg, batch["tokens"])
    x, states = M.prefill_stack(cfg, x, params["layers"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, -1], T.head_weight(params, cfg).to(x.dtype),
                              cfg.vocab_size)
    return logits, {"layers": states}


def decode_step(params, cfg, cache, tokens, pos: int):
    """One greedy step: tokens (B, 1) int32 (``pos`` is not used: the
    recurrence carries the position) -> (next tokens (B, 1) int32, cache).
    The cache is updated in place (and returned)."""
    x = T.embed_tokens(params, cfg, tokens)
    x = M.decode_stack(cfg, x, params["layers"], cache["layers"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, 0], T.head_weight(params, cfg).to(x.dtype),
                              cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache
