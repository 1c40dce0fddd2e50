"""Mamba2 LM (attention-free, mamba2-2.7b): embedding + mamba2 blocks + tied
head. Serving and training.

Port of ``repro/models/ssm_lm.py``, its specs per layer
(:func:`param_specs`, :func:`cache_spec`). Serving and training also run
partitioned over a mesh (:func:`prefill`, :func:`decode_step` and
:func:`loss_fn` with ``mesh=``: the vocab-sharded embedding and tied head,
each mamba layer tensor-parallel over d_inner and the SSD heads, each
rank holding its share of the decode states). The reference
stacks the layers on a leading [L] axis and scans them; the port keeps a
list of per-layer parameter dicts (``params["layers"][i]``) and a list of
per-layer decode states (``cache["layers"][i]``, each ``{"conv_x",
"conv_B", "conv_C", "ssm"}``) and loops. Prefill reaches the SSD kernel once
per layer (``mamba2.prefill_stack``, which the hybrid family shares); decode
is plain torch against the states, which it updates in place. The SSM state
is O(1) in the sequence length, so the cache never grows. Training
(:func:`loss_fn`, the reference's) runs the layers through
``mamba2.train_stack``: each under ``torch.utils.checkpoint``, the SSD
kernel twice a layer a step and its backward kernel once.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import MeshAxes, P, shard_dim


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


def param_specs(cfg, ax: MeshAxes, vocab_pad: int):
    v_ax = shard_dim(ax, vocab_pad, ax.model)
    sp = {"embed": P(v_ax, None),
          "layers": [M.mamba_layer_specs(cfg, ax) for _ in range(cfg.num_layers)],
          "final_norm": P(None)}
    if not cfg.tie_embeddings:
        sp["lm_head"] = P(None, v_ax)
    return sp


def forward_hidden(params, cfg, batch, mesh=None, specs=None):
    """The training forward: the final-normed hidden states (B, S, D). With
    a ``mesh``, ``params`` are this rank's shards under ``specs`` and the
    lookup and the layers run partitioned (``transformer.embed_tokens``,
    ``mamba2.train_stack``)."""
    x = T.embed_tokens(params, cfg, batch["tokens"], mesh, specs)
    x = M.train_stack(cfg, params["layers"], x, mesh)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(params, cfg, batch, mesh=None, specs=None):
    """The training loss: the chunked cross entropy of the hidden states
    against ``batch["labels"]`` through the head (``embed.T`` when tied, as
    mamba2-2.7b is; ``loss_mask`` optional); an fp32 scalar. With a
    ``mesh``, the head is this rank's vocab block and the loss the whole
    batch's, on every rank (``transformer.xent_loss``)."""
    x = forward_hidden(params, cfg, batch, mesh, specs)
    return T.xent_loss(cfg, x, T.head_weight(params, cfg, mesh, specs), batch, mesh)


def init_cache(cfg, batch_size: int, seq_len: int = 0, device="cpu"):
    """Zero decode states, one per layer (``seq_len`` is not used: the SSM
    state is O(1) in the sequence length)."""
    return {"layers": [M.init_mamba_state(cfg, batch_size, device)
                       for _ in range(cfg.num_layers)]}


def cache_spec(cfg, ax: MeshAxes, batch_size: int, seq_len: int = 0):
    state = M.mamba_state_specs(cfg, ax, batch_size)
    return {"layers": [state for _ in range(cfg.num_layers)]}


def prefill(params, cfg, batch, mesh=None, specs=None):
    """Run the prompt through the layers (one SSD scan each). Returns (last-
    position logits (B, Vpad) fp32, the cache of each layer's conv tails
    and final SSM state). With a ``mesh``: ``params`` this rank's shards
    under ``specs``, ``batch`` its data shard, each layer tensor-parallel
    (``mamba2.prefill_stack``), the states this rank's shares, the tied
    head vocab-parallel."""
    x = T.embed_tokens(params, cfg, batch["tokens"], mesh, specs)
    x, states = M.prefill_stack(cfg, x, params["layers"], mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, -1], T.head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    return logits, {"layers": states}


def decode_step(params, cfg, cache, tokens, pos: int, mesh=None, specs=None, kv_slots=None):
    """One greedy step: tokens (B, 1) int32 (``pos`` is not used: the
    recurrence carries the position; nor is ``kv_slots``: there is no KV
    cache) -> (next tokens (B, 1) int32, cache). The cache is updated in
    place (and returned). With a ``mesh``: this rank's shards, data shard
    and states; the greedy pick over the logits gathered over "model"."""
    x = T.embed_tokens(params, cfg, tokens, mesh, specs)
    x = M.decode_stack(cfg, x, params["layers"], cache["layers"], mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, 0], T.head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache
