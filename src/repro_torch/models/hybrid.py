"""Zamba2-style hybrid LM: groups of mamba2 layers interleaved with a SHARED
attention block (weights reused at every application, zamba-style concat of
the original embedding stream), plus a mamba tail. Serving and training.

Port of ``repro/models/hybrid.py``, its specs per layer
(:func:`param_specs`, :func:`cache_spec`). Serving and training also run
partitioned over a mesh (:func:`prefill`, :func:`decode_step` and
:func:`loss_fn` with ``mesh=``: the vocab-sharded embedding and head, the
mamba layers tensor-parallel over d_inner and the SSD heads, the shared
block's attention and SwiGLU tensor-parallel, each rank holding its share
of the decode cache). Structure
(cfg.hybrid_*): G groups x m mamba layers, each group followed by one
application of the shared block; then ``tail`` mamba layers. The reference
stacks the layers of a group on leading axes and scans them; the port keeps
a list of per-layer parameter dicts (``params["groups"][g][i]``,
``params["tail"][i]``) and loops. Prefill reaches the two kernels: one
``ssd_chunk_scan`` per mamba layer and one ``flash_attention`` per
shared-block application. Decode is plain torch against the caches, which it
updates in place: ``cache["k"]`` / ``cache["v"]`` (G, B, S, K, hd) stacked as
in the reference, and one state dict per mamba layer
(``cache["groups"][g][i]``, ``cache["tail"][i]``). Training
(:func:`loss_fn`, the reference's) runs the same layers with the grad on,
each mamba layer and each shared-block application under
``torch.utils.checkpoint`` (the reference checkpoints its group body and
its stack body): per step the SSD kernel runs twice a mamba layer and its
backward kernel once, the flash kernel twice an application and its
backward kernel once.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import MeshAxes, P, dp_axis, shard_dim


def _init_shared_block(gen: torch.Generator, cfg, device):
    dt = getattr(torch, cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    return {
        "concat_proj": normal((2 * D, D), 1.0 / math.sqrt(2 * D)),
        "attn_norm": torch.ones((D,), dtype=dt, device=device),
        "attn": L.init_attention(gen, cfg, device=device),
        "mlp_norm": torch.ones((D,), dtype=dt, device=device),
        "mlp": {
            "w_gate": normal((D, F), 1.0 / math.sqrt(D)),
            "w_up": normal((D, F), 1.0 / math.sqrt(D)),
            "w_down": normal((F, D), 1.0 / math.sqrt(F)),
        },
    }


def _shared_forward(cfg, sp, x, x0, positions, mesh=None):
    """One application of the shared attention block in training.
    concat([x, x0]) @ W is computed as x @ W_hi + x0 @ W_lo, as the
    reference does (the same math, without the (B, S, 2D) concat). With a
    ``mesh``, ``sp`` is this rank's shards under :func:`_shared_block_specs`:
    the attention and the SwiGLU run tensor-parallel as a transformer
    layer's (``layers.attention_forward``, ``transformer.ffn``: the normed
    input copied over "model", the row-parallel outputs summed there); the
    concat projection, both norms and x0 are replicated."""
    D = cfg.d_model
    u = x @ sp["concat_proj"][:D] + x0 @ sp["concat_proj"][D:]
    h = L.rms_norm(u, sp["attn_norm"], cfg.norm_eps)
    x = x + L.attention_forward(sp["attn"], h, positions, cfg, mesh)[0]
    h = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + T.ffn(cfg, sp["mlp"], h, mesh)[0]


def _shared_prefill(cfg, sp, x, x0, positions, mesh=None):
    """One application of the shared block in serving's prefill: (x, the
    k and v its KV cache keeps, ``layers.attention_prefill``'s), the
    concat as the reference's prefill computes it (``concat([x, x0]) @
    W``). With a ``mesh``, the attention and the SwiGLU run tensor-parallel
    as in training (:func:`_shared_forward`)."""
    u = torch.cat([x, x0], dim=-1) @ sp["concat_proj"]
    h = L.rms_norm(u, sp["attn_norm"], cfg.norm_eps)
    a, k, v = L.attention_prefill(sp["attn"], h, positions, cfg, mesh)
    x = x + a
    h = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + T.ffn(cfg, sp["mlp"], h, mesh)[0], k, v


def _shared_decode(cfg, sp, x, x0, pos, kc, vc, mesh=None, kv_slots=None):
    """One application of the shared block for one token; ``kc`` / ``vc``
    written in place. With a ``mesh``: this rank's shards, its share of a
    KV cache of ``kv_slots`` slots (``layers.attention_decode``), the
    SwiGLU tensor-parallel."""
    u = torch.cat([x, x0], dim=-1) @ sp["concat_proj"]
    h = L.rms_norm(u, sp["attn_norm"], cfg.norm_eps)
    a, kc, vc = L.attention_decode(sp["attn"], h, pos, kc, vc, cfg, mesh, kv_slots)
    x = x + a
    h = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + T.ffn(cfg, sp["mlp"], h, mesh)[0], kc, vc


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _shared_block_specs(cfg, ax: MeshAxes):
    m = ax.model
    H, K, hd, F = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    h_ax = m if (H * hd) % ax.model_size == 0 and H % ax.model_size == 0 else None
    k_ax = m if K % ax.model_size == 0 else None
    f_ax = shard_dim(ax, F, m)
    return {
        "concat_proj": P(None, None),
        "attn_norm": P(None),
        "attn": {"wq": P(None, h_ax), "wk": P(None, k_ax), "wv": P(None, k_ax),
                 "wo": P(h_ax, None)},
        "mlp_norm": P(None),
        "mlp": {"w_gate": P(None, f_ax), "w_up": P(None, f_ax), "w_down": P(f_ax, None)},
    }


def init_params(cfg, gen: torch.Generator, vocab_pad: int, device=None):
    """Random params from ``gen`` (draws on ``device``, the generator's by
    default), scaled as in the reference."""
    device = device or gen.device
    dt = getattr(torch, cfg.param_dtype)
    G, m, tail = cfg.hybrid_groups, cfg.hybrid_layers_per_group, cfg.hybrid_tail_layers

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    params = {
        "embed": normal((vocab_pad, cfg.d_model), 0.02),
        "groups": [[M.init_mamba_layer(gen, cfg, device) for _ in range(m)]
                   for _ in range(G)],
        "shared": _init_shared_block(gen, cfg, device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "lm_head": normal((cfg.d_model, vocab_pad), 0.02),
    }
    if tail:
        params["tail"] = [M.init_mamba_layer(gen, cfg, device) for _ in range(tail)]
    return params


def param_specs(cfg, ax: MeshAxes, vocab_pad: int):
    v_ax = shard_dim(ax, vocab_pad, ax.model)
    G, m = cfg.hybrid_groups, cfg.hybrid_layers_per_group
    sp = {
        "embed": P(v_ax, None),
        "groups": [[M.mamba_layer_specs(cfg, ax) for _ in range(m)] for _ in range(G)],
        "shared": _shared_block_specs(cfg, ax),
        "final_norm": P(None),
        "lm_head": P(None, v_ax),
    }
    if cfg.hybrid_tail_layers:
        sp["tail"] = [M.mamba_layer_specs(cfg, ax) for _ in range(cfg.hybrid_tail_layers)]
    return sp


def forward_hidden(params, cfg, batch, mesh=None, specs=None):
    """The training forward: the final-normed hidden states (B, S, D). With
    a ``mesh``, ``params`` are this rank's shards under ``specs``: the
    lookup vocab-sharded, each mamba layer and each shared-block
    application partitioned (``mamba2.train_stack``, :func:`_shared_forward`);
    the one shared weight set's gradients add up over its G applications."""
    x0 = T.embed_tokens(params, cfg, batch["tokens"], mesh, specs)
    B, S, _ = x0.shape
    positions = torch.arange(S, dtype=torch.int32, device=x0.device)[None].expand(B, S)
    shared = params["shared"]
    x = x0
    for gp in params["groups"]:
        x = M.train_stack(cfg, gp, x, mesh)
        x = checkpoint(_shared_forward, cfg, shared, x, x0, positions, mesh,
                       use_reentrant=False)
    if cfg.hybrid_tail_layers:
        x = M.train_stack(cfg, params["tail"], x, mesh)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(params, cfg, batch, mesh=None, specs=None):
    """The training loss: the chunked cross entropy of the hidden states
    against ``batch["labels"]`` through ``lm_head`` (``loss_mask``
    optional); an fp32 scalar. With a ``mesh``, ``lm_head`` is this rank's
    vocab block and the loss the whole batch's, on every rank
    (``transformer.xent_loss``)."""
    x = forward_hidden(params, cfg, batch, mesh, specs)
    return T.xent_loss(cfg, x, T.head_weight(params, cfg, mesh, specs), batch, mesh)


# ---------------------------------------------------------------------------
# Decode: mamba states per layer + KV cache per shared-block application
# ---------------------------------------------------------------------------


def init_cache(cfg, batch_size: int, seq_len: int, device="cpu"):
    G, m, tail = cfg.hybrid_groups, cfg.hybrid_layers_per_group, cfg.hybrid_tail_layers
    dt = getattr(torch, cfg.compute_dtype)
    kv_shape = (G, batch_size, seq_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "groups": [[M.init_mamba_state(cfg, batch_size, device) for _ in range(m)]
                   for _ in range(G)],
        "k": torch.zeros(kv_shape, dtype=dt, device=device),
        "v": torch.zeros(kv_shape, dtype=dt, device=device),
        "x0": torch.zeros((batch_size, 1, cfg.d_model), dtype=dt, device=device),
    }
    if tail:
        cache["tail"] = [M.init_mamba_state(cfg, batch_size, device) for _ in range(tail)]
    return cache


def cache_spec(cfg, ax: MeshAxes, batch_size: int, seq_len: int):
    b_ax = dp_axis(ax) if batch_size % ax.data_size == 0 else None
    if cfg.num_kv_heads % ax.model_size == 0:
        kv = P(None, b_ax, None, ax.model, None)
    elif seq_len % ax.model_size == 0:
        kv = P(None, b_ax, ax.model, None, None)
    else:
        kv = P(None, b_ax, None, None, None)
    G, m = cfg.hybrid_groups, cfg.hybrid_layers_per_group
    state = M.mamba_state_specs(cfg, ax, batch_size)
    sp = {"groups": [[state for _ in range(m)] for _ in range(G)],
          "k": kv, "v": kv, "x0": P(b_ax, None, None)}
    if cfg.hybrid_tail_layers:
        sp["tail"] = [state for _ in range(cfg.hybrid_tail_layers)]
    return sp


def prefill(params, cfg, batch, mesh=None, specs=None):
    """Forward over the prompt collecting shared-block KV caches (per group
    application) and final mamba states. Returns (last-position logits
    (B, Vpad) fp32, cache). With a ``mesh``: ``params`` this rank's shards
    under ``specs``, ``batch`` its data shard; the lookup and the head
    vocab-parallel, the mamba layers over d_inner and the SSD heads
    (``mamba2.prefill_stack``), the shared block tensor-parallel
    (:func:`_shared_prefill`); the cache is this rank's share under
    :func:`cache_spec` at the prompt's length."""
    x0 = T.embed_tokens(params, cfg, batch["tokens"], mesh, specs)
    B, S, _ = x0.shape
    positions = torch.arange(S, dtype=torch.int32, device=x0.device)[None].expand(B, S)
    shared = params["shared"]
    h, gstates, ks, vs = x0, [], [], []
    for gp in params["groups"]:
        h, st = M.prefill_stack(cfg, h, gp, mesh)
        h, k, v = _shared_prefill(cfg, shared, h, x0, positions, mesh)
        gstates.append(st)
        ks.append(L.kv_share(k, mesh, cfg.num_kv_heads))
        vs.append(L.kv_share(v, mesh, cfg.num_kv_heads))
    cache = {"groups": gstates, "k": torch.stack(ks), "v": torch.stack(vs),
             "x0": x0[:, -1:]}
    if cfg.hybrid_tail_layers:
        h, cache["tail"] = M.prefill_stack(cfg, h, params["tail"], mesh)
    x = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, -1], T.head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    return logits, cache


def decode_step(params, cfg, cache, tokens, pos: int, mesh=None, specs=None, kv_slots=None):
    """tokens (B, 1) int32 at position ``pos`` -> (next tokens (B, 1) int32,
    cache). The cache is updated in place (and returned). With a ``mesh``:
    this rank's shards, data shard and cache share (a KV cache of
    ``kv_slots`` slots); the greedy pick over the logits gathered over
    "model"."""
    x0 = T.embed_tokens(params, cfg, tokens, mesh, specs)
    shared = params["shared"]
    h = x0
    for g, gp in enumerate(params["groups"]):
        h = M.decode_stack(cfg, h, gp, cache["groups"][g], mesh)
        h, _, _ = _shared_decode(cfg, shared, h, x0, pos, cache["k"][g], cache["v"][g], mesh,
                                 kv_slots)
    if cfg.hybrid_tail_layers:
        h = M.decode_stack(cfg, h, params["tail"], cache["tail"], mesh)
    cache["x0"] = x0
    x = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, 0], T.head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, cache
