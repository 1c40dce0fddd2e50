"""Zamba2-style hybrid LM, serving half: groups of mamba2 layers interleaved
with a SHARED attention block (weights reused at every application,
zamba-style concat of the original embedding stream), plus a mamba tail.

Port of ``init_params``, ``init_cache``, ``prefill`` and ``decode_step`` of
``repro/models/hybrid.py`` (one card: no mesh). Structure (cfg.hybrid_*): G
groups x m mamba layers, each group followed by one application of the
shared block; then ``tail`` mamba layers. The reference stacks the layers
of a group on leading axes and scans them; the port keeps a list of
per-layer parameter dicts (``params["groups"][g][i]``, ``params["tail"][i]``)
and loops. Prefill reaches the two kernels: one ``ssd_chunk_scan`` per mamba
layer and one ``flash_attention`` per shared-block application. Decode is
plain torch against the caches, which it updates in place: ``cache["k"]`` /
``cache["v"]`` (G, B, S, K, hd) stacked as in the reference, and one state
dict per mamba layer (``cache["groups"][g][i]``, ``cache["tail"][i]``).
``forward_hidden``, ``_shared_forward`` and ``loss_fn`` belong to the hybrid
family's training, which needs a backward of the SSD kernel (ROADMAP.md
Queue 1 item 20).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.parallel import collectives as C


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


def _shared_decode(cfg, sp, x, x0, pos, kc, vc):
    u = torch.cat([x, x0], dim=-1) @ sp["concat_proj"]
    h = L.rms_norm(u, sp["attn_norm"], cfg.norm_eps)
    a, kc, vc = L.attention_decode(sp["attn"], h, pos, kc, vc, cfg)
    x = x + a
    h = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    m = sp["mlp"]
    return x + L.swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), kc, vc


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


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


def prefill(params, cfg, batch):
    """Forward over the prompt collecting shared-block KV caches (per group
    application) and final mamba states. Returns (last-position logits
    (B, Vpad) fp32, cache)."""
    x0 = T.embed_tokens(params, cfg, batch["tokens"])
    B, S, _ = x0.shape
    positions = torch.arange(S, dtype=torch.int32, device=x0.device)[None].expand(B, S)
    shared = params["shared"]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = shared["attn"]
    m = shared["mlp"]
    h, gstates, ks, vs = x0, [], [], []
    for gp in params["groups"]:
        h, st = M.prefill_stack(cfg, h, gp)
        u = torch.cat([h, x0], dim=-1) @ shared["concat_proj"]
        hn = L.rms_norm(u, shared["attn_norm"], cfg.norm_eps)
        q = (hn @ p["wq"]).reshape(B, S, H, hd)
        k = (hn @ p["wk"]).reshape(B, S, K, hd)
        v = (hn @ p["wv"]).reshape(B, S, K, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        o = L.chunked_attention(q, k, v, causal=cfg.causal)
        h = h + o.reshape(B, S, H * hd) @ p["wo"]
        hn = L.rms_norm(h, shared["mlp_norm"], cfg.norm_eps)
        h = h + L.swiglu(hn, m["w_gate"], m["w_up"], m["w_down"])
        gstates.append(st)
        ks.append(k)
        vs.append(v)
    cache = {"groups": gstates, "k": torch.stack(ks), "v": torch.stack(vs),
             "x0": x0[:, -1:]}
    if cfg.hybrid_tail_layers:
        h, cache["tail"] = M.prefill_stack(cfg, h, params["tail"])
    x = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, -1], params["lm_head"].to(x.dtype), cfg.vocab_size)
    return logits, cache


def decode_step(params, cfg, cache, tokens, pos: int):
    """tokens (B, 1) int32 at position ``pos`` -> (next tokens (B, 1) int32,
    cache). The cache is updated in place (and returned)."""
    x0 = T.embed_tokens(params, cfg, tokens)
    shared = params["shared"]
    h = x0
    for g, gp in enumerate(params["groups"]):
        h = M.decode_stack(cfg, h, gp, cache["groups"][g])
        h, _, _ = _shared_decode(cfg, shared, h, x0, pos, cache["k"][g], cache["v"][g])
    if cfg.hybrid_tail_layers:
        h = M.decode_stack(cfg, h, params["tail"], cache["tail"])
    cache["x0"] = x0
    x = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = C.sharded_logits(x[:, 0], params["lm_head"].to(x.dtype), cfg.vocab_size)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, cache
