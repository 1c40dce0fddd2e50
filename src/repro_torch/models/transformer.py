"""Dense transformer LM, MoE transformer (mixtral, llama4-scout; through
``models/moe.py``), encoder-only (hubert) and VLM backbone (phi-3-vision):
serving and training; and the token embedding the hybrid and ssm families
share.

Port of ``repro/models/transformer.py`` at one card: no mesh, so no
vocab-sharded lookup, no sequence-parallel constraints and no specs. The
reference stacks the layers on a leading [L] axis and scans them; the port
keeps a list of per-layer parameter dicts (``params["layers"][i]``) and
loops. Prefill reaches the flash kernel once per layer
(``layers.chunked_attention``); decode is plain torch against the KV cache
``{"k", "v"}`` of shape (L, B, S, K, hd), stacked as in the reference and
written in place (a ring of slots ``pos % S`` under ``cfg.sliding_window``:
``layers.ring_kv`` lays a prefill's keys out for it). Training
(:func:`loss_fn`, the reference's) runs the same layers with the grad on,
each under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
at its default ``remat``), so the flash kernel runs forward, again in the
recompute, and its backward kernel once per layer per step.

Families: ``dense`` (RMSNorm, SwiGLU), ``moe`` (RMSNorm, the routed SwiGLU
experts of ``models/moe.py``; its aux loss is returned by ``_ffn``,
summed over the layers by training and dropped by serving, as the
reference's prefill drops it), ``encoder``
(LayerNorm with bias, the tanh GELU MLP with biases; non-causal), ``vlm``
(a dense backbone whose ``patches`` frontend is prepended to the token
embeddings). The frontends are stubs in the reference too: precomputed
frame (``FRAME_DIM``) or patch (``PATCH_DIM``) embeddings, projected by
``frontend_proj``. The fused gate/up and offloaded-embedding knobs (no
config of the port sets them) and the reference's ``scan_layers`` (a
``lax.scan`` over stacked layers; the port loops over a list) are not
carried over.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.parallel import collectives as C

FRAME_DIM = 512  # audio frontend stub: precomputed frame-embedding width
PATCH_DIM = 1024  # vision frontend stub: precomputed patch-embedding width


# ---------------------------------------------------------------------------
# Layer init / forward / decode
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg, device):
    """One layer's params in ``cfg.param_dtype``, scaled as in the
    reference (draws from ``gen``)."""
    dt = getattr(torch, cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    p = {"attn": L.init_attention(gen, cfg, device=device)}
    if cfg.family == "encoder":  # LN + gelu MLP (hubert-style)
        p["attn_norm"] = {"w": ones(D), "b": zeros(D)}
        p["mlp_norm"] = {"w": ones(D), "b": zeros(D)}
        p["mlp"] = {"w1": normal((D, F), 1.0 / math.sqrt(D)), "b1": zeros(F),
                    "w2": normal((F, D), 1.0 / math.sqrt(F)), "b2": zeros(D)}
    elif cfg.family == "moe":
        p["attn_norm"] = ones(D)
        p["mlp_norm"] = ones(D)
        p["mlp"] = moe.init_moe_mlp(gen, cfg, device)
    else:
        p["attn_norm"] = ones(D)
        p["mlp_norm"] = ones(D)
        p["mlp"] = {"w_gate": normal((D, F), 1.0 / math.sqrt(D)),
                    "w_up": normal((D, F), 1.0 / math.sqrt(D)),
                    "w_down": normal((F, D), 1.0 / math.sqrt(F))}
    return p


def _norm(cfg, x, n):
    if cfg.family == "encoder":
        return L.layer_norm(x, n["w"], n["b"], cfg.norm_eps)
    return L.rms_norm(x, n, cfg.norm_eps)


def _ffn(cfg, m, h):
    """Returns (delta, aux loss): the MoE's fp32 scalar, 0.0 otherwise."""
    if cfg.family == "encoder":
        return L.gelu_mlp(h, m["w1"], m["b1"], m["w2"], m["b2"]), 0.0
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, m, h)
    return L.swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), 0.0


def _layer(cfg, p, x, positions):
    a, k, v = L.attention_forward(p["attn"], _norm(cfg, x, p["attn_norm"]), positions, cfg)
    x = x + a
    delta, aux = _ffn(cfg, p["mlp"], _norm(cfg, x, p["mlp_norm"]))
    return x + delta, k, v, aux


def layer_forward(cfg, p, x, positions):
    """One layer over x (B, S, D) at ``positions`` (B, S). Returns (x, the
    layer's post-RoPE k and v (B, S, K, hd)); the aux loss is dropped."""
    x, k, v, _ = _layer(cfg, p, x, positions)
    return x, k, v


def train_layer(cfg, p, x, positions):
    """One layer of the training forward: (x, its aux loss)."""
    x, _, _, aux = _layer(cfg, p, x, positions)
    return x, aux


def layer_decode(cfg, p, x, pos: int, kc, vc):
    """One token through one layer; ``kc``/``vc`` (B, S, K, hd) written in
    place at ``pos``."""
    a, kc, vc = L.attention_decode(p["attn"], _norm(cfg, x, p["attn_norm"]), pos, kc, vc, cfg)
    x = x + a
    delta, _ = _ffn(cfg, p["mlp"], _norm(cfg, x, p["mlp_norm"]))
    return x + delta, kc, vc


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_params(cfg, gen: torch.Generator, vocab_pad: int, device=None):
    """Random params from ``gen`` (draws on ``device``, the generator's by
    default), scaled as in the reference."""
    device = device or gen.device
    dt = getattr(torch, cfg.param_dtype)
    D = cfg.d_model

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    params = {
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": (
            {"w": torch.ones((D,), dtype=dt, device=device),
             "b": torch.zeros((D,), dtype=dt, device=device)}
            if cfg.family == "encoder" else torch.ones((D,), dtype=dt, device=device)),
        "embed": normal((vocab_pad, D), 0.02),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, vocab_pad), 0.02)
    if cfg.frontend == "frames":
        params["frontend_proj"] = normal((FRAME_DIM, D), 0.02)
    elif cfg.frontend == "patches":
        params["frontend_proj"] = normal((PATCH_DIM, D), 0.02)
    return params


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D) rows of ``params["embed"]`` in the
    compute dtype."""
    return params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))


def build_inputs(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, D), positions (B, S) int32). ``inputs_embeds``
    bypasses the embedding lookup; the ``frames`` frontend projects
    precomputed frames, the ``patches`` frontend prepends projected patches
    to the token embeddings."""
    dt = getattr(torch, cfg.compute_dtype)
    if "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(dt)
    elif cfg.frontend == "frames":
        x = batch["frames"].to(dt) @ params["frontend_proj"].to(dt)
    elif cfg.frontend == "patches":
        patches = batch["patches"].to(dt) @ params["frontend_proj"].to(dt)
        x = torch.cat([patches, embed_tokens(params, cfg, batch["tokens"])], dim=1)
    else:
        x = embed_tokens(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def head_weight(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def run_layers(cfg, layer_params, x, positions):
    """The layers in order -> (x, the aux losses summed over the layers, an
    fp32 scalar). Each layer is recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``: only its input is kept), as the reference's
    ``jax.checkpoint`` of its scan body."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params:
        x, a = checkpoint(train_layer, cfg, lp, x, positions, use_reentrant=False)
        aux = aux + a
    return x, aux


def forward_hidden(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the final-normed hidden states (B, S, D), the summed aux loss)."""
    x, positions = build_inputs(params, cfg, batch)
    x, aux = run_layers(cfg, params["layers"], x, positions)
    return _norm(cfg, x, params["final_norm"]), aux


def loss_fn(params, cfg, batch) -> torch.Tensor:
    """The training loss: the chunked cross entropy of the hidden states
    against ``batch["labels"]`` (``loss_mask`` optional; a vlm's image
    positions carry no loss) plus the aux loss; an fp32 scalar."""
    x, aux = forward_hidden(params, cfg, batch)
    if cfg.frontend == "patches":  # image positions carry no LM loss
        x = x[:, batch["patches"].shape[1]:]
    xent = C.sharded_xent_loss(
        x, head_weight(params, cfg).to(x.dtype), batch["labels"], batch.get("loss_mask"),
        true_vocab=cfg.vocab_size)
    return xent + aux


def init_cache(cfg, batch_size: int, seq_len: int, device="cpu", dtype=None):
    """Zero KV caches (L, B, S, K, hd), S capped at ``cfg.sliding_window``."""
    dt = dtype or getattr(torch, cfg.compute_dtype)
    S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.num_layers, batch_size, S, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params, cfg, batch):
    """Forward over the whole prompt: (last-position logits (B, Vpad) fp32,
    the KV cache {"k", "v"} (L, B, S', K, hd) of the post-RoPE keys and
    values of positions S - S' .. S - 1, in order; S' = S, or at most
    ``cfg.sliding_window``). Decode takes it through ``layers.ring_kv``."""
    x, positions = build_inputs(params, cfg, batch)
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = layer_forward(cfg, lp, x, positions)
        if cfg.sliding_window:
            k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
        ks.append(k)
        vs.append(v)
    x = _norm(cfg, x, params["final_norm"])
    logits = C.sharded_logits(x[:, -1], head_weight(params, cfg).to(x.dtype), cfg.vocab_size)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg, cache, tokens, pos: int):
    """One greedy step: tokens (B, 1) int32 at position ``pos`` -> (next
    tokens (B, 1) int32, cache). The cache is updated in place (and
    returned)."""
    x = embed_tokens(params, cfg, tokens)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = layer_decode(cfg, lp, x, pos, cache["k"][i], cache["v"][i])
    x = _norm(cfg, x, params["final_norm"])
    logits = C.sharded_logits(x[:, 0], head_weight(params, cfg).to(x.dtype), cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache
