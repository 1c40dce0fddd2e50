"""Shared building blocks of the LM path: norms, RoPE, attention for prefill
(the hand-written flash kernel) and decode (against a KV cache), SwiGLU.

Port of the part of ``repro/models/layers.py`` that the hybrid serving path
runs. The reference calls its Pallas kernels "drop-in replacements on TPU"
of this pure-JAX code; in the port :func:`chunked_attention` IS the kernel
call (``kernels/ops.py: flash_attention``: the CUDA kernel for a CUDA
tensor, the plain version for a CPU one). Parameters are plain dicts of
tensors in the reference's layouts (``x @ w`` with ``w`` (in, out)).

Dtype policy, as in the reference: params in ``cfg.param_dtype``,
activations in ``cfg.compute_dtype``, softmax/norm statistics and the
attention products in fp32, RoPE in fp32. ``cache_write`` writes in place
(the reference returns a new array).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """Standard normal draws from ``gen`` in ``dtype`` on ``device``, times
    ``std`` (the reference's ``jax.random.normal(k, shape, dt) * std``)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 statistics, then ``.to(x.dtype)``, then the multiply by ``w``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half convention; ``fraction`` < 1 rotates a dim prefix only)
# ---------------------------------------------------------------------------


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0
) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotation in fp32."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    ang = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Prefill attention — the flash kernel
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 ->
    (B, Sq, H, hd) in q's dtype, through ``ops.flash_attention``. The
    kernel walks the keys in blocks of its own: the reference's
    ``block_kv`` has no counterpart. ``q_offset`` must be 0: no caller on
    the ported path passes another (a chunked prefill is ROADMAP Queue 1
    item 15)."""
    if q_offset != 0:
        raise NotImplementedError(
            f"q_offset={q_offset}: only 0 is ported (ROADMAP.md Queue 1 item 15)"
        )
    return ops.flash_attention(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Decode attention (one query token vs a cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, K, hd); pos = index of the token
    *just written*. RoPE is applied before caching. (The reference's
    sliding-window ring buffer comes with the dense family, ROADMAP.md
    Queue 1 item 15.)"""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qg.float(), k_cache.float()) * scale
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """In place: write one token (B, 1, K, hd) into (B, S, K, hd) at ``pos``.
    A slot past the end is clamped to the last, as
    ``lax.dynamic_update_slice`` clamps. Returns ``cache``."""
    S = cache.shape[1]
    slot = min(max(pos, 0), S - 1)
    cache[:, slot] = new[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


# ---------------------------------------------------------------------------
# Attention block parameters and decode
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, device=None):
    """Params for one attention block in ``cfg.param_dtype``, normal draws
    from ``gen`` (on ``device``) scaled as in the reference. The heads are
    ``cfg``'s (TP = 1: nothing padded; no qkv bias, which only the dense
    family has)."""
    D = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    device = device or gen.device
    std = 1.0 / math.sqrt(D)
    return {
        "wq": normal(gen, (D, H * hd), std, dt, device),
        "wk": normal(gen, (D, K * hd), std, dt, device),
        "wv": normal(gen, (D, K * hd), std, dt, device),
        "wo": normal(gen, (H * hd, cfg.d_model), 1.0 / math.sqrt(H * hd), dt, device),
    }


def attention_decode(
    p, x: torch.Tensor, pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S, K, hd), written in
    place at ``pos``. Returns (out, k_cache, v_cache)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    q = q.reshape(B, 1, H, hd)
    k = k.reshape(B, 1, K, hd)
    v = v.reshape(B, 1, K, hd)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, posb, cfg.rope_theta, cfg.rope_fraction)
    k_cache = cache_write(k_cache, k, pos)
    v_cache = cache_write(v_cache, v, pos)
    out = decode_attention(q, k_cache, v_cache, pos)
    out = out.reshape(B, 1, H * hd) @ p["wo"]
    return out, k_cache, v_cache
