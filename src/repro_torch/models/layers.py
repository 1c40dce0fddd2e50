"""Shared building blocks of the LM paths: norms, RoPE, attention for
prefill (the hand-written flash kernel) and decode (against a KV cache,
a ring under a sliding window, laid out by ``ring_kv``), SwiGLU and GELU
MLPs.

Port of ``repro/models/layers.py`` (the serving half: the reference's
``x_kv`` cross-attention argument has no caller and is not carried over).
The reference calls its Pallas kernels "drop-in replacements on TPU"
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
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import head_shard

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


def sharded_rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, n: int,
                     mesh) -> torch.Tensor:
    """:func:`rms_norm` over a last dim of ``n`` sharded over "model": x and
    w are this rank's block. The sum of squares of the block goes through
    ``collectives.psum`` (its gradient, each block's share, sums over the
    ranks too) and is divided by ``n``: the mean over the whole dim."""
    xf = x.float()
    var = C.psum((xf * xf).sum(dim=-1, keepdim=True), mesh) / n
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 mean and variance, then ``.to(x.dtype)``, then ``* w + b``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


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
    # a fill on the device, not a copy of a host scalar (a host sync)
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exponent)
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
    (B, Sq, H, hd) in q's dtype, through ``ops.flash_attention``. Query row
    i sits at position ``q_offset`` + i (a query chunk after a prefix of
    keys). The kernel walks the keys in blocks of its own: the reference's
    ``block_kv`` has no counterpart."""
    return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


# ---------------------------------------------------------------------------
# Decode attention (one query token vs a cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    *,
    rolling: bool = False,
) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, K, hd); pos = index of the token
    *just written*. RoPE is applied before caching. ``rolling``: the cache
    is a sliding-window ring buffer of size S (every slot valid once pos
    reaches S - 1)."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qg.float(), k_cache.float()) * scale
    n_valid = min(pos + 1, S) if rolling else pos + 1
    valid = torch.arange(S, device=q.device) < n_valid
    s = torch.where(valid[None, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int, *,
                rolling: bool = False) -> torch.Tensor:
    """In place: write one token (B, 1, K, hd) into (B, S, K, hd) at ``pos``
    (ring slot ``pos % S`` when ``rolling``). A slot past the end is clamped
    to the last, as ``lax.dynamic_update_slice`` clamps. Returns ``cache``."""
    S = cache.shape[1]
    slot = pos % S if rolling else min(max(pos, 0), S - 1)
    cache[:, slot] = new[:, 0].to(cache.dtype)
    return cache


def ring_kv(kv: torch.Tensor, prompt_len: int, size: int) -> torch.Tensor:
    """A prefill's stacked KV cache (L, B, n, K, hd), holding positions
    ``prompt_len - n`` .. ``prompt_len - 1`` in order -> (L, B, ``size``, K,
    hd) with each position p it keeps at slot ``p % size`` (the last
    ``min(n, size)`` positions; the other slots zero). With ``size`` >=
    ``prompt_len`` this is a growth by ``size - prompt_len`` zero slots; as
    a ring of ``size`` = the window it is the layout ``cache_write`` and
    ``decode_attention`` assume (the reference keeps the window's keys at
    slots 0 .. n - 1 instead, so its decode overwrites a position still in
    the window unless ``prompt_len % size == 0``)."""
    n = min(kv.shape[2], size)
    out = kv.new_zeros(kv.shape[:2] + (size,) + kv.shape[3:])
    slots = torch.arange(prompt_len - n, prompt_len, device=kv.device) % size
    out[:, :, slots] = kv[:, :, kv.shape[2] - n:]
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def gelu_mlp(x, w1, b1, w2, b2):
    """The reference's ``jax.nn.gelu`` is the tanh approximation."""
    return F.gelu(x @ w1 + b1, approximate="tanh") @ w2 + b2


# ---------------------------------------------------------------------------
# Attention block parameters and decode
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, device=None):
    """Params for one attention block in ``cfg.param_dtype``, normal draws
    from ``gen`` (on ``device``) scaled as in the reference, zero qkv biases
    under ``cfg.qkv_bias``. The heads are ``cfg``'s (TP = 1: nothing
    padded)."""
    D = cfg.d_model
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.param_dtype)
    device = device or gen.device
    std = 1.0 / math.sqrt(D)
    p = {
        "wq": normal(gen, (D, H * hd), std, dt, device),
        "wk": normal(gen, (D, K * hd), std, dt, device),
        "wv": normal(gen, (D, K * hd), std, dt, device),
        "wo": normal(gen, (H * hd, cfg.d_model), 1.0 / math.sqrt(H * hd), dt, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def qkv_proj(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, hd), k and v (B, S, K, hd), biased under
    ``cfg.qkv_bias``, before RoPE."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def _kv_proj(w, b, x, heads, hd: int, mesh):
    """One of k / v over this rank's kv heads (``heads.kv``): a sharded
    weight is the rank's own; a replicated one is copied over "model" (its
    gradient, partial on each rank, sums there) and cut to the heads read."""
    B, S, _ = x.shape
    if not heads.kv_sharded:
        w = C.copy_to_axis(w, mesh)
        b = None if b is None else C.copy_to_axis(b, mesh)
        if heads.kv_contiguous:
            lo, n = heads.kv[0] * hd, len(heads.kv) * hd
            w = w.narrow(1, lo, n)
            b = None if b is None else b.narrow(0, lo, n)
    y = x @ w
    if b is not None:
        y = y + b
    y = y.reshape(B, S, -1, hd)
    if not heads.kv_sharded and not heads.kv_contiguous:  # one kv head per q head
        y = y.index_select(2, torch.tensor(heads.kv, device=y.device))
    return y


def qkv_proj_sharded(p, x: torch.Tensor, cfg, mesh, heads):
    """:func:`qkv_proj` on one model rank: x (B, S, D), replicated over
    "model" -> q (B, S, H_loc, hd) of the rank's q heads, k and v (B, S,
    K_loc, hd) of the kv heads they read (``heads``, a
    ``sharding.HeadShard``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias else (None, None)
    return (q.reshape(B, S, heads.q[1] - heads.q[0], hd),
            _kv_proj(p["wk"], bk, x, heads, hd, mesh), _kv_proj(p["wv"], bv, x, heads, hd, mesh))


def attention_forward(
    p, x: torch.Tensor, positions: torch.Tensor, cfg, mesh=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill attention: x (B, S, D), positions (B, S) -> (out (B, S, D),
    the post-RoPE k and v (B, S, K, hd) for the KV cache), the core through
    the flash kernel (causal or not, windowed under ``cfg.sliding_window``).
    With a ``mesh`` (a ``DeviceMesh`` with a "model" axis) ``p`` holds this
    rank's shards: x, replicated over "model", goes in through
    ``copy_to_axis`` (its gradient sums over the ranks' heads), the flash
    call runs at the rank's heads (``sharding.head_shard``), and ``wo`` is
    row-parallel: its partial product is summed over "model"; k and v are
    the rank's kv heads."""
    B, S, _ = x.shape
    if mesh is None:
        q, k, v = qkv_proj(p, x, cfg)
    else:
        heads = head_shard(mesh, cfg.num_heads, cfg.num_kv_heads)
        q, k, v = qkv_proj_sharded(p, C.copy_to_axis(x, mesh), cfg, mesh, heads)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    out = chunked_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    out = out.reshape(B, S, q.shape[2] * cfg.head_dim) @ p["wo"]
    if mesh is not None:
        out = C.sum_over_axis(out, mesh)
    return out, k, v


def attention_decode(
    p, x: torch.Tensor, pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S, K, hd), written in
    place at ``pos`` (ring slot ``pos % S`` under ``cfg.sliding_window``).
    Returns (out, k_cache, v_cache)."""
    B = x.shape[0]
    rolling = cfg.sliding_window is not None
    q, k, v = qkv_proj(p, x, cfg)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, posb, cfg.rope_theta, cfg.rope_fraction)
    k_cache = cache_write(k_cache, k, pos, rolling=rolling)
    v_cache = cache_write(v_cache, v, pos, rolling=rolling)
    out = decode_attention(q, k_cache, v_cache, pos, rolling=rolling)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return out, k_cache, v_cache
