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

Over a mesh, :func:`attention_forward` runs a rank's heads in training;
serving's :func:`attention_prefill` and :func:`attention_decode` keep the
rank's share of the KV cache, laid out by :func:`kv_layout` (its kv heads,
a block of slots of every head, or all of it).

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
from repro_torch.parallel.sharding import head_shard, model_size, shard_start

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
# The KV cache over a mesh: each model rank's share
# ---------------------------------------------------------------------------


def kv_layout(mesh, num_kv_heads: int, slots: int) -> str:
    """How a KV cache of ``slots`` slots and K = ``num_kv_heads`` heads lies
    over "model" (``transformer.cache_spec``'s rule): ``"heads"`` where K
    divides the TP width (a rank keeps its K / TP heads; always at TP 1),
    else ``"seq"`` where the slots divide (a rank keeps its contiguous block
    of slots of every head), else ``"whole"`` (every rank keeps it all)."""
    tp = model_size(mesh)
    if num_kv_heads % tp == 0:
        return "heads"
    return "seq" if slots % tp == 0 else "whole"


def kv_share(kv: torch.Tensor, mesh, num_kv_heads: int) -> torch.Tensor:
    """This rank's share of one layer's prefill keys or values: ``kv`` (B,
    S, K', hd) as :func:`attention_prefill` returns them (the rank's heads,
    or every head), cut to the rank's block of slots under ``"seq"``."""
    if mesh is None or kv_layout(mesh, num_kv_heads, kv.shape[1]) != "seq":
        return kv
    n = kv.shape[1] // model_size(mesh)
    return kv.narrow(1, shard_start(mesh, n), n)


def ring_kv_share(kv: torch.Tensor, prompt_len: int, size: int, mesh, num_kv_heads: int,
                  prompt_slots: int) -> torch.Tensor:
    """:func:`ring_kv` on one model rank's share: ``kv`` (L, B, n, K', hd)
    is the rank's share of a prefill's cache of ``prompt_slots`` slots;
    returns its share of the ring of ``size`` slots. The layout of each
    follows :func:`kv_layout`: a cache sharded over the sequence is
    all-gathered over "model" first (a rank's slots of the ring hold
    positions another rank's prefill block held), laid out, and the rank's
    block of the ring kept; under ``"heads"`` (TP 1 included) the rank lays
    out its own heads, as at one card."""
    if kv_layout(mesh, num_kv_heads, prompt_slots) == "seq":
        kv = C.all_gather(kv, mesh, "model", dim=2)
    out = ring_kv(kv, prompt_len, size)
    if kv_layout(mesh, num_kv_heads, size) == "seq":
        n = size // model_size(mesh)
        out = out.narrow(2, shard_start(mesh, n), n).clone()
    return out


def cache_write_share(cache: torch.Tensor, new: torch.Tensor, pos: int, slots: int, mesh, *,
                      rolling: bool = False) -> torch.Tensor:
    """In place: :func:`cache_write` on this rank's block of ``slots``
    global slots (a cache sharded over the sequence): the global slot is
    ``pos % slots`` under a window, else ``pos`` (clamped as
    :func:`cache_write` clamps); only the rank whose block holds it, slot
    // (slots / TP), writes. ``new`` (B, 1, K, hd) holds every kv head."""
    n = cache.shape[1]
    slot = pos % slots if rolling else min(max(pos, 0), slots - 1)
    lo = shard_start(mesh, n)
    if lo <= slot < lo + n:
        cache[:, slot - lo] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             first_slot: int, n_valid: int):
    """:func:`decode_attention`'s softmax over one block of slots: q (B, 1,
    H, hd) of every head; caches (B, n, K, hd), global slots ``first_slot``
    .. ``first_slot`` + n - 1, of which those below ``n_valid`` hold keys.
    Returns the fp32 partials (max (B, K, G), sum of exp (B, K, G),
    unnormalised output (B, K, G, hd)) that
    ``collectives.merge_attention_partials`` combines."""
    B, _, H, hd = q.shape
    n, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qg.float(), k_cache.float()) * (1.0 / math.sqrt(hd))
    valid = first_slot + torch.arange(n, device=q.device) < n_valid
    s = torch.where(valid[None, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return m, p.sum(dim=-1), o


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


def _read_heads(t: torch.Tensor, heads) -> torch.Tensor:
    """The kv heads (dim 2 of ``t``, every head) a rank's q heads read, in
    the order its attention call takes them (``heads.kv``)."""
    if heads.kv_contiguous:
        return t.narrow(2, heads.kv[0], len(heads.kv))
    return t.index_select(2, torch.tensor(heads.kv, device=t.device))


def _qkv_all_kv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    """Serving's projections on a rank whose ``wk`` / ``wv`` are replicated
    (K does not divide the TP width): q (B, S, H_loc, hd) of the rank's q
    heads and k, v (B, S, K, hd) of every kv head, RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(B, S, -1, hd), positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k.reshape(B, S, cfg.num_kv_heads, hd), positions, cfg.rope_theta,
                   cfg.rope_fraction)
    return q, k, v.reshape(B, S, cfg.num_kv_heads, hd)


def attention_prefill(
    p, x: torch.Tensor, positions: torch.Tensor, cfg, mesh=None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Serving's prefill attention: (out (B, S, D), the post-RoPE k and v
    for the KV cache). At one card, or where the kv heads shard over
    "model" (TP 1 included), this is :func:`attention_forward`: k and v are
    the rank's heads. Otherwise ``wk`` / ``wv`` are replicated and the
    cache keeps every kv head (whole, or a block of slots of each:
    :func:`kv_layout`): the rank projects every kv head once, its flash
    call reads the ones its q heads use (``sharding.head_shard``), and
    ``wo`` is row-parallel, summed over "model"."""
    if mesh is None or cfg.num_kv_heads % model_size(mesh) == 0:
        return attention_forward(p, x, positions, cfg, mesh)
    B, S, _ = x.shape
    heads = head_shard(mesh, cfg.num_heads, cfg.num_kv_heads)
    q, k, v = _qkv_all_kv(p, x, cfg, positions)
    out = chunked_attention(q, _read_heads(k, heads), _read_heads(v, heads), causal=cfg.causal,
                            window=cfg.sliding_window)
    out = out.reshape(B, S, q.shape[2] * cfg.head_dim) @ p["wo"]
    return C.sum_over_axis(out, mesh), k, v


def attention_decode(
    p, x: torch.Tensor, pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor, cfg,
    mesh=None, kv_slots: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, D); caches (B, S, K, hd), written in
    place at ``pos`` (ring slot ``pos % S`` under ``cfg.sliding_window``).
    Returns (out, k_cache, v_cache).

    With a ``mesh``, ``p`` holds this rank's shards and the caches its
    share of a cache of ``kv_slots`` global slots (needed unless the kv
    heads shard over "model"), laid out by :func:`kv_layout`; ``wo`` is row-parallel and
    its partial product is summed over "model":

      * ``"heads"``: the one-card step on the rank's q and kv heads;
      * ``"whole"``: every rank writes every kv head and attends with its
        q heads to the kv heads they read;
      * ``"seq"``: every rank projects the new token's k and v of every kv
        head, and the rank whose block holds its slot writes them; the q
        heads are all-gathered over "model" (B x H x hd), each rank takes
        the softmax partials of every head over its own slots, valid by
        their global index (:func:`decode_attention_partial`), the partials
        are combined in rank order (``collectives.merge_attention_partials``:
        the same bits on every rank), and the rank keeps its own heads."""
    B = x.shape[0]
    rolling = cfg.sliding_window is not None
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    layout, heads = "heads", None
    if mesh is not None:
        heads = head_shard(mesh, cfg.num_heads, cfg.num_kv_heads)
        if kv_slots is None and not heads.kv_sharded:
            raise ValueError("a KV cache whose heads do not shard over 'model' needs its "
                             "global slot count (kv_slots) to tell a block of slots from "
                             "the whole")
        layout = kv_layout(mesh, cfg.num_kv_heads, kv_slots or k_cache.shape[1])
    if layout == "heads":
        q, k, v = (qkv_proj(p, x, cfg) if mesh is None
                   else qkv_proj_sharded(p, x, cfg, mesh, heads))
        q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, posb, cfg.rope_theta, cfg.rope_fraction)
        k_cache = cache_write(k_cache, k, pos, rolling=rolling)
        v_cache = cache_write(v_cache, v, pos, rolling=rolling)
        out = decode_attention(q, k_cache, v_cache, pos, rolling=rolling)
    elif layout == "whole":
        q, k, v = _qkv_all_kv(p, x, cfg, posb)
        k_cache = cache_write(k_cache, k, pos, rolling=rolling)
        v_cache = cache_write(v_cache, v, pos, rolling=rolling)
        out = decode_attention(q, _read_heads(k_cache, heads), _read_heads(v_cache, heads),
                               pos, rolling=rolling)
    else:
        q, k, v = _qkv_all_kv(p, x, cfg, posb)
        S = kv_slots
        k_cache = cache_write_share(k_cache, k, pos, S, mesh, rolling=rolling)
        v_cache = cache_write_share(v_cache, v, pos, S, mesh, rolling=rolling)
        m, s, o = decode_attention_partial(C.all_gather(q, mesh, "model", dim=2), k_cache,
                                           v_cache, shard_start(mesh, k_cache.shape[1]),
                                           min(pos + 1, S) if rolling else pos + 1)
        out = C.merge_attention_partials(m, s, o, mesh).reshape(B, 1, -1, cfg.head_dim)
        out = out.narrow(2, heads.q[0], q.shape[2]).to(q.dtype)
    out = out.reshape(B, 1, q.shape[2] * cfg.head_dim) @ p["wo"]
    if mesh is not None:
        out = C.sum_over_axis(out, mesh)
    return out, k_cache, v_cache
