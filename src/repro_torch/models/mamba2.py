"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) layers of the port.

Port of ``repro/models/mamba2.py``; the sharding specs
(:func:`mamba_layer_specs`, :func:`mamba_state_specs`) are the reference's
per layer (its leading stacked dims become the port's lists; only ZeRO-1
shards them, ``sharding.P.lead``). Training over a mesh cuts each layer's
params by them: :func:`sharded_layer_forward` runs a rank's d_inner block
and SSD heads. Within a chunk the recurrence is a masked "attention-like"
quadratic form (C_i.B_j with segment decay); across chunks the (heads,
headdim, dstate) state is carried. In the port :func:`ssd_scan` IS the
kernel call (``kernels/ops.py: ssd_chunk_scan``: the hand-written CUDA
kernel for a CUDA tensor, the plain version ``kernels/ref.py:
ssd_chunk_scan_ref`` — the reference's chunk loop — for a CPU one). The
per-token decode recurrence (:func:`ssd_step`) and the convolutions are
plain torch. Parameters are plain dicts of tensors in the reference's
layouts; states are dicts ``{"conv_x", "conv_B", "conv_C", "ssm"}`` of one
layer. :func:`prefill_stack` and :func:`decode_stack` run a list of layers
for the hybrid (``models/hybrid.py``) and ssm (``models/ssm_lm.py``)
families, and :func:`train_stack` runs it for their training: each layer
under ``torch.utils.checkpoint``, so the SSD kernel runs forward, again in
the recompute, and its backward kernel (``kernels/ops.py: _SSDChunkScan``)
once per layer per step. The reference's ``h0`` (a carried-in state) and
``ssd_bf16`` (``low_prec``) are not carried over: no caller or config of the
reference sets them (:func:`ssd_scan` raises on both).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (MeshAxes, P, dp_axis, head_shard, model_size,
                                           shard_start)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Causal depthwise conv (width ssm_conv, unrolled shifts)
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (K, C); left-padded causal depthwise conv, the taps
    summed in order from i = 0."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = w[0] * xp[:, 0:S]
    for i in range(1, K):
        y = y + w[i] * xp[:, i:i + S]
    return y + b


def conv_step(state: torch.Tensor, xt: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """state: (B, K-1, C) last inputs; xt: (B, C). Returns (y (B, C), state)."""
    window = torch.cat([state, xt[:, None].to(state.dtype)], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh) fp32, post-softplus
    A: torch.Tensor,  # (nh,) fp32, negative
    Bm: torch.Tensor,  # (B, S, ng, ds) fp32
    Cm: torch.Tensor,  # (B, S, ng, ds) fp32
    chunk: int,
    h0=None,
    low_prec: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, nh, hd), h_final (B, nh, hd, ds)), through the
    SSD kernel. The TPU kernel takes neither a carried-in state nor the
    bf16 intra-chunk storage, and nothing in the reference reaches them:
    no caller passes ``h0`` (``mamba_layer_forward``'s is never set) and no
    config sets ``ssd_bf16`` (``low_prec``). Both raise (ROADMAP.md Queue 1
    item 16, not carried over)."""
    if h0 is not None or low_prec:
        raise NotImplementedError(
            "ssd_scan with h0 or low_prec (the reference's cfg.ssd_bf16) is not "
            "carried over: no caller or config of the reference sets them, and "
            "the SSD kernel starts from a zero state in fp32 "
            "(ROADMAP.md Queue 1 item 16, not carried over)"
        )
    return ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk)


def ssd_step(
    h: torch.Tensor,  # (B, nh, hd, ds) fp32
    xt: torch.Tensor,  # (B, nh, hd)
    dtt: torch.Tensor,  # (B, nh) fp32
    A: torch.Tensor,  # (nh,)
    Bt_: torch.Tensor,  # (B, ng, ds)
    Ct_: torch.Tensor,  # (B, ng, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence. Returns (y (B, nh, hd), h_new)."""
    nh = xt.shape[1]
    hpg = nh // Bt_.shape[1]
    Bh = Bt_.repeat_interleave(hpg, dim=1)  # (B, nh, ds)
    Ch = Ct_.repeat_interleave(hpg, dim=1)
    decay = torch.exp(dtt * A[None, :])  # (B, nh)
    h_new = h * decay[..., None, None] + torch.einsum(
        "bns,bnd,bn->bnds", Bh, xt.float(), dtt)
    y = torch.einsum("bnds,bns->bnd", h_new, Ch)
    return y.to(xt.dtype), h_new


# ---------------------------------------------------------------------------
# Mamba2 block (layer)
# ---------------------------------------------------------------------------


def init_mamba_layer(gen: torch.Generator, cfg, device=None) -> Dict[str, torch.Tensor]:
    """One layer's params, normal draws from ``gen`` scaled as in the
    reference; A in [-16, -1] (``A_log`` = log(linspace(1, 16, nh)))."""
    dt_ = getattr(torch, cfg.param_dtype)
    device = device or gen.device
    D, din = cfg.d_model, cfg.d_inner
    nh, ng, ds, K = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_conv

    def normal(shape, std):
        return L.normal(gen, shape, std, dt_, device)

    def const(shape, value, dtype=dt_):
        return torch.full(shape, value, dtype=dtype, device=device)

    std = 1.0 / math.sqrt(D)
    return {
        "norm": const((D,), 1.0),
        "wz": normal((D, din), std),
        "wx": normal((D, din), std),
        "wB": normal((D, ng * ds), std),
        "wC": normal((D, ng * ds), std),
        "wdt": normal((D, nh), std),
        "dt_bias": const((nh,), 0.0, torch.float32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=device)),
        "D_skip": const((nh,), 1.0, torch.float32),
        "conv_wx": normal((K, din), 1.0 / math.sqrt(K)),
        "conv_bx": const((din,), 0.0),
        "conv_wB": normal((K, ng * ds), 1.0 / math.sqrt(K)),
        "conv_bB": const((ng * ds,), 0.0),
        "conv_wC": normal((K, ng * ds), 1.0 / math.sqrt(K)),
        "conv_bC": const((ng * ds,), 0.0),
        "out_norm": const((din,), 1.0),
        "wo": normal((din, D), 1.0 / math.sqrt(din)),
    }


def mamba_layer_specs(cfg, ax: MeshAxes) -> Dict[str, P]:
    """Specs of one layer's ``init_mamba_layer`` tree: d_inner and the
    heads over "model" where they divide, the rest replicated."""
    m = ax.model
    tp = ax.model_size
    din_ax = m if cfg.d_inner % tp == 0 else None
    nh_ax = m if cfg.ssm_nheads % tp == 0 else None
    return {
        "norm": P(None), "wz": P(None, din_ax), "wx": P(None, din_ax),
        "wB": P(None, None), "wC": P(None, None), "wdt": P(None, nh_ax),
        "dt_bias": P(nh_ax), "A_log": P(nh_ax), "D_skip": P(nh_ax),
        "conv_wx": P(None, din_ax), "conv_bx": P(din_ax),
        "conv_wB": P(None, None), "conv_bB": P(None),
        "conv_wC": P(None, None), "conv_bC": P(None),
        "out_norm": P(din_ax), "wo": P(din_ax, None),
    }


def mamba_layer_forward(cfg, p, x):
    """x: (B, S, D). Returns (x_out, h_final)."""
    B, S, D = x.shape
    nh, ng, ds = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state
    hd = cfg.ssm_headdim
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z = h @ p["wz"]
    xi = h @ p["wx"]
    Bc = h @ p["wB"]
    Cc = h @ p["wC"]
    dt_raw = (h @ p["wdt"]).float()

    xi = F.silu(causal_conv(xi, p["conv_wx"], p["conv_bx"]))
    Bc = F.silu(causal_conv(Bc, p["conv_wB"], p["conv_bB"]))
    Cc = F.silu(causal_conv(Cc, p["conv_wC"], p["conv_bC"]))

    dt = _softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, nh, hd)
    y, h_fin = ssd_scan(
        xh,
        dt,
        A,
        Bc.reshape(B, S, ng, ds).float(),
        Cc.reshape(B, S, ng, ds).float(),
        cfg.ssm_chunk,
    )
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, cfg.d_inner)
    y = L.rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    return x + y @ p["wo"], h_fin


def mamba_layer_decode(cfg, p, x, state):
    """x: (B, 1, D); state = {"conv_x","conv_B","conv_C","ssm"} of this
    layer. Returns (x_out, new_state)."""
    B = x.shape[0]
    nh, ng, ds, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    h = L.rms_norm(x[:, 0], p["norm"], cfg.norm_eps)  # (B, D)
    z = h @ p["wz"]
    xi = h @ p["wx"]
    Bc = h @ p["wB"]
    Cc = h @ p["wC"]
    dt_raw = (h @ p["wdt"]).float()

    xi, cx = conv_step(state["conv_x"], xi, p["conv_wx"], p["conv_bx"])
    Bc, cB = conv_step(state["conv_B"], Bc, p["conv_wB"], p["conv_bB"])
    Cc, cC = conv_step(state["conv_C"], Cc, p["conv_wC"], p["conv_bC"])
    xi, Bc, Cc = F.silu(xi), F.silu(Bc), F.silu(Cc)

    dt = _softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm = ssd_step(
        state["ssm"],
        xi.reshape(B, nh, hd),
        dt,
        A,
        Bc.reshape(B, ng, ds).float(),
        Cc.reshape(B, ng, ds).float(),
    )
    y = y + p["D_skip"][None, :, None].to(y.dtype) * xi.reshape(B, nh, hd)
    y = y.reshape(B, cfg.d_inner)
    y = L.rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = x + (y @ p["wo"])[:, None]
    return out, {"conv_x": cx, "conv_B": cB, "conv_C": cC, "ssm": ssm}


def init_mamba_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Zero decode state of ONE layer (the reference stacks layers on
    leading dims; the port keeps a state per layer)."""
    K = cfg.ssm_conv
    nh, ng, ds, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    dt_ = getattr(torch, cfg.compute_dtype)
    return {
        "conv_x": torch.zeros((batch, K - 1, cfg.d_inner), dtype=dt_, device=device),
        "conv_B": torch.zeros((batch, K - 1, ng * ds), dtype=dt_, device=device),
        "conv_C": torch.zeros((batch, K - 1, ng * ds), dtype=dt_, device=device),
        "ssm": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
    }


def mamba_state_specs(cfg, ax: MeshAxes, batch: int) -> Dict[str, P]:
    """Specs of one layer's decode state: the batch over the data axes,
    d_inner and the heads over "model", where they divide."""
    b_ax = dp_axis(ax) if batch % ax.data_size == 0 else None
    tp = ax.model_size
    din_ax = ax.model if cfg.d_inner % tp == 0 else None
    nh_ax = ax.model if cfg.ssm_nheads % tp == 0 else None
    return {"conv_x": P(b_ax, None, din_ax), "conv_B": P(b_ax, None, None),
            "conv_C": P(b_ax, None, None), "ssm": P(b_ax, nh_ax, None, None)}


# ---------------------------------------------------------------------------
# Layer stacks (the hybrid and ssm families)
# ---------------------------------------------------------------------------


def _conv_tails(cfg, p, hn, h_fin):
    """A layer's decode state after a prefill: the pre-conv projections of
    the normed input ``hn``'s last ssm_conv - 1 positions (through this
    rank's ``wx`` block and the replicated ``wB`` / ``wC``) and the final
    SSM state."""
    tail_in = hn[:, -(cfg.ssm_conv - 1):]
    return {"conv_x": tail_in @ p["wx"], "conv_B": tail_in @ p["wB"],
            "conv_C": tail_in @ p["wC"], "ssm": h_fin}


def prefill_stack(cfg, h, layers, mesh=None):
    """Run ``layers`` (a list of per-layer params) over h (B, S, D).
    Returns (h, the list of each layer's decode state: the pre-conv
    projections of the last ssm_conv - 1 positions and the final SSM
    state). The prefill of the hybrid and ssm families. With a ``mesh``
    whose "model" axis (TP > 1) divides d_inner, ``layers`` hold this
    rank's shards, each layer runs tensor-parallel
    (:func:`sharded_layer_forward`) and each state is the rank's share
    under :func:`mamba_state_specs`: ``conv_x`` of its d_inner block,
    ``conv_B`` / ``conv_C`` whole, ``ssm`` of its heads (of every head in
    the mixed layout); otherwise every layer is the one-card layer."""
    states = []
    for lp in layers:
        if _sharded(cfg, mesh):
            out, h_fin, hn = _sharded_layer(cfg, lp, h, mesh)
        else:
            out, h_fin = mamba_layer_forward(cfg, lp, h)
            hn = L.rms_norm(h, lp["norm"], cfg.norm_eps)
        states.append(_conv_tails(cfg, lp, hn, h_fin))
        h = out
    return h, states


def _local_groups(t: torch.Tensor, mesh, nh: int, ng: int) -> torch.Tensor:
    """The B or C groups (dim 2 of ``t``, (B, S, ng, ds)) that this model
    rank's heads read, in the order its scan call takes them: the rank's
    own ng / TP groups where they divide, else the groups its heads fall
    in, or one group per local head where a group is split unevenly
    (``sharding.head_shard``'s rule for the kv heads of attention)."""
    heads = head_shard(mesh, nh, ng)
    if heads.kv_sharded or heads.kv_contiguous:
        return t.narrow(2, heads.kv[0], len(heads.kv))
    return t.index_select(2, torch.tensor(heads.kv, device=t.device))


def sharded_layer_forward(cfg, p, x, mesh):
    """One layer of the training forward on one rank of a mesh whose "model"
    axis (TP > 1) divides d_inner; ``p`` is this rank's shards under
    :func:`mamba_layer_specs`, x (B, S, D) is replicated over "model". The
    rank runs its d_inner block through ``wz`` / ``wx`` and the depthwise
    conv, and ``wo`` row-parallel (its partial product summed over
    "model"); the normed input goes into the sharded projections through
    ``copy_to_axis``. Where the heads divide too, the SSD scan runs at the
    rank's heads and the groups they read; ``wB`` / ``wC`` and their convs
    are replicated, so B and C go into the scan through ``copy_to_axis``
    (their gradient, each rank's heads' share, sums there; the normed input
    feeds them directly, so its B / C term is counted once). Where the
    heads do not divide (the mixed layout), x's block is gathered, every
    rank scans every head with the replicated dt, B and C, and the output
    goes back to the rank's block through ``copy_to_axis``, so everything
    before it gets the whole gradient. The gated RMSNorm normalizes over
    the whole d_inner (:func:`layers.sharded_rms_norm`). Returns the
    layer's output, replicated over "model"."""
    return _sharded_layer(cfg, p, x, mesh)[0]


def _sharded_layer(cfg, p, x, mesh):
    """:func:`sharded_layer_forward` -> (its output, the final SSM state of
    the heads the rank scanned, the normed input)."""
    B, S, _ = x.shape
    tp = model_size(mesh)
    nh, ng, ds, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    heads_split = nh % tp == 0
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    hc = C.copy_to_axis(h, mesh)
    z = hc @ p["wz"]
    xi = hc @ p["wx"]
    Bc = h @ p["wB"]
    Cc = h @ p["wC"]
    dt_raw = ((hc if heads_split else h) @ p["wdt"]).float()

    xi = F.silu(causal_conv(xi, p["conv_wx"], p["conv_bx"]))
    Bc = F.silu(causal_conv(Bc, p["conv_wB"], p["conv_bB"]))
    Cc = F.silu(causal_conv(Cc, p["conv_wC"], p["conv_bC"]))

    dt = _softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bm = Bc.reshape(B, S, ng, ds).float()
    Cm = Cc.reshape(B, S, ng, ds).float()
    din_loc = xi.shape[-1]
    if heads_split:
        Bm, Cm = (_local_groups(C.copy_to_axis(t, mesh), mesh, nh, ng) for t in (Bm, Cm))
        xh = xi.reshape(B, S, nh // tp, hd)
    else:
        xh = C.gather_from_axis(xi, mesh, dim=-1).reshape(B, S, nh, hd)
    y, h_fin = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, -1)
    if not heads_split:
        y = C.copy_to_axis(y, mesh).narrow(-1, shard_start(mesh, din_loc), din_loc)
    y = L.sharded_rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps, cfg.d_inner, mesh)
    return x + C.sum_over_axis(y @ p["wo"], mesh), h_fin, h


def _sharded(cfg, mesh) -> bool:
    """Whether a mamba layer runs tensor-parallel on ``mesh``: a "model"
    axis wider than 1 that divides d_inner (the specs shard nothing of a
    layer otherwise)."""
    tp = model_size(mesh)
    return tp > 1 and cfg.d_inner % tp == 0


def sharded_layer_decode(cfg, p, x, state, mesh):
    """:func:`mamba_layer_decode` on one rank of a mesh whose "model" axis
    (TP > 1) divides d_inner: ``p`` this rank's shards, ``state`` its share
    (:func:`mamba_state_specs`), x (B, 1, D) replicated over "model".
    ``conv_step`` on the rank's d_inner channels and the whole B / C
    channels; where the heads divide, ``ssd_step`` on the rank's heads and
    the groups they read; in the mixed layout x's block is all-gathered
    and every rank steps every head (its ``ssm`` state whole), keeping its
    block of the output; the gated RMSNorm over the whole d_inner
    (``layers.sharded_rms_norm``), ``wo`` row-parallel, summed over
    "model". Returns (x_out, new state)."""
    B = x.shape[0]
    tp = model_size(mesh)
    nh, ng, ds, hd = cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    heads_split = nh % tp == 0
    h = L.rms_norm(x[:, 0], p["norm"], cfg.norm_eps)  # (B, D)
    z = h @ p["wz"]
    xi = h @ p["wx"]
    Bc = h @ p["wB"]
    Cc = h @ p["wC"]
    dt_raw = (h @ p["wdt"]).float()

    xi, cx = conv_step(state["conv_x"], xi, p["conv_wx"], p["conv_bx"])
    Bc, cB = conv_step(state["conv_B"], Bc, p["conv_wB"], p["conv_bB"])
    Cc, cC = conv_step(state["conv_C"], Cc, p["conv_wC"], p["conv_bC"])
    xi, Bc, Cc = F.silu(xi), F.silu(Bc), F.silu(Cc)

    dt = _softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bm = Bc.reshape(B, 1, ng, ds).float()
    Cm = Cc.reshape(B, 1, ng, ds).float()
    din_loc = xi.shape[-1]
    if heads_split:
        Bm, Cm = (_local_groups(t, mesh, nh, ng) for t in (Bm, Cm))
        xh = xi.reshape(B, nh // tp, hd)
    else:
        xh = C.all_gather(xi, mesh, "model", dim=-1).reshape(B, nh, hd)
    y, ssm = ssd_step(state["ssm"], xh, dt, A, Bm[:, 0], Cm[:, 0])
    y = y + p["D_skip"][None, :, None].to(y.dtype) * xh
    y = y.reshape(B, -1)
    if not heads_split:
        y = y.narrow(-1, shard_start(mesh, din_loc), din_loc)
    y = L.sharded_rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps, cfg.d_inner, mesh)
    out = x + C.sum_over_axis(y @ p["wo"], mesh)[:, None]
    return out, {"conv_x": cx, "conv_B": cB, "conv_C": cC, "ssm": ssm}


def train_layer(cfg, p, x, mesh=None):
    """One layer of the training forward: its output (the final SSM state
    is dropped, as the reference's scan body drops it). With a ``mesh``
    whose "model" axis (TP > 1) divides d_inner, ``p`` is this rank's shards
    and the layer runs tensor-parallel (:func:`sharded_layer_forward`);
    otherwise every tensor of the layer is whole on every rank (a TP of 1,
    or a d_inner that does not divide: the specs replicate every leaf) and
    the layer is the one-card layer, op for op."""
    if _sharded(cfg, mesh):
        return sharded_layer_forward(cfg, p, x, mesh)
    return mamba_layer_forward(cfg, p, x)[0]


def train_stack(cfg, layers, x, mesh=None):
    """The layers in order over x (B, S, D), each recomputed in the backward
    (non-reentrant ``torch.utils.checkpoint``: only its input is kept, and
    a tensor-parallel layer runs its collectives again), as the
    reference's ``jax.checkpoint`` of its scan body at its default
    ``remat``."""
    for lp in layers:
        x = checkpoint(train_layer, cfg, lp, x, mesh, use_reentrant=False)
    return x


def decode_stack(cfg, h, layers, states, mesh=None):
    """One token through ``layers``; ``states`` (a list, one per layer) is
    updated in place, each new state cast to the cache's dtypes. With a
    ``mesh`` (:func:`prefill_stack`'s rule) each layer and state is this
    rank's share (:func:`sharded_layer_decode`)."""
    for i, lp in enumerate(layers):
        if _sharded(cfg, mesh):
            h, st = sharded_layer_decode(cfg, lp, h, states[i], mesh)
        else:
            h, st = mamba_layer_decode(cfg, lp, h, states[i])
        states[i] = {k: st[k].to(states[i][k].dtype) for k in st}
    return h
