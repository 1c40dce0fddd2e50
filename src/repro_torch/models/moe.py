"""Mixture-of-Experts FFN (mixtral / llama4-scout families).

Port of ``init_moe_mlp``, ``moe_mlp_specs``, ``_capacity`` and ``moe_ffn``
of ``repro/models/moe.py``; ``moe_ffn`` runs at one card or, given a mesh,
as the body of the reference's ``shard_map`` on one rank (its docstring).
Sort-based capacity dispatch (GShard-style, a scatter into an (E, cap, D) buffer
instead of a dense (T, E, cap) one-hot): the flat (token, choice) expert
ids are sorted stably, each entry's rank within its expert is its slot,
and entries ranked past the capacity are dropped. The experts' SwiGLU
products are batched matrix products (``torch.bmm``), as the reference
leaves its einsums to XLA outside any Pallas kernel.

Router top-k gates use the mixtral convention (softmax over the selected
logits). Aux load-balance loss (Switch): E * sum_e f_e * p_e. Every step
avoids a host sync (no boolean indexing): dropped entries go to slot
(0, cap - 1) with zeros added, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import MeshAxes, P, dp_axis, model_size

AUX_WEIGHT = 0.01


def init_moe_mlp(gen: torch.Generator, cfg, device=None) -> Dict[str, torch.Tensor]:
    """One layer's router and experts in ``cfg.param_dtype``, normal draws
    from ``gen`` scaled as in the reference."""
    dt = getattr(torch, cfg.param_dtype)
    device = device or gen.device
    D, Fe, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    return {
        "router": L.normal(gen, (D, E), 0.02, dt, device),
        "wg": L.normal(gen, (E, D, Fe), 1.0 / math.sqrt(D), dt, device),
        "wu": L.normal(gen, (E, D, Fe), 1.0 / math.sqrt(D), dt, device),
        "wd": L.normal(gen, (E, Fe, D), 1.0 / math.sqrt(Fe), dt, device),
    }


def moe_mlp_specs(cfg, ax: MeshAxes) -> Dict[str, P]:
    """Specs of one layer's ``init_moe_mlp`` tree (the reference's without
    its leading [L] dim): the expert inner dim over "model"; under
    ``cfg.fsdp`` the d_model dim also over the data axes."""
    f_ax = ax.model if cfg.moe_d_ff % ax.model_size == 0 else None
    d_ax = dp_axis(ax) if (cfg.fsdp and cfg.d_model % ax.data_size == 0) else None
    return {"router": P(None, None), "wg": P(None, d_ax, f_ax),
            "wu": P(None, d_ax, f_ax), "wd": P(None, f_ax, d_ax)}


def _capacity(tokens: int, cfg) -> int:
    """Slots per expert: ceil(tokens * k / E * factor), at least 8, rounded
    up to a multiple of 8."""
    c = int(math.ceil(tokens * cfg.num_experts_per_tok / cfg.num_experts
                      * cfg.moe_capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(cfg, router: torch.Tensor, xf: torch.Tensor, cap: int) -> Dict[str, torch.Tensor]:
    """The dispatch plan of xf (T, D): fp32 router ``logits`` (T, E), the
    top-k expert ids ``idx`` (T, k) and their ``gates``; over the flat
    (token, choice) entries in stable expert order: ``order``, the expert
    ``e_idx`` and slot ``r_idx`` (dropped entries at (0, cap - 1)), ``keep``
    (rank < cap) and the source token ``tok``."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = xf.shape[0]
    logits = xf.float() @ router.float()  # bf16 products are exact in fp32
    glog, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(glog, dim=-1)
    flat_e = idx.reshape(-1)  # row-major: token-major order
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=xf.device))
    rank = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    keep = rank < cap
    return {"logits": logits, "idx": idx, "gates": gates, "order": order,
            "e_idx": torch.where(keep, sorted_e, 0),
            "r_idx": torch.where(keep, rank, cap - 1),
            "keep": keep, "tok": order // k}


def moe_ffn(cfg, p, x: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, AUX_WEIGHT * aux loss,
    an fp32 scalar).

    With a ``mesh`` this is the body of the reference's ``shard_map``: x is
    this rank's data shard (its tokens stay there; the capacity is that of
    its b_local x S tokens) and ``p``'s experts hold this rank's slice of
    the inner dim over "model". The router runs whole on every model rank.
    The dispatched tokens and the gate weights that scale the experts'
    partial outputs go through ``copy_to_axis`` (their gradients sum over
    "model"); the router logits do not: the aux loss is the same on every
    model rank and its gradient whole on each. The fp32 combine is summed
    over "model" before the cast. The aux loss returned is this data
    shard's; the reference's ``pmean`` over the data axes is the caller's
    (``transformer.loss_fn`` divides the aux by the data ranks before the
    sum over them). Experts whose inner dim does not divide run whole."""
    B, S, D = x.shape
    E, T = cfg.num_experts, B * S
    cap = _capacity(T, cfg)
    xf = x.reshape(T, D)
    r = route(cfg, p["router"], xf, cap)
    e_idx, r_idx, keep, tok = r["e_idx"], r["r_idx"], r["keep"], r["tok"]
    tp = mesh is not None and cfg.moe_d_ff % model_size(mesh) == 0

    rows = torch.where(keep[:, None], (C.copy_to_axis(xf, mesh) if tp else xf)[tok], 0.0)
    buf = torch.zeros((E, cap, D), dtype=xf.dtype, device=xf.device)
    buf.index_put_((e_idx, r_idx), rows, accumulate=True)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    y = torch.bmm(h, p["wd"])  # (E, cap, D); partial over a sharded inner dim

    contrib = y[e_idx, r_idx].float()
    w = torch.where(keep, r["gates"].reshape(-1)[r["order"]], 0.0)
    if tp:
        w = C.copy_to_axis(w, mesh)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, contrib * w[:, None])
    if tp:
        out = C.sum_over_axis(out, mesh)
    out = out.to(x.dtype).reshape(B, S, D)

    # Switch aux loss: fraction routed * mean prob, summed over experts.
    pe = torch.softmax(r["logits"], dim=-1).mean(dim=0)
    fe = F.one_hot(r["idx"], E).float().sum(dim=1).mean(dim=0)
    return out, AUX_WEIGHT * (E * torch.sum(pe * fe))
