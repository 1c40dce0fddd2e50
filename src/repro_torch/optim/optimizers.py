"""Optimizers (no external deps): SGD, AdamW (with fp32 master weights for
bf16 params), row-wise Adagrad (the standard embedding-table optimizer).

Port of ``repro/optim/optimizers.py``. The API is the reference's:
``opt.init(params) -> state``; ``opt.step(params, grads, state, lr) ->
(params, state)``, over nested dicts/lists of tensors. A state is a plain
tree of tensors (``t`` a 0-dim int32), so ``CheckpointManager`` saves it
as it is. Unlike the reference, whose arrays are immutable, ``step``
updates ``params`` and the state IN PLACE under ``torch.no_grad`` and
returns the same objects: at full width the fp32 ``m``, ``v`` and
``master`` trees are 12 bytes a parameter, and a second copy of them
would not fit beside the first on one card. Every arithmetic step is the
reference's, in its order, in fp32 (the temporaries are one leaf at a
time). ``torch.optim`` is not used: its AdamW keeps no master copy and
orders its update otherwise.

The reference's ZeRO-1 sharding of the state (``parallel.sharding.
zero1_spec``) has no meaning on one card (ROADMAP.md Queue 1 item 19).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict/list/tuple, dicts in key order (the
    order ``jax.tree.leaves`` visits a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares: a
    0-dim fp32 tensor on the leaves' device (no host sync)."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)), each leaf in
    fp32 and rounded back to its dtype, in place; the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        for g in tree_leaves(grads):
            g.copy_(g.float() * scale)
    return grads, norm


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    @torch.no_grad()
    def step(self, params, grads, state, lr):
        if self.momentum == 0.0:
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.copy_(p.float() - lr * g.float())
            return params, state
        for p, g, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state)):
            v.copy_(self.momentum * v + g.float())
            p.copy_(p.float() - lr * v)
        return params, state


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    master_fp32: bool = True  # keep fp32 master copy when params are low-prec

    def init(self, params):
        st = {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "t": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
        }
        if self.master_fp32:
            st["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
        return st

    @torch.no_grad()
    def step(self, params, grads, state, lr):
        """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p32 -= lr (m / b1t
        / (sqrt(v / b2t) + eps) + wd p32), with b1t = 1 - b1^t, b2t = 1 -
        b2^t in fp32 (as the reference's jnp power); params = p32 in their
        dtype. All in place."""
        t = state["t"].add_(1)
        tf = t.float()
        b1t = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=t.device), tf)
        b2t = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=t.device), tf)
        base = state["master"] if self.master_fp32 else params
        for p, g, m, v, p32 in zip(tree_leaves(params), tree_leaves(grads),
                                   tree_leaves(state["m"]), tree_leaves(state["v"]),
                                   tree_leaves(base)):
            g32 = g.float()
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g32))
            del g32
            step = torch.div(v, b2t).sqrt_().add_(self.eps)  # sqrt(vh) + eps
            step = torch.div(m, b1t).div_(step)  # mh / (sqrt(vh) + eps)
            if self.weight_decay:
                step.add_(self.weight_decay * p32.float())
            step.mul_(lr)
            if self.master_fp32:
                p32.sub_(step)
                p.copy_(p32)
            else:
                p.copy_(p.float() - step)
        return params, state


@dataclasses.dataclass(frozen=True)
class RowWiseAdagrad:
    """One accumulator per embedding ROW (Facebook's DLRM embedding optimizer)
    — 1/D the state of full Adagrad; the natural choice for scratchpad rows."""

    eps: float = 1e-8

    def init_rows(self, num_rows: int, device="cpu"):
        return torch.zeros((num_rows,), dtype=torch.float32, device=device)

    def step_rows(self, rows, row_grads, acc, lr):
        """rows (n, D) updated with grads (n, D); acc (n,) gathered slice.
        Returns (new rows in rows' dtype, new acc) — new tensors, as the
        reference (the caller scatters them back)."""
        g2 = torch.mean(torch.square(row_grads.float()), dim=-1)
        acc = acc + g2
        scale = lr / (torch.sqrt(acc) + self.eps)
        new = rows.float() - scale[:, None] * row_grads.float()
        return new.to(rows.dtype), acc


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def warmup_cosine(step, *, base_lr: float, warmup: int, total: int, min_frac=0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine down
    to ``min_frac * base_lr`` at ``total``; an fp32 0-dim tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    progress = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup, warm, cos)
