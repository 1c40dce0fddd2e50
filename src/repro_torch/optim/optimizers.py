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

Over a mesh (``launch/steps.py: make_train_step(cfg, mesh=)``) the
params and gradients are a rank's shards: :func:`global_norm` sums each
leaf's squares over the mesh axes its spec shards it on (a replicated leaf
counts once), and ``AdamW(zero1=Zero1(...))`` keeps the reference's ZeRO-1
state (``launch/steps.py: opt_state_specs``, ``parallel/sharding.py:
zero1_spec``): ``m``, ``v`` and ``master`` hold this data rank's slice,
which it updates, then all-gathers the new params over the data axes.
A layer list's state may split by layer, along either stacked dim of the
hybrid family's ``groups[G][m]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares: a
    0-dim fp32 tensor on the leaves' device (no host sync). With a
    ``mesh``, the leaves are this rank's shards and ``specs`` their specs
    in leaf order (``parallel/sharding.py: spec_leaves``): each leaf's sum
    is summed over the mesh axes its spec shards it on, so every rank gets
    the norm of the whole tree and a replicated leaf counts once."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    if mesh is not None:
        sq = _sum_over_spec_axes(sq, specs, mesh)
    return torch.sqrt(torch.stack(sq).sum())


def _sum_over_spec_axes(sq: List[torch.Tensor], specs, mesh) -> List[torch.Tensor]:
    """Each 0-dim ``sq[i]`` summed over the axes of ``specs[i]``: one
    all-reduce per axis per group of leaves that share their axes."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import spec_axes

    groups = {}
    for i, (_, spec) in enumerate(specs):
        axes = tuple(a for a in mesh.mesh_dim_names if a in spec_axes(spec))
        if axes:
            groups.setdefault(axes, []).append(i)
    out = list(sq)
    for axes, idx in groups.items():
        v = torch.stack([sq[i] for i in idx])
        for a in axes:
            v = C.all_reduce(v, mesh, a)
        for j, i in enumerate(idx):
            out[i] = v[j]
    return out


def clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)), each leaf in
    fp32 and rounded back to its dtype, in place; the norm). ``specs`` and
    ``mesh`` as in :func:`global_norm`."""
    norm = global_norm(grads, specs, mesh)
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


class Zero1:
    """The reference's ZeRO-1 layout of an AdamW state on one rank of a
    mesh: per param leaf (``tree_leaves`` order), from its param spec and
    its state spec (``launch/steps.py: opt_state_specs``):

      * ``same`` — the state is shaped as the param shard (the param is
        sharded over the data axes already, FSDP, or too small to split);
      * ``dim`` — the state is this data rank's block along tensor dim
        ``dim`` of the param shard;
      * ``lead`` — the state of a layer list is split over the data ranks
        by layer (``P.lead``) along one of its stacked dims (the hybrid's
        ``groups[G][m]`` has two: ``zero1_spec`` picks the first that
        divides): along a dim of L layers, ``[i L / n, (i + 1) L / n)`` on
        data rank ``i``, so a rank owns whole groups, or whole layers of
        every group; a layer another rank holds has empty state leaves
        here.

    Data ranks are counted over ("pod", "data"), pod major, as a dim
    sharded over both is laid out. ``coords`` (a rank's coordinate by axis
    name) stands in for the mesh's own, as on an ``AbstractMesh``."""

    def __init__(self, mesh, param_specs, state_specs, coords=None):
        from repro_torch.parallel.sharding import (data_dims, data_index, mesh_axes,
                                                   spec_leaves)

        ax = mesh_axes(mesh)
        self.mesh, self.n, self.index = mesh, ax.data_size, data_index(mesh, coords)
        # per leaf: (kind, dim, owned, the key of the layers it is gathered with)
        self.plan = []
        for (path, ps), (_, os_) in zip(spec_leaves(param_specs), spec_leaves(state_specs)):
            split = [k for k, e in enumerate(os_.lead) if e is not None]
            if split:
                k = split[0]  # path: (list name, its indices outermost first, leaf keys)
                layers = param_specs[path[0]]
                for i in path[1:1 + k]:
                    layers = layers[i]
                per = len(layers) // self.n
                self.plan.append(("lead", None, path[1 + k] // per == self.index,
                                  path[:1 + k] + path[2 + k:]))
                continue
            split = [d for d in data_dims(os_, ax) if d not in data_dims(ps, ax)]
            self.plan.append(("dim", split[0], True, None) if split
                             else ("same", None, True, None))

    def block(self, t: torch.Tensor, entry) -> torch.Tensor:
        """This rank's part of the param-shaped ``t`` (a view), or None for
        a layer another data rank holds."""
        kind, dim, owned, _ = entry
        if kind == "dim":
            n = t.shape[dim] // self.n
            return t.narrow(dim, self.index * n, n)
        return t if owned else None


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    master_fp32: bool = True  # keep fp32 master copy when params are low-prec
    #: the ZeRO-1 layout over a mesh (:class:`Zero1`); None at one card
    zero1: Optional[Zero1] = None

    def init(self, params):
        if self.zero1 is not None:
            return self._init_zero1(params)
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

    def _init_zero1(self, params):
        """Zeros for ``m`` and ``v`` and the fp32 ``master`` of this rank's
        ZeRO-1 part of each leaf (:class:`Zero1`); empty leaves for the
        layers another data rank holds."""
        if not self.master_fp32:
            raise NotImplementedError("ZeRO-1 keeps an fp32 master")
        leaves = tree_leaves(params)
        part = {id(p): self.zero1.block(p, e) for p, e in zip(leaves, self.zero1.plan)}

        def like(fn):
            return tree_map(lambda p: p.new_empty((0,), dtype=torch.float32)
                            if part[id(p)] is None else fn(part[id(p)]), params)

        return {"m": like(lambda b: torch.zeros(b.shape, dtype=torch.float32, device=b.device)),
                "v": like(lambda b: torch.zeros(b.shape, dtype=torch.float32, device=b.device)),
                "t": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                "master": like(lambda b: b.detach().to(torch.float32, copy=True))}

    def _update(self, p32, g, m, v, b1t, b2t, lr):
        """One leaf's update in place: m, v, then the fp32 master ``p32``."""
        g32 = g.float()
        m.mul_(self.b1).add_((1 - self.b1) * g32)
        v.mul_(self.b2).add_((1 - self.b2) * torch.square(g32))
        del g32
        step = torch.div(v, b2t).sqrt_().add_(self.eps)  # sqrt(vh) + eps
        step = torch.div(m, b1t).div_(step)  # mh / (sqrt(vh) + eps)
        if self.weight_decay:
            step.add_(self.weight_decay * p32.float())
        step.mul_(lr)
        p32.sub_(step)

    @torch.no_grad()
    def step(self, params, grads, state, lr):
        """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p32 -= lr (m / b1t
        / (sqrt(v / b2t) + eps) + wd p32), with b1t = 1 - b1^t, b2t = 1 -
        b2^t in fp32 (as the reference's jnp power); params = p32 in their
        dtype. All in place. With ``zero1``, ``grads`` are whole over the
        data axes (summed there) and each rank updates its part of the state
        (:class:`Zero1`), then all-gathers the new params over the data
        axes."""
        t = state["t"].add_(1)
        tf = t.float()
        b1t = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=t.device), tf)
        b2t = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=t.device), tf)
        if self.zero1 is not None:
            return self._step_zero1(params, grads, state, lr, b1t, b2t)
        base = state["master"] if self.master_fp32 else params
        for p, g, m, v, p32 in zip(tree_leaves(params), tree_leaves(grads),
                                   tree_leaves(state["m"]), tree_leaves(state["v"]),
                                   tree_leaves(base)):
            if self.master_fp32:
                self._update(p32, g, m, v, b1t, b2t, lr)
                p.copy_(p32)
            else:
                p32 = p.float()
                self._update(p32, g, m, v, b1t, b2t, lr)
                p.copy_(p32)
        return params, state

    def _step_zero1(self, params, grads, state, lr, b1t, b2t):
        from repro_torch.parallel import collectives as C

        z = self.zero1
        # a split layer list's params and the ones this rank updated, by the
        # key of the layers gathered together, in layer order
        stacks = {}
        for p, g, m, v, p32, e in zip(tree_leaves(params), tree_leaves(grads),
                                      tree_leaves(state["m"]), tree_leaves(state["v"]),
                                      tree_leaves(state["master"]), z.plan):
            kind, dim, owned, key = e
            if kind == "lead":
                group = stacks.setdefault(key, ([], []))
                group[0].append(p)
                if owned:
                    self._update(p32, g, m, v, b1t, b2t, lr)
                    p.copy_(p32)
                    group[1].append(p)
                continue
            self._update(p32, z.block(g, e), m, v, b1t, b2t, lr)
            if kind == "dim":
                p.copy_(C.gather_over_data(p32.to(p.dtype), z.mesh, dim=dim))
            else:
                p.copy_(p32)
        for ps, mine in stacks.values():  # one key's layers at a time
            for p, new in zip(ps, C.gather_over_data(torch.stack(mine), z.mesh).unbind(0)):
                p.copy_(new)
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
