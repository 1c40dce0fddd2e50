"""ScratchPipe applied to an LM's input token-embedding table.

Port of ``repro/core/cached_embedding.py`` at one card. The training corpus
records every future token id (exactly the paper's precondition), so the
same look-forward cache keeps the LM's token-embedding working set in the
device scratchpad while the full (vocab, d_model) table lives in host
memory. Only the *input* table offloads: the output head takes part in a
dense product every step and stays on the card (DESIGN.md
§Arch-applicability).

[Train] stage (``train_fn``): gather the unique cached rows the batch
touches, run the LM's forward and backward with those rows as a
differentiable activation (``inputs_embeds``), then plain SGD, as the
reference: every param ``p - lr * g`` and the touched scratchpad rows
``+= -emb_lr * g_rows``, both in place. No clipping and no AdamW (the
reference does not use ``launch/steps.py`` here either). The rows are
gathered and updated with torch indexing, as the reference uses
``jnp.take`` and ``.at[].add`` there, not a Pallas kernel; on the card the
loss reaches the flash kernel and its backward kernel in every layer.

Over a (data, model) mesh (``mesh=``, a ``DeviceMesh``: NCCL on the card,
gloo for ``device="cpu"``), as the reference hands its mesh to its sharded
loss: the params are this rank's shards under ``models/api.py:
param_specs`` (without ``embed``) and the loss is ``api.make_loss_fn(cfg,
mesh)``, the whole batch's mean. The scratchpad is whole on every rank:
each rank's ``ScratchPipe`` plans the global batch, so slots, misses and
evictions are the same everywhere, and a rank gathers the rows of its own
data shard's tokens. The rows' gradients come out whole over "model" (the
input enters each layer through ``collectives.copy_to_axis``, whose
backward sums over "model") and partial over the data ranks: they are
all-gathered there and summed in rank order, no float atomics, so every
replica's storage, and its flushed host table, stays bitwise equal to the
others'. The dense params' gradients are summed over the data ranks where
their leaf is replicated there (``collectives.sum_tree_over_data``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api, transformer
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import data_index, mesh_axes, spec_leaves


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) on ``device``. A host array reaches the
    card from pinned memory, with no wait for the stream's earlier work."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def unique_inverse(slots, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uniq, inv)`` of the flattened ``slots`` on ``device`` (int64),
    ``uniq[inv]`` being the slots in order. The slots are the host
    planner's (numpy) or the device planner's (a tensor); either way the
    work stays on the device, without a host sync: ``torch.unique`` sizes
    its output on the host, so a stable sort marks each run's head instead,
    and ``uniq`` keeps the batch's length, the sorted unique slots first
    (``np.unique``'s) and the largest slot repeated after them. No ``inv``
    points past the unique slots, so the repeats get a zero gradient and
    their update adds zero."""
    flat = _to_device(slots, device).reshape(-1).to(torch.int64)
    srt, perm = torch.sort(flat, stable=True)
    head = torch.ones_like(srt, dtype=torch.bool)
    head[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(head, 0) - 1  # each sorted slot's unique index
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    # equal slots write equal values: the scatter's result is fixed
    uniq = srt[-1:].expand_as(srt).clone().scatter_(0, seg, srt)
    return uniq, inv


class CachedEmbeddingLM:
    """Builds the ScratchPipe [Train] fn for an LM arch.

    ``params`` hold everything EXCEPT the input embedding (which is the
    host table + scratchpad): drawn by ``api.init`` from ``gen`` (or a
    generator on ``device`` seeded with ``seed``), ``"embed"`` dropped, or
    given as ``params=`` (a tree on ``device`` without ``"embed"``, e.g.
    the reference's through ``convert.lm_params_from_reference``). With a
    ``mesh``, the model is ``cfg`` padded for it, the drawn params are cut
    to this rank's shards, and ``params=`` must be those shards (the
    reference's through ``convert.lm_params_to_rank``). Batches carry
    ``labels`` (B, S), the whole batch's on every rank; [Train] receives
    their [Plan]-translated token slots. The params are updated in
    place."""

    def __init__(self, cfg, *, gen: Optional[torch.Generator] = None,
                 seed: Optional[int] = None, lr: float = 1e-2, emb_lr: float = 1e-2,
                 device="cuda", params: Optional[dict] = None, mesh=None):
        self.device = resolve_device(device)
        ax = None if mesh is None else mesh_axes(mesh)
        rc, _ = api.runtime_config(cfg, ax)
        if rc.tie_embeddings:
            raise ValueError(f"{cfg.name}: the cached-embedding LM needs an untied head "
                             "(the config sets tie_embeddings=True)")
        if api.family_module(rc) is not transformer:
            raise ValueError(f"{cfg.name}: the {rc.family!r} family takes no inputs_embeds")
        if mesh is not None:
            _check_mesh(mesh, self.device)
        self.cfg = rc
        self.mesh = mesh
        self.lr = lr
        self.emb_lr = emb_lr
        if params is None:
            if gen is None:
                if seed is None:
                    raise ValueError("give gen=, seed= or params=")
                gen = torch.Generator(device=self.device).manual_seed(seed)
            params = api.init(rc, gen, device=self.device, ax=ax)
            params.pop("embed")
            if mesh is not None:
                params = api.local_params(params, cfg, mesh, without=("embed",))
        elif "embed" in params:
            raise ValueError("params= must not hold the embedding: the host table does")
        self.params = params
        self._loss = api.make_loss_fn(cfg, mesh)
        self._specs = None
        if mesh is not None:
            specs = api.param_specs(cfg, ax)
            self._specs = spec_leaves({k: v for k, v in specs.items() if k in params})

    def train_fn(self, storage: torch.Tensor, slots, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One [Train] step over the scratchpad ``storage`` (updated in
        place and returned) -> (storage, {"loss": the fp32 loss, a device
        tensor}). On the card the step makes no host sync: the slots and
        the labels go up from pinned memory and the loss stays there."""
        uniq, inv = unique_inverse(slots, self.device)
        labels = _to_device(batch["labels"], self.device)
        B, S = labels.shape
        if self.mesh is not None:  # this rank's data shard of the batch
            b = B // C.data_size(self.mesh)
            lo = data_index(self.mesh) * b
            labels, inv = labels[lo:lo + b], inv.reshape(B, S)[lo:lo + b].reshape(-1)
            B = b
        live = tree_map(lambda p: p.detach().requires_grad_(True), self.params)
        with torch.enable_grad():
            rows0 = storage[uniq].requires_grad_(True)
            x = rows0[inv].reshape(B, S, storage.shape[1])
            loss = self._loss(live, {"inputs_embeds": x, "labels": labels})
            grads = torch.autograd.grad(loss, tree_leaves(live) + [rows0],
                                        materialize_grads=True)
        grads, g_rows = list(grads[:-1]), grads[-1]
        with torch.no_grad():
            if self.mesh is not None:
                C.sum_tree_over_data(grads, self._specs, self.mesh)
                g_rows = _sum_over_data_in_order(g_rows, self.mesh)
            for p, g in zip(tree_leaves(self.params), grads):
                p.sub_(self.lr * g.to(p.dtype))
            # uniq holds no slot twice but its zero-gradient repeats, whose
            # adds are + 0: one add per element
            storage.index_add_(0, uniq, (-self.emb_lr * g_rows).to(storage.dtype))
        return storage, {"loss": loss.detach()}


def _sum_over_data_in_order(t: torch.Tensor, mesh) -> torch.Tensor:
    """The data ranks' ``t`` all-gathered and added in rank order (pod
    major): the same bits on every rank, without float atomics. One data
    rank: ``t`` itself."""
    if C.data_size(mesh) == 1:
        return t
    parts = C.gather_over_data(t[None], mesh)
    out = parts[0]
    for r in range(1, parts.shape[0]):
        out = out + parts[r]
    return out


def _check_mesh(mesh, device: torch.device) -> None:
    """The mesh's device and its group's backend must be ``device``'s: NCCL
    on the card, gloo on the CPU (no fallback from one to the other)."""
    import torch.distributed as dist

    want = {"cuda": "nccl", "cpu": "gloo"}[device.type]
    have = dist.get_backend()
    if mesh.device_type != device.type or have != want:
        raise ValueError(f"a {mesh.device_type} mesh over {have} for device {device}: "
                         f"the cached-embedding LM on {device.type} needs {want}")
