"""DLRM [Train] stage: the fwd+bwd+update computation shared by ScratchPipe
AND both baselines (identical math; only row placement differs).

Port of the fp32 half of ``repro/core/dlrm_runtime.py``. The embedding rows
enter as the ``storage`` operand (scratchpad / transient gathered region /
pinned region) addressed by [Plan]-translated slots; the gradient
duplication -> coalescing -> scatter update runs on whatever memory holds
``storage``. On the card the per-cycle embedding work is two kernel
launches of the port's own CUDA kernels — the gather (or the fused
fill+gather) forward and the sorted scatter-add backward — plus the
library's radix sort of the slot ids for the backward.

Gradients w.r.t. the bags are taken explicitly (``torch.autograd.grad`` on
the bags and the MLP parameters) and fed to the backward kernel as
pre-rounded per-bag deltas. A gradient w.r.t. the whole storage operand
would materialize a dense (slots, D) cotangent every iteration, which is
exactly the O(table) traffic the paper's coalesced scatter exists to avoid
(the ``torch.autograd.Function``s of ``kernels/ops.py`` exist for the grad
checks, not for this step).

The storage update is IN PLACE: ``train_fn`` returns the very tensor it was
given, its looked-up rows updated (the reference donates the buffer and
returns a new array). The loss stays a device tensor in ``aux``: reading it
(``float(aux["loss"])``) synchronizes, so the runtimes never do it per step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import scratchpad as sp
from repro_torch.device import resolve_device
from repro_torch.models import dlrm


def _mlp_step(model: dlrm.DLRM, dense, bags, label, lr: float):
    """Loss, its gradient w.r.t. the bags, and the SGD update of the MLP
    parameters (``p - lr * g``, as the reference)."""
    bags = bags.detach().requires_grad_(True)
    params = list(model.parameters())
    with torch.enable_grad():
        loss = dlrm.bce_loss(dlrm.forward_from_bags(model, dense, bags), label)
        grads = torch.autograd.grad(loss, [bags] + params)
    with torch.no_grad():
        for p, g in zip(params, grads[1:]):
            p.sub_(g * lr)
    return loss.detach(), grads[0]


def dlrm_train_step(storage, model, slots, dense, label, lr: float):
    """One [Train] step: gather bags, MLP fwd+bwd+SGD, coalesced scatter
    update of the looked-up rows (in place). -> (storage, loss)."""
    bags = sp.gather_reduce(storage, slots)
    loss, g_bags = _mlp_step(model, dense, bags, label, lr)
    storage = sp.apply_grad(storage, slots, g_bags, lr)
    return storage, loss


def dlrm_fill_train_step(
    storage, model, fill_slots, fill_rows, slots, dense, label, lr: float
):
    """Fused [Insert]-fill + [Train]: the fill lands before the gather —
    exactly the split engine's intra-cycle order — in ONE kernel launch on
    the card (``scratchpad.fill_gather_reduce``), so results are bitwise
    equal to fill-then-train. ``fill_slots`` may be bucket-padded with
    out-of-bounds sentinels (dropped). -> (storage, loss)."""
    storage, bags = sp.fill_gather_reduce(storage, fill_slots, fill_rows, slots)
    loss, g_bags = _mlp_step(model, dense, bags, label, lr)
    storage = sp.apply_grad(storage, slots, g_bags, lr)
    return storage, loss


class DLRMTrainer:
    """Holds the dense (MLP) parameters; exposes ``train_fn(storage, slots,
    batch)`` for the cache runtimes. ``slots`` and the batch's ``dense`` and
    ``label`` arrive as numpy arrays (from the planner and the stream) and
    are copied to ``device``; ``storage`` already lies there. fp32 only: the
    reduced precisions come with the mixed-precision slice."""

    def __init__(self, cfg, seed: int = 0, lr: float = 0.05, *,
                 precision: str = None, device="cuda"):
        precision = precision if precision is not None else getattr(
            cfg, "precision", "fp32"
        )
        if precision != "fp32":
            raise NotImplementedError(
                f"precision={precision!r}: the port's trainer is fp32 so far "
                "(mixed precision: ROADMAP.md Queue 1 item 8)"
            )
        self.cfg = cfg
        self.lr = lr
        self.precision = precision
        self.device = resolve_device(device)
        self.model = dlrm.DLRM(cfg, seed=seed).to(self.device)

    def _to_device(self, slots, batch):
        slots_t = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32))
        dense = torch.from_numpy(np.ascontiguousarray(batch["dense"], dtype=np.float32))
        label = torch.from_numpy(np.ascontiguousarray(batch["label"], dtype=np.float32))
        return (slots_t.to(self.device), dense.to(self.device),
                label.to(self.device))

    def train_fn(self, storage, slots, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        slots_t, dense, label = self._to_device(slots, batch)
        storage, loss = dlrm_train_step(
            storage, self.model, slots_t, dense, label, self.lr
        )
        return storage, {"loss": loss}

    def fused_train_fn(
        self, storage, fill_slots, fill_rows, slots, batch
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """[Insert]-fill + [Train] in one forward launch (pass as
        ``ScratchPipe(..., fused_train_fn=trainer.fused_train_fn)``).
        ``fill_slots`` (numpy, sentinel-padded) and ``fill_rows`` (a tensor
        already on the device, from [Exchange])."""
        slots_t, dense, label = self._to_device(slots, batch)
        fs = torch.from_numpy(np.ascontiguousarray(fill_slots, dtype=np.int32))
        storage, loss = dlrm_fill_train_step(
            storage, self.model, fs.to(self.device), fill_rows, slots_t, dense,
            label, self.lr,
        )
        return storage, {"loss": loss}
