"""DLRM [Train] stage: the fwd+bwd+update computation shared by ScratchPipe
AND both baselines (identical math; only row placement differs).

Port of ``repro/core/dlrm_runtime.py``. The embedding rows
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

A bf16 scratchpad (``ScratchPipe(storage_dtype=torch.bfloat16)``) runs the
fp32 steps as they are: the gather gives bf16 bags, which the MLP's
concatenation promotes to fp32 (as ``jnp.concatenate`` does in the
reference), so their gradient comes back bf16 and ``apply_grad`` rounds
``-lr`` to bf16 before the product, as jnp's weakly typed ``lr`` is
(``kernels/ref.py: scatter_deltas``).

At fp16/int8 replica precision the ``*_q`` steps run instead: the gather
dequantizes in the kernel (fp32 bags into the same loss) and the update
re-quantizes only the touched rows (``scratchpad.apply_grad_q``). The MLP
math is the fp32 step's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.device import resolve_device
from repro_torch.models import dlrm


def _mlp_step(model: dlrm.DLRM, dense, bags, label, lr: float, sync=None):
    """Loss, its gradient w.r.t. the bags, and the SGD update of the MLP
    parameters (``p - lr * g``, as the reference). ``sync`` (the mesh step's
    average over the data ranks) maps the list of MLP gradients before the
    update."""
    bags = bags.detach().requires_grad_(True)
    params = list(model.parameters())
    with torch.enable_grad():
        loss = dlrm.bce_loss(dlrm.forward_from_bags(model, dense, bags), label)
        grads = torch.autograd.grad(loss, [bags] + params)
    g_params = grads[1:] if sync is None else sync(list(grads[1:]))
    with torch.no_grad():
        for p, g in zip(params, g_params):
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


def dlrm_train_step_q(storage, model, slots, dense, label, lr: float,
                      generator=None, rounding: str = "stochastic"):
    """Reduced-precision twin of :func:`dlrm_train_step`: dequantizing
    gather, the same MLP step, and the re-quantizing update of the touched
    rows (in place; ``generator`` draws the stochastic-rounding noise and
    must be per-step). -> (storage, loss)."""
    bags = sp.gather_reduce_q(storage, slots)
    loss, g_bags = _mlp_step(model, dense, bags, label, lr)
    storage = sp.apply_grad_q(storage, slots, g_bags, lr, generator, rounding=rounding)
    return storage, loss


def dlrm_fill_train_step_q(
    storage, model, fill_slots, fill_rows, slots, dense, label, lr: float,
    generator=None, rounding: str = "stochastic",
):
    """Fused quantized cycle: the host-quantized ``fill_rows`` land first
    (for int8 the scale column is scattered before the payload kernel, so
    gathers of just-filled rows are coherent), then the dequantizing gather
    — ONE kernel launch on the card — the loss and the re-quantizing
    update. -> (storage, loss)."""
    storage, bags = sp.fill_gather_reduce_q(storage, fill_slots, fill_rows, slots)
    loss, g_bags = _mlp_step(model, dense, bags, label, lr)
    storage = sp.apply_grad_q(storage, slots, g_bags, lr, generator, rounding=rounding)
    return storage, loss


class DLRMTrainer:
    """Holds the dense (MLP) parameters; exposes ``train_fn(storage, slots,
    batch)`` for the cache runtimes. The batch's ``dense`` and ``label``
    arrive as numpy arrays (from the stream) and are copied to ``device``;
    so are ``slots`` from the host planner, while the device planner's
    (int32, on ``device``) are taken as they are; ``storage`` already lies
    there.
    ``precision``/``rounding`` default to the config's fields, else
    "fp32"/"stochastic". With a reduced precision the trainer routes
    through the ``*_q`` steps and re-seeds one generator on ``device`` per
    step from ``(seed, step)`` — the reference folds the step into its key
    the same way — so a split and a fused run draw the same noise at the
    same step. The step counter advances on each ``train_fn`` or
    ``fused_train_fn`` call of a reduced-precision trainer."""

    def __init__(self, cfg, seed: int = 0, lr: float = 0.05, *,
                 precision: str = None, rounding: str = None, device="cuda"):
        self.cfg = cfg
        self.lr = lr
        self.precision = qz.check_precision(
            precision if precision is not None else getattr(cfg, "precision", "fp32")
        )
        self.rounding = qz.check_rounding(
            rounding if rounding is not None
            else getattr(cfg, "rounding", "stochastic")
        )
        self.device = resolve_device(device)
        self.model = dlrm.DLRM(cfg, seed=seed).to(self.device)
        self.seed = int(seed)
        self._step = 0
        self._gen = torch.Generator(device=self.device)

    def _next_generator(self) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, 0x5EED, self._step])
        self._gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
        self._step += 1
        return self._gen

    def _to_device(self, slots, batch):
        # the device planner's slots already lie on the card: taken as they are
        if isinstance(slots, torch.Tensor):
            slots_t = slots
        else:
            slots_t = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32))
        dense = torch.from_numpy(np.ascontiguousarray(batch["dense"], dtype=np.float32))
        label = torch.from_numpy(np.ascontiguousarray(batch["label"], dtype=np.float32))
        return (slots_t.to(self.device), dense.to(self.device),
                label.to(self.device))

    def train_fn(self, storage, slots, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        slots_t, dense, label = self._to_device(slots, batch)
        if self.precision != "fp32":
            storage, loss = dlrm_train_step_q(
                storage, self.model, slots_t, dense, label, self.lr,
                self._next_generator(), self.rounding,
            )
        else:
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
        already on the device, from [Exchange]; an int8 ``(payload,
        scale)`` pair of tensors at int8 precision)."""
        slots_t, dense, label = self._to_device(slots, batch)
        fs = torch.from_numpy(np.ascontiguousarray(fill_slots, dtype=np.int32))
        fs = fs.to(self.device)
        if self.precision != "fp32":
            storage, loss = dlrm_fill_train_step_q(
                storage, self.model, fs, fill_rows, slots_t, dense, label,
                self.lr, self._next_generator(), self.rounding,
            )
        else:
            storage, loss = dlrm_fill_train_step(
                storage, self.model, fs, fill_rows, slots_t, dense, label, self.lr,
            )
        return storage, {"loss": loss}
