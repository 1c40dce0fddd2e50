"""The LM train step of the port.

Port of ``make_train_step`` of ``repro/launch/steps.py`` at one card:
loss and backward (``models/api.py: make_loss_fn``; on the card the flash
kernel and its backward kernel once per layer), ``clip_by_global_norm(1.0)``
and an ``AdamW`` step with fp32 master weights, in the reference's order.

Not carried over: the ``embed_offload`` train step (the embedding rows as
an activation input; no config sets ``embed_offload``), the specs and
shardings the reference returns beside the step (``opt_state_specs``,
ZeRO-1), ``make_prefill_step``/``make_serve_step`` (serving calls
``models/api.py`` directly) and ``abstract_state`` (a dry run's shapes):
one card has no mesh (ROADMAP.md Queue 1 item 19).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.optim.optimizers import tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4) -> Tuple[Callable, AdamW]:
    """Returns (train_step, opt). ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``, both fp32 0-dim tensors
    on the params' device. The update is in place (``optim/optimizers.py``):
    the returned params and state are the objects passed in, so a caller
    cannot drop a step after the fact, as the reference's supervisor drops
    a non-finite one (``nan_policy="skip"``) by keeping the old state. A
    step whose loss is not finite therefore updates nothing here: the loss
    is read on the host (one sync per step, which the supervisor makes
    anyway) before the optimizer runs."""
    opt = AdamW()
    loss_fn = api.make_loss_fn(cfg)

    def train_step(params, opt_state, batch) -> Tuple[dict, dict, Dict[str, torch.Tensor]]:
        # leaves that require grad, on the params' own storage: the in-place
        # update writes through them
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        # zeros for a leaf the loss does not read (the token embedding of a
        # frames frontend), as jax.grad gives
        grads = list(torch.autograd.grad(loss, tree_leaves(live), materialize_grads=True))
        del live
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        if bool(torch.isfinite(loss)):
            params, opt_state = opt.step(params, grads, opt_state, lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, opt
