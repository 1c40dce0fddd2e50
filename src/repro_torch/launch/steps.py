"""The LM train step of the port, and the specs of every step.

Port of ``repro/launch/steps.py``:

  * ``make_train_step`` at one card, for every LM family: loss and backward
    (``models/api.py: make_loss_fn``; on the card the flash kernel and its
    backward kernel once per attention layer or shared-block application,
    the SSD kernel and its backward kernel once per mamba layer),
    ``clip_by_global_norm(1.0)`` and an ``AdamW`` step with fp32 master
    weights, in the reference's order; and for every family partitioned
    over a mesh (``mesh=``): tensor-parallel attention, MLP and experts,
    mamba layers over d_inner and the SSD heads, the hybrid's shared block,
    the vocab-sharded embedding and cross entropy, FSDP, the ZeRO-1 AdamW
    state (a layer list split over either of the hybrid's two stacked dims)
    — the reference's GSPMD step, its collectives explicit;
  * ``make_prefill_step`` and ``make_serve_step``: prefill and decode over
    a mesh (every family that decodes), each rank holding its param shards
    and its share of the decode cache, beside the specs they follow;
  * the spec half: ``opt_state_specs`` (ZeRO-1: the AdamW state sharded
    over the data axes on its first free dim, always: the reference's
    ``cfg.zero1`` is True in every config),
    ``train_step_specs`` (the specs the reference's ``make_train_step``
    returns beside the step), ``abstract_state`` / ``abstract_cache``
    (``meta`` tensors: the dry run's shapes).

Not carried over:
the ``embed_offload`` train step (the embedding rows as an activation
input; no config sets ``embed_offload``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import api
from repro_torch.optim import AdamW, clip_by_global_norm
from repro_torch.optim.optimizers import Zero1, tree_leaves, tree_map
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (P, mesh_axes, spec_leaves,
                                           tree_map_specs, zero1_spec)


#: the param trees' layer lists and how many stacked dims each stands for
_STACKED = {"layers": 1, "tail": 1, "groups": 2}


def opt_state_specs(cfg: ModelConfig, ax, params_abs, pspecs):
    """AdamW state specs: m/v/master follow the param spec, plus ZeRO-1
    sharding over the data axes (always). A leaf of a layer list is
    given the rule as the reference's stacked leaf: its shape with the
    stacked dims in front, so the rule may pick the layer dim (the spec's
    ``lead``)."""

    def per_leaf(spec, leaf, counts=()):
        n = len(counts)
        z = zero1_spec(P(*((None,) * n + tuple(spec))), tuple(counts) + tuple(leaf.shape), ax)
        return P(*z[n:], lead=z[:n])

    def stacked(sub, abs_sub, n):
        counts = []
        s_, a_ = sub, abs_sub
        for _ in range(n):
            counts.append(len(s_))
            s_, a_ = s_[0], a_[0]
        return _nest(sub, abs_sub, n, lambda sp, lf: per_leaf(sp, lf, counts))

    like = {k: (stacked(v, params_abs[k], _STACKED[k]) if k in _STACKED
                else tree_map_specs(per_leaf, v, params_abs[k]))
            for k, v in pspecs.items()}
    return {"m": like, "v": like, "t": P(), "master": like}


def _nest(specs, leaves, n, fn):
    if n == 0:
        return tree_map_specs(fn, specs, leaves)
    return [_nest(s, a, n - 1, fn) for s, a in zip(specs, leaves)]


def train_step_specs(cfg: ModelConfig, mesh) -> dict:
    """{"params", "opt"}: the specs the reference's ``make_train_step``
    returns beside its step, for ``mesh`` (a ``DeviceMesh`` or an
    ``AbstractMesh``)."""
    ax = mesh_axes(mesh)
    pspecs = api.param_specs(cfg, ax)
    return {"params": pspecs,
            "opt": opt_state_specs(cfg, ax, api.abstract_params(cfg, ax), pspecs)}


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, mesh=None) -> Tuple[Callable, AdamW]:
    """Returns (train_step, opt). ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})``, both fp32 0-dim tensors
    on the params' device. The update is in place (``optim/optimizers.py``):
    the returned params and state are the objects passed in, so a caller
    cannot drop a step after the fact, as the reference's supervisor drops
    a non-finite one (``nan_policy="skip"``) by keeping the old state. A
    step whose loss is not finite therefore updates nothing here: the loss
    is read on the host (one sync per step, which the supervisor makes
    anyway) before the optimizer runs. A ``meta`` loss (the dry run's
    abstract rank, ``launch/dryrun.py``) has no value to read: its step
    runs the optimizer.

    With a ``mesh`` (a ``DeviceMesh`` ("data", "model") or ("pod", "data",
    "model"); every family) the model is
    ``cfg`` padded for the mesh (``models/api.py: runtime_config``), the
    params are this rank's shards under :func:`train_step_specs`' param
    specs, ``opt.init`` gives this rank's ZeRO-1 state, and ``batch`` is
    its data shard. The loss is the whole batch's mean (over the mask
    count of the whole batch); the gradients of leaves replicated over the
    data axes are summed there (FSDP leaves arrive reduce-scattered); the
    clip is by the norm of the whole gradient; AdamW updates this rank's
    ZeRO-1 part and all-gathers the new params. The loss, and so the
    decision to skip a non-finite step, is the same on every rank."""
    if mesh is None:
        opt = AdamW()
        loss_fn = api.make_loss_fn(cfg)
        specs = None
    else:
        loss_fn = api.make_loss_fn(cfg, mesh)
        sp = train_step_specs(cfg, mesh)
        opt = AdamW(zero1=Zero1(mesh, sp["params"], sp["opt"]["m"]))
        specs = spec_leaves(sp["params"])

    def train_step(params, opt_state, batch) -> Tuple[dict, dict, Dict[str, torch.Tensor]]:
        # leaves that require grad, on the params' own storage: the in-place
        # update writes through them
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        # zeros for a leaf the loss does not read (the token embedding of a
        # frames frontend), as jax.grad gives
        grads = list(torch.autograd.grad(loss, tree_leaves(live), materialize_grads=True))
        del live
        if mesh is None:
            grads, gnorm = clip_by_global_norm(grads, 1.0)
        else:
            C.sum_tree_over_data(grads, specs, mesh)
            grads, gnorm = clip_by_global_norm(grads, 1.0, specs, mesh)
        if loss.device.type == "meta" or bool(torch.isfinite(loss)):
            params, opt_state = opt.step(params, grads, opt_state, lr)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step, opt


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec):
    """(prefill fn, {"params", "cache"} specs for ``mesh`` at ``shape``):
    the fn takes this rank's param shards and data shard of a prompt batch
    of ``shape`` and returns its share of the cache under the specs
    returned (``models/api.py: make_prefill_fn(cfg, mesh)``)."""
    ax = mesh_axes(mesh)
    return api.make_prefill_fn(cfg, mesh), {
        "params": api.param_specs(cfg, ax),
        "cache": api.cache_specs(cfg, ax, shape.global_batch, shape.seq_len)}


def make_serve_step(cfg: ModelConfig, mesh, shape: ShapeSpec):
    """(decode fn, {"params", "cache"} specs for ``mesh`` at ``shape``):
    the fn decodes one token against this rank's share of a cache laid out
    for ``shape.seq_len`` positions under the specs returned
    (``models/api.py: make_decode_fn(cfg, mesh, shape.seq_len)``)."""
    ax = mesh_axes(mesh)
    return api.make_decode_fn(cfg, mesh, shape.seq_len), {
        "params": api.param_specs(cfg, ax),
        "cache": api.cache_specs(cfg, ax, shape.global_batch, shape.seq_len)}


def abstract_state(cfg: ModelConfig, mesh, opt: AdamW = None):
    """The global params (padded for ``mesh``) as ``meta`` tensors, and with
    ``opt`` its state too: ``params`` or ``(params, opt_state)``."""
    params = api.abstract_params(cfg, mesh_axes(mesh))
    if opt is None:
        return params
    return params, opt.init(params)


def abstract_cache(cfg: ModelConfig, mesh, shape: ShapeSpec):
    """The global decode cache at ``shape`` as ``meta`` tensors."""
    return api.abstract_cache(cfg, shape.global_batch, shape.seq_len, mesh_axes(mesh))
