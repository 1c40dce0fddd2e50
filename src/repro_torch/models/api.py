"""Unified model API of the port: family dispatch, head/vocab padding to
the TP width, specs and abstract (``meta``) trees for the dry run, and
synthetic batches.

Port of ``repro/models/api.py`` for every LM family of the reference:
``hybrid`` (zamba2-1.2b), ``ssm`` (mamba2-2.7b) and the ``dense``, ``moe``,
``encoder`` and ``vlm`` transformer families: serving, the training loss
(``make_loss_fn``), and the mesh half: :func:`runtime_config` with the
reference's TP padding (``ax=None`` is one card: nothing padded),
:func:`param_specs`, :func:`local_params`, :func:`abstract_params` (tensors on the ``meta``
device: shapes and dtypes, no storage), :func:`cache_specs`,
:func:`abstract_cache`, :func:`batch_specs` / :func:`batch_shardings` and
:func:`abstract_batch`. Specs follow the port's trees (per-layer lists
where the reference stacks; ``convert.specs_to_reference`` restacks them).
The training loss, prefill and decode of every family also run
partitioned over a mesh (``make_loss_fn(cfg, mesh)``,
``make_prefill_fn(cfg, mesh)``, ``make_decode_fn(cfg, mesh)``): each rank
holds its shards of the params and its share of the decode cache under
the reference's specs. ``synth_batch``
draws from the same numpy generator in the same order as the reference,
so its tokens, frames and patches equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import hybrid, ssm_lm, transformer
from repro_torch.models.transformer import FRAME_DIM, PATCH_DIM
from repro_torch.parallel.sharding import (MeshAxes, P, dp_axis, local_shard, mesh_axes, named,
                                           shard_dim, tree_map_specs)

_FAMILY_MOD = {"hybrid": hybrid, "ssm": ssm_lm, "dense": transformer,
               "moe": transformer, "encoder": transformer, "vlm": transformer}


def family_module(cfg):
    if cfg.family not in _FAMILY_MOD:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return _FAMILY_MOD[cfg.family]


# ---------------------------------------------------------------------------
# Runtime config: pad heads/vocab to the TP width
# ---------------------------------------------------------------------------


def runtime_config(cfg: ModelConfig, ax: Optional[MeshAxes] = None) -> Tuple[ModelConfig, int]:
    """Returns (cfg', vocab_pad). Pads num_heads up to a multiple of the TP
    width (llama4-scout / qwen2.5: 40 -> 48 at TP=16 — real extra compute)
    and the vocab row count. ``ax=None`` is TP = 1: both stay as they
    are, and ``cfg`` comes back as the same object."""
    tp = ax.model_size if ax else 1
    H = cfg.num_heads
    if H and H % tp:
        H = -(-H // tp) * tp
        if cfg.num_kv_heads and H % cfg.num_kv_heads:
            H = -(-H // cfg.num_kv_heads) * cfg.num_kv_heads
    vocab_pad = -(-cfg.vocab_size // tp) * tp
    if H != cfg.num_heads:
        cfg = dataclasses.replace(cfg, num_heads=H)
    return cfg, vocab_pad


def init(cfg: ModelConfig, gen: torch.Generator, device=None, ax: Optional[MeshAxes] = None):
    """Random params of ``cfg`` (padded for ``ax``) drawn from ``gen`` (on
    ``device``, the generator's by default)."""
    rc, vp = runtime_config(cfg, ax)
    return family_module(rc).init_params(rc, gen, vp, device)


def abstract_params(cfg: ModelConfig, ax: Optional[MeshAxes] = None):
    """The global params of ``cfg`` padded for ``ax`` as ``meta`` tensors:
    the shapes and dtypes the dry run reads, nothing allocated."""
    rc, vp = runtime_config(cfg, ax)
    gen = torch.Generator(device="cpu")
    return family_module(rc).init_params(rc, gen, vp, torch.device("meta"))


def param_specs(cfg: ModelConfig, ax: MeshAxes):
    rc, vp = runtime_config(cfg, ax)
    return family_module(rc).param_specs(rc, ax, vp)


def local_params(params, cfg: ModelConfig, mesh, without: Tuple[str, ...] = ()):
    """This rank's shards of the global ``params`` (padded for ``mesh``)
    under :func:`param_specs`: a shard that is the whole leaf is the leaf
    itself, a part is copied (so the global tree can be freed). ``without``
    names the top-level params the tree leaves out (``"embed"`` for
    ``CachedEmbeddingLM``, whose host table holds it); any other missing
    param raises."""
    def own(spec, t):
        s = local_shard(t, spec, mesh)
        return t if s.shape == t.shape else s.clone()

    specs = param_specs(cfg, mesh_axes(mesh))
    return tree_map_specs(own, {k: v for k, v in specs.items() if k not in without}, params)


#: the families whose training the port carries (``make_loss_fn``), at one
#: card and partitioned over a mesh
TRAINABLE = ("hybrid", "ssm", "dense", "moe", "encoder", "vlm")


def make_loss_fn(cfg: ModelConfig, mesh=None):
    """``loss(params, batch)`` -> the fp32 training loss of ``cfg``'s
    family: the cross entropy, plus the MoE aux loss for the ``moe``
    family. With a ``mesh`` (a ``DeviceMesh``), the model is ``cfg``
    padded for it (:func:`runtime_config`), ``params`` this rank's shards
    under :func:`param_specs` and ``batch`` its data shard; the loss is the
    whole batch's, on every rank (``transformer.xent_loss``)."""
    if mesh is None:
        rc, _ = runtime_config(cfg)
        mod = family_module(rc)

        def loss(params, batch):
            return mod.loss_fn(params, rc, batch)

        return loss
    ax = mesh_axes(mesh)
    rc, vp = runtime_config(cfg, ax)
    mod, specs = family_module(rc), family_module(rc).param_specs(rc, ax, vp)

    def loss_mesh(params, batch):
        return mod.loss_fn(params, rc, batch, mesh, specs)

    return loss_mesh


def _mesh_model(cfg: ModelConfig, mesh):
    """(the family module, ``cfg`` padded for ``mesh``, its param specs or
    None at one card)."""
    if mesh is None:
        rc, _ = runtime_config(cfg)
        return family_module(rc), rc, None
    ax = mesh_axes(mesh)
    rc, vp = runtime_config(cfg, ax)
    return family_module(rc), rc, family_module(rc).param_specs(rc, ax, vp)


def make_prefill_fn(cfg: ModelConfig, mesh=None):
    """``pre(params, batch)`` -> (last-position logits (B, Vpad) fp32, the
    decode cache). With a ``mesh`` (a ``DeviceMesh``), the model is ``cfg``
    padded for it (:func:`runtime_config`), ``params`` this rank's shards
    under :func:`param_specs`, ``batch`` its data shard; the cache comes
    back as this rank's share under :func:`cache_specs` at the prompt's
    length, the logits as the rank's data shard, whole over the vocab."""
    mod, rc, specs = _mesh_model(cfg, mesh)

    def pre(params, batch):
        return mod.prefill(params, rc, batch, mesh, specs)

    return pre


def make_decode_fn(cfg: ModelConfig, mesh=None, kv_slots: Optional[int] = None):
    """``dec(params, cache, tokens, pos)`` -> (next tokens (B, 1) int32,
    the cache, updated in place). With a ``mesh``, as
    :func:`make_prefill_fn`; the cache is this rank's share under
    :func:`cache_specs` at ``kv_slots`` positions, the KV cache's global
    slot count (the prefill's, as ``launch/serve.py: fit_kv_cache`` grows
    it), needed where the cache shards over the sequence."""
    mod, rc, specs = _mesh_model(cfg, mesh)

    def dec(params, cache, tokens, pos: int):
        if mesh is None:
            return mod.decode_step(params, rc, cache, tokens, pos)
        return mod.decode_step(params, rc, cache, tokens, pos, mesh, specs, kv_slots)

    return dec


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cpu",
               ax: Optional[MeshAxes] = None):
    rc, _ = runtime_config(cfg, ax)
    return family_module(rc).init_cache(rc, batch, seq_len, device)


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int, ax: Optional[MeshAxes] = None):
    """The decode cache as ``meta`` tensors."""
    return init_cache(cfg, batch, seq_len, torch.device("meta"), ax)


def cache_specs(cfg: ModelConfig, ax: MeshAxes, batch: int, seq_len: int):
    rc, _ = runtime_config(cfg, ax)
    return family_module(rc).cache_spec(rc, ax, batch, seq_len)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_structure(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Tuple]:
    """name -> (shape, dtype) for the *train/prefill* inputs of this arch:
    tokens, or the ``frames`` frontend's frame embeddings, or the
    ``patches`` frontend's ``frontend_positions`` patch embeddings plus the
    remaining S - P tokens (and labels to train). The reference's offloaded
    embedding (``embed_offload``) has no config in the port."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "frames":
        d = {"frames": ((B, S, FRAME_DIM), cfg.compute_dtype)}
        if shape.kind == "train":
            d["labels"] = ((B, S), "int32")
        return d
    if cfg.frontend == "patches":
        Pn = cfg.frontend_positions
        d = {"patches": ((B, Pn, PATCH_DIM), cfg.compute_dtype),
             "tokens": ((B, S - Pn), "int32")}
        if shape.kind == "train":
            d["labels"] = ((B, S - Pn), "int32")
        return d
    d = {"tokens": ((B, S), "int32")}
    if shape.kind == "train":
        d["labels"] = ((B, S), "int32")
    return d


def synth_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, device="cpu"):
    """The reference's synthetic batch, drawn from the same numpy generator
    in the same order (integers for int32 inputs, standard normals cast
    from fp32 for the frontends' embeddings), as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dt) in batch_structure(cfg, shape).items():
        if dt == "int32":
            a = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shp, dtype=np.int32))
        else:
            a = torch.from_numpy(rng.standard_normal(shp).astype(np.float32)).to(
                getattr(torch, dt))
        out[name] = a.to(device)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, ax: MeshAxes) -> Dict[str, P]:
    """Each input's spec: its batch dim over the data axes where it
    divides, the rest replicated."""
    out = {}
    for name, (shp, _) in batch_structure(cfg, shape).items():
        b_ax = shard_dim(ax, shp[0], dp_axis(ax))
        out[name] = P(b_ax, *([None] * (len(shp) - 1)))
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """:func:`batch_specs` as DTensor placements on ``mesh``."""
    return {k: named(mesh, s) for k, s in batch_specs(cfg, shape, mesh_axes(mesh)).items()}


def abstract_batch(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The global train/prefill inputs as ``meta`` tensors."""
    return {name: torch.empty(shp, dtype=getattr(torch, dt), device="meta")
            for name, (shp, dt) in batch_structure(cfg, shape).items()}
