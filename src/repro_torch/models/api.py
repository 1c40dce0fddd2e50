"""Unified model API of the port: family dispatch, head/vocab padding at one
card, and synthetic batches.

Port of ``repro/models/api.py`` for the serving paths of every LM family
of the reference: ``hybrid`` (zamba2-1.2b), ``ssm`` (mamba2-2.7b) and the
``dense``, ``moe``, ``encoder`` and ``vlm`` transformer families, and the
training loss of every one of them (``make_loss_fn``). One card:
TP = 1, so nothing is padded and there are no mesh, specs or shardings.
``synth_batch`` draws from the same numpy generator in the same order as
the reference, so its tokens, frames and patches equal the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import hybrid, ssm_lm, transformer
from repro_torch.models.transformer import FRAME_DIM, PATCH_DIM

_FAMILY_MOD = {"hybrid": hybrid, "ssm": ssm_lm, "dense": transformer,
               "moe": transformer, "encoder": transformer, "vlm": transformer}


def family_module(cfg):
    if cfg.family not in _FAMILY_MOD:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return _FAMILY_MOD[cfg.family]


# ---------------------------------------------------------------------------
# Runtime config: pad heads/vocab to the TP width (one card: no padding)
# ---------------------------------------------------------------------------


def runtime_config(cfg: ModelConfig) -> Tuple[ModelConfig, int]:
    """Returns (cfg', vocab_pad). The reference pads num_heads and the vocab
    rows up to multiples of the TP width; at TP = 1 both stay as they are."""
    return cfg, cfg.vocab_size


def init(cfg: ModelConfig, gen: torch.Generator, device=None):
    """Random params of ``cfg`` drawn from ``gen`` (on ``device``, the
    generator's by default)."""
    rc, vp = runtime_config(cfg)
    return family_module(rc).init_params(rc, gen, vp, device)


#: the families whose training the port carries (``make_loss_fn``)
TRAINABLE = ("hybrid", "ssm", "dense", "moe", "encoder", "vlm")


def make_loss_fn(cfg: ModelConfig):
    """``loss(params, batch)`` -> the fp32 training loss of ``cfg``'s
    family: the cross entropy, plus the MoE aux loss for the ``moe``
    family."""
    rc, _ = runtime_config(cfg)
    mod = family_module(rc)

    def loss(params, batch):
        return mod.loss_fn(params, rc, batch)

    return loss


def make_prefill_fn(cfg: ModelConfig):
    rc, _ = runtime_config(cfg)
    mod = family_module(rc)

    def pre(params, batch):
        return mod.prefill(params, rc, batch)

    return pre


def make_decode_fn(cfg: ModelConfig):
    rc, _ = runtime_config(cfg)
    mod = family_module(rc)

    def dec(params, cache, tokens, pos: int):
        return mod.decode_step(params, rc, cache, tokens, pos)

    return dec


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cpu"):
    rc, _ = runtime_config(cfg)
    return family_module(rc).init_cache(rc, batch, seq_len, device)


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
