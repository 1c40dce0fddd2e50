"""DLRM (the paper's RecSys model, §V): bottom MLP over dense features,
dot-product feature interaction with the embedding bags, top MLP -> CTR
logit.

Port of the bags-as-input mode of ``repro/models/dlrm.py``
(``forward_from_bags``, ``bce_loss``, ``interaction_dim``): the embeddings
arrive as an activation (B, T, Dm) gathered from the scratchpad, and the
runtime takes ``d_loss/d_bags`` back for the coalesced scatter update. The
reference's MLP pytree becomes :class:`DLRM`, an ``nn.Module`` with explicit
bottom and top ``nn.Linear`` stacks; the products go to ``torch.matmul``
as the reference leaves them to XLA. Initialization follows the
reference's distribution (weights normal x sqrt(2 / fan_in), zero biases)
from a ``torch.Generator``; ``jax.random`` bits cannot be replayed, so a
test that needs the reference's weights loads them with
``repro_torch.convert.mlps_from_reference``. The full-table ("GPU-only")
mode comes with the sharded slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def interaction_dim(cfg) -> int:
    n = cfg.num_tables + 1
    return n * (n - 1) // 2 + cfg.bottom_mlp[-1]


def _linear_stack(dims: Sequence[int], gen: torch.Generator) -> nn.ModuleList:
    layers = nn.ModuleList()
    for a, b in zip(dims[:-1], dims[1:]):
        lin = nn.Linear(a, b)
        with torch.no_grad():
            w = torch.randn((a, b), generator=gen, dtype=torch.float32) * math.sqrt(2.0 / a)
            lin.weight.copy_(w.t())  # nn.Linear keeps (out, in)
            lin.bias.zero_()
        layers.append(lin)
    return layers


def _mlp(layers: nn.ModuleList, x: torch.Tensor, final_linear: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, lin in enumerate(layers):
        x = lin(x)
        if not (final_linear and i == n - 1):
            x = torch.relu(x)
    return x


class DLRM(nn.Module):
    """The dense half of the DLRM: ``bottom`` and ``top`` ``nn.Linear``
    stacks (fp32). Layer i of the reference's ``mlps["bottom"|"top"]``
    (``w`` (in, out), ``b`` (out,)) is ``bottom[i]``/``top[i]`` here
    (``weight`` = ``w.T``)."""

    def __init__(self, cfg, *, seed: int = 0):
        super().__init__()
        if getattr(cfg, "param_dtype", "float32") != "float32":
            raise NotImplementedError("the port's DLRM is fp32 (cfg.param_dtype)")
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        self.bottom = _linear_stack(
            (cfg.num_dense_features,) + tuple(cfg.bottom_mlp), gen
        )
        self.top = _linear_stack((interaction_dim(cfg),) + tuple(cfg.top_mlp), gen)
        n = cfg.num_tables + 1
        iu, ju = torch.triu_indices(n, n, offset=1)  # jnp.triu_indices order
        self.register_buffer("_iu", iu, persistent=False)
        self.register_buffer("_ju", ju, persistent=False)

    def forward(self, dense: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
        return forward_from_bags(self, dense, bags)


def forward_from_bags(model: DLRM, dense: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
    """dense: (B, 13); bags: (B, T, Dm) reduced embedding bags. -> logit (B,)."""
    b = _mlp(model.bottom, dense)  # (B, Dm)
    feats = torch.cat([b[:, None, :], bags], dim=1)  # (B, T+1, Dm)
    inter = torch.bmm(feats, feats.transpose(1, 2))  # (B, T+1, T+1)
    flat = inter[:, model._iu, model._ju]  # (B, n(n-1)/2)
    z = torch.cat([b, flat], dim=-1)
    return _mlp(model.top, z, final_linear=True)[:, 0]


def bce_loss(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    logit = logit.float()
    label = label.float()
    return torch.mean(
        torch.clamp_min(logit, 0.0) - logit * label
        + torch.log1p(torch.exp(-torch.abs(logit)))
    )
