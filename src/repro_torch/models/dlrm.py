"""DLRM (the paper's RecSys model, §V): bottom MLP over dense features,
dot-product feature interaction with the embedding bags, top MLP -> CTR
logit.

Port of ``repro/models/dlrm.py``, both execution modes:

  * ``forward_from_bags`` — the embeddings arrive as an activation
    (B, T, Dm) gathered from the scratchpad, and the runtime takes
    ``d_loss/d_bags`` back for the coalesced scatter update (``bce_loss``,
    ``interaction_dim``): the ScratchPipe path;
  * the full-table mode (``init_full``, ``full_specs``, ``gather_bags_full``)
    — the tables are model parameters, row-sharded
    over "model" of a mesh (replicated where the rows do not divide), the
    paper's "GPU-only" baseline of Table I. A rank's bag sum over its shard
    is the ``gather_reduce`` kernel (fp32, sequential in the lookups), the
    ids outside the shard masked (``full_table_ids``: -1, a zero row), and
    the partial bags summed over "model" (``parallel/collectives.py:
    sum_over_axis``: identity backward). The reference sums each lookup's
    row over "model" before the bag sum; the port sums the rank's partial
    bags, the same math in another order (bitwise the same at one model
    rank). Its SGD train step is ``launch/dryrun.py:
    dlrm_full_train_step``, which takes the loss and the bags' gradient
    from ``gather_bags_full``'s bags as the ScratchPipe step does
    (``core/dlrm_runtime.py: _mlp_step``); the reference's
    ``loss_full_tables`` is that loss, so it has no function of its own.

The reference's MLP pytree becomes :class:`DLRM`, an ``nn.Module`` with
explicit bottom and top ``nn.Linear`` stacks; the products go to
``torch.matmul`` as the reference leaves them to XLA. Initialization
follows the reference's distribution (weights normal x sqrt(2 / fan_in),
zero biases) from a ``torch.Generator``; ``jax.random`` bits cannot be
replayed, so a test that needs the reference's weights loads them with
``repro_torch.convert.mlps_from_reference``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.parallel.sharding import MeshAxes, P, shard_dim, shard_start


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
    """dense: (B, 13); bags: (B, T, Dm) reduced embedding bags. -> logit (B,).
    bf16 bags (a bf16 scratchpad's) are promoted to fp32 by the
    concatenation, as ``jnp.concatenate`` promotes them in the reference;
    their gradient comes back in bf16."""
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


# ---------------------------------------------------------------------------
# Full-table (multi-device "GPU-only") mode
# ---------------------------------------------------------------------------


def mlp_specs(cfg):
    """Specs of the MLP tree, in the reference's ``init_mlps`` layout
    (``convert.mlps_from_reference`` maps it onto :class:`DLRM`): every
    weight and bias replicated."""
    return {
        "bottom": [{"w": P(None, None), "b": P(None)} for _ in cfg.bottom_mlp],
        "top": [{"w": P(None, None), "b": P(None)} for _ in cfg.top_mlp],
    }


def init_full(cfg, gen: torch.Generator, device=None, *, mlp_seed: int = 0):
    """``{"tables": (total_rows, Dm) normal / sqrt(Dm) drawn from gen on
    device (the generator's by default), "mlps": DLRM(cfg, seed=mlp_seed)
    on device}``: the global parameters of the full-table mode."""
    device = device or gen.device
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the port's DLRM is fp32 (cfg.param_dtype)")
    tables = torch.randn((cfg.total_rows, cfg.embed_dim), generator=gen,
                         dtype=torch.float32, device=device)
    tables.div_(math.sqrt(cfg.embed_dim))
    return {"tables": tables, "mlps": DLRM(cfg, seed=mlp_seed).to(device)}


def full_specs(cfg, ax: MeshAxes):
    return {"tables": P(shard_dim(ax, cfg.total_rows, ax.model), None),
            "mlps": mlp_specs(cfg)}


def tables_sharded(cfg, mesh) -> bool:
    """True when the tables are row shards over a "model" axis wider than
    1 (its width divides the rows), else each rank holds them whole."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    tp = mesh.shape[tuple(mesh.mesh_dim_names).index("model")]
    return tp > 1 and cfg.total_rows % tp == 0


def full_table_ids(cfg, sparse_ids: torch.Tensor, tables: torch.Tensor, mesh=None):
    """sparse_ids (B, T, Lk) per-table LOCAL row ids -> (B, T, Lk) int32
    row ids into ``tables``: the global ids ``cfg.table_offsets[t] + id``
    (heterogeneous table sizes supported); on a row shard, less the
    shard's first row, and -1 (masked) outside the shard."""
    offs = torch.tensor(cfg.table_offsets, dtype=torch.int64, device=sparse_ids.device)
    flat = sparse_ids.long() + offs[None, :, None]
    if tables_sharded(cfg, mesh):
        rows_local = tables.shape[0]
        loc = flat - shard_start(mesh, rows_local)
        flat = torch.where((loc >= 0) & (loc < rows_local), loc, torch.full_like(loc, -1))
    return flat.to(torch.int32)


def gather_bags_full(tables, cfg, sparse_ids, mesh=None) -> torch.Tensor:
    """sparse_ids (B, T, Lk) per-table LOCAL row ids -> (B, T, Dm) fp32
    bags: the sum of the Lk looked-up rows (the paper's reduction) by the
    ``gather_reduce`` kernel on the card (its plain version on the CPU);
    on a row shard, the rank's partial bags summed over "model"."""
    from repro_torch.parallel.collectives import sum_over_axis

    bags = ops.gather_reduce(tables, full_table_ids(cfg, sparse_ids, tables, mesh))
    if tables_sharded(cfg, mesh):
        bags = sum_over_axis(bags, mesh, "model")
    return bags

