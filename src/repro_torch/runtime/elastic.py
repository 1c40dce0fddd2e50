"""Elastic scaling: resume a job on a different device count / mesh shape.

Port of ``repro/runtime/elastic.py``. Checkpoints store *global* arrays
(``checkpoint/manager.py``), so elasticity is: build the new mesh,
recompute the specs from the same rules, and hand each rank its slice of
the restored arrays (``parallel/sharding.py: local_shard``). The
ScratchPipe planner/host-table state is device-count independent (host
state). The data stream fast-forwards deterministically. The reference's
``with_opt_state_like`` restores the optimizer state replicated; here the
caller restores it with ``CheckpointManager.restore`` and cuts it by
``launch/steps.py: opt_state_specs`` the same way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import api
from repro_torch.parallel.sharding import mesh_axes, tree_local_shards, tree_map_specs


def reshard_restore(ckpt, cfg, new_mesh, *, step: Optional[int] = None,
                    device=None, coords=None) -> Tuple[object, int]:
    """Restore the model params of ``cfg`` (padded for ``new_mesh``) from
    ``ckpt`` (a ``CheckpointManager`` whose state is the global params
    tree) and return (this rank's shard of each, by the new mesh's specs,
    on ``device`` (the CPU by default), the step). The mesh used at save
    time is irrelevant. ``coords`` overrides the rank's mesh coordinates
    (an abstract mesh has none)."""
    ax = mesh_axes(new_mesh)
    specs = api.param_specs(cfg, ax)
    abstract = api.abstract_params(cfg, ax)
    # a zero-size leaf of the right dtype: the restore reads dtype and device
    target = tree_map_specs(lambda s, a: torch.empty(0, dtype=a.dtype), specs, abstract)
    state, step = ckpt.restore(target, step=step)

    def check(s, got, want):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {tuple(got.shape)} != {tuple(want.shape)}")
        return got

    tree_map_specs(check, specs, state, abstract)
    local = tree_local_shards(state, specs, new_mesh, coords)
    return tree_map_specs(lambda s, t: t.to(device or "cpu").contiguous(), specs, local), step
