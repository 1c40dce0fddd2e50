"""Dry run of the port: for every (arch x input-shape x mesh) cell, what one
device of the production mesh holds and what the step computes, without
allocating; and the DLRM full-table train step it lowers.

Port of ``repro/launch/dryrun.py``:

    python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] \\
        [--include-dlrm] [--out DIR]

Results: ``<out>/<arch>__<shape>__<mesh>.json`` (default ``build/dryrun/``,
git-ignored). Each cell records:

  * ``arg_bytes_per_device`` — the bytes of one device's arguments of the
    cell's step, by group (params; the AdamW state with ZeRO-1 for a train
    cell; the decode cache and the token ids and position for a decode
    cell; the batch), from the specs (``models/api.py``,
    ``launch/steps.py``) and the ``meta`` shapes: each leaf's bytes over
    the product of the mesh axes its spec names;
  * ``flops`` — the step's floating-point operations at the padded global
    shapes, from ``torch.utils.flop_counter.FlopCounterMode`` over the step
    on ``meta`` tensors (the hand-written kernels' wrappers send ``meta``
    tensors to their plain versions: ``kernels/ops.py``), and
    ``flops_per_device`` (an even split, computed);
  * ``fits_card`` — whether one device's arguments fit one 80 GB card.

Every number is computed, not measured. The reference's ``temp`` and
``peak`` bytes and its collective schedule come from XLA's SPMD compile of
the partitioned step; the port's partitioned LM steps run
(``launch/steps.py: make_train_step(mesh=)``, ``make_prefill_step``,
``make_serve_step``), and the measured temp and peak bytes of each wait
(ROADMAP.md Queue 1 item 24).

:func:`dlrm_full_train_step` is the reference's ``_lower_dlrm`` train step
as a function the port runs: the reference's ``loss_full_tables``, then
SGD at lr 0.05 (by default), over a (data, model) mesh or none.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import SHAPES_BY_NAME, dryrun_cells, get_entry
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api, dlrm
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.parallel.sharding import (
    P,
    dp_axis,
    mesh_axes,
    shard_dim,
    is_spec,
    shard_factor,
)

RESULTS_DIR = os.path.join("build", "dryrun")
#: one card's memory: the H100 SXM's 80 GB
CARD_BYTES = 80 * 10**9


# ---------------------------------------------------------------------------
# the DLRM full-table train step
# ---------------------------------------------------------------------------


def dlrm_full_train_step(params, cfg, batch, mesh=None, lr: float = 0.05):
    """One SGD step of the full-table DLRM. ``params`` = {"tables": this
    rank's row shard (the whole tables at one model rank), "mlps": a
    ``DLRM``}; ``batch`` = this rank's data shard of {"dense", "label",
    "sparse_ids" (B, T, Lk) per-table local ids, int32}. Updates the
    tables and the MLP in place and returns (params, the loss: the mean
    over the global batch).

    The step is ``core/dlrm_runtime.py``'s (at world 1 it is
    ``dlrm_train_step`` with the global row ids as slots): the bags by the
    ``gather_reduce`` kernel (``models/dlrm.py: gather_bags_full``), the
    MLP step of ``dlrm_runtime._mlp_step``, and the table update of
    ``scratchpad.apply_grad``: the delta ``-lr * g_bag`` rounded once per
    bag, the duplicates added in flat bag-major order by the
    ``scatter_add`` kernel in place — no dense (V, D) gradient is formed.
    Over "model" the partial bags are summed and each rank updates only its
    shard's rows (the kernel drops the masked ids). Over the data axes the
    MLP gradients are averaged, and every rank all-gathers the ids and the
    per-bag gradients in rank order and applies all of them, so every data
    replica holds the same table bits."""
    from repro_torch.core import dlrm_runtime
    from repro_torch.core import scratchpad as sp
    from repro_torch.parallel import collectives as C

    tables, model = params["tables"], params["mlps"]
    bags = dlrm.gather_bags_full(tables, cfg, batch["sparse_ids"], mesh)
    ids = dlrm.full_table_ids(cfg, batch["sparse_ids"], tables, mesh)
    dp = 1 if mesh is None else C.data_size(mesh)
    sync = None
    if dp > 1:
        def sync(grads):
            return [C.mean_over_data(g, mesh) for g in grads]
    loss, g_bags = dlrm_runtime._mlp_step(model, batch["dense"], bags, batch["label"],
                                          lr, sync=sync)
    if dp > 1:
        g_bags = g_bags / dp  # the gradient of the global batch's mean
        ids, g_bags = C.gather_over_data(ids, mesh), C.gather_over_data(g_bags, mesh)
        loss = C.mean_over_data(loss, mesh)
    sp.apply_grad(tables, ids, g_bags, lr)
    return params, loss


# ---------------------------------------------------------------------------
# per-device argument bytes
# ---------------------------------------------------------------------------


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: the layer lists of the LM trees, each the reference's stacked leaf
_STACKED = ("layers", "groups", "tail")


def tree_bytes_per_device(specs, tensors, ax) -> int:
    """Sum over the leaves of their bytes over the product of the mesh axes
    their spec names, as the reference sums its stacked leaves: the layers
    of a layer list are one leaf (ZeRO-1 may split the list over the data
    axes, ``P.lead``), whose bytes are divided once."""
    groups = {}

    def walk(sp, t, path, merge):
        if is_spec(sp):
            f, b = groups.get(path, (shard_factor(sp, ax), 0))
            groups[path] = (f, b + _bytes(t))
        elif isinstance(sp, dict):
            for k in sp:
                walk(sp[k], t[k], path + (k,), merge or k in _STACKED)
        else:
            for i, (a, b) in enumerate(zip(sp, t)):
                walk(a, b, path if merge else path + (i,), merge)

    walk(specs, tensors, (), False)
    return sum(b // f for f, b in groups.values())


def dlrm_abstract_params(cfg):
    """The full-table params as ``meta`` tensors, in the reference's tree
    layout (``mlps``: {"bottom"|"top": [{"w" (in, out), "b"}]})."""
    def mlp(dims):
        return [{"w": torch.empty((a, b), device="meta"), "b": torch.empty((b,), device="meta")}
                for a, b in zip(dims[:-1], dims[1:])]

    return {"tables": torch.empty((cfg.total_rows, cfg.embed_dim), device="meta"),
            "mlps": {"bottom": mlp((cfg.num_dense_features,) + tuple(cfg.bottom_mlp)),
                     "top": mlp((dlrm.interaction_dim(cfg),) + tuple(cfg.top_mlp))}}


def dlrm_abstract_batch(cfg, shape: ShapeSpec):
    B, T, L = shape.global_batch, cfg.num_tables, cfg.lookups_per_table
    return {"dense": torch.empty((B, cfg.num_dense_features), device="meta"),
            "label": torch.empty((B,), device="meta"),
            "sparse_ids": torch.empty((B, T, L), dtype=torch.int32, device="meta")}


def dlrm_batch_specs(ax):
    dp = dp_axis(ax)
    return {"dense": P(dp, None), "label": P(dp), "sparse_ids": P(dp, None, None)}


def arg_bytes(arch: str, shape_name: str, mesh) -> Dict[str, int]:
    """One device's argument bytes of the cell's step on ``mesh`` (a
    ``DeviceMesh`` or an ``AbstractMesh``), by group, and their total."""
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW

    entry = get_entry(arch)
    cfg = entry.config
    ax = mesh_axes(mesh)
    out: Dict[str, int] = {}
    if arch == "dlrm-scratchpipe":
        shape = entry.shapes[0]
        out["params"] = tree_bytes_per_device(dlrm.full_specs(cfg, ax),
                                              dlrm_abstract_params(cfg), ax)
        out["batch"] = tree_bytes_per_device(dlrm_batch_specs(ax),
                                             dlrm_abstract_batch(cfg, shape), ax)
    else:
        shape = SHAPES_BY_NAME[shape_name]
        pspecs = api.param_specs(cfg, ax)
        params = api.abstract_params(cfg, ax)
        out["params"] = tree_bytes_per_device(pspecs, params, ax)
        if shape.kind == "train":
            ospecs = steps.opt_state_specs(cfg, ax, params, pspecs)
            out["opt"] = tree_bytes_per_device(ospecs, AdamW().init(params), ax)
        if shape.kind == "decode":
            cspecs = api.cache_specs(cfg, ax, shape.global_batch, shape.seq_len)
            cache = api.abstract_cache(cfg, shape.global_batch, shape.seq_len, ax)
            out["cache"] = tree_bytes_per_device(cspecs, cache, ax)
            b_ax = shard_dim(ax, shape.global_batch, dp_axis(ax))
            tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
            out["batch"] = (_bytes(tokens) // shard_factor(P(b_ax, None), ax)
                            + 4)  # the int32 position, replicated
        else:
            out["batch"] = tree_bytes_per_device(api.batch_specs(cfg, shape, ax),
                                                 api.abstract_batch(cfg, shape), ax)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the step's flops, on meta tensors
# ---------------------------------------------------------------------------


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def step_flops(arch: str, shape_name: str, mesh) -> int:
    """The floating-point operations of the cell's step at the global
    shapes (heads and vocab padded for ``mesh``), counted over the step on
    ``meta`` tensors: a train cell's loss and backward (the optimizer's
    elementwise update counts no product), a prefill's forward, one decode
    step, the DLRM's full-table SGD step."""
    entry = get_entry(arch)
    cfg = entry.config
    ax = mesh_axes(mesh)
    if arch == "dlrm-scratchpipe":
        shape = entry.shapes[0]
        meta = torch.device("meta")
        params = {"tables": torch.empty((cfg.total_rows, cfg.embed_dim), device=meta),
                  "mlps": dlrm.DLRM(cfg).to(meta)}
        batch = dlrm_abstract_batch(cfg, shape)
        return _flops(lambda: dlrm_full_train_step(params, cfg, batch, None))
    shape = SHAPES_BY_NAME[shape_name]
    rc, _ = api.runtime_config(cfg, ax)
    params = api.abstract_params(cfg, ax)
    mod = api.family_module(rc)
    if shape.kind == "train":
        batch = api.abstract_batch(cfg, shape)

        def train():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = mod.loss_fn(live, rc, batch)
            torch.autograd.grad(loss, tree_leaves(live), materialize_grads=True)

        return _flops(train)
    if shape.kind == "prefill":
        batch = api.abstract_batch(cfg, shape)
        return _flops(lambda: mod.prefill(params, rc, batch))
    cache = api.abstract_cache(cfg, shape.global_batch, shape.seq_len, ax)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    return _flops(lambda: mod.decode_step(params, rc, cache, tokens, shape.seq_len - 1))


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "devices": mesh.size(),
           "computed_not_measured": True}
    t0 = time.time()
    rec["arg_bytes_per_device"] = arg_bytes(arch, shape_name, mesh)
    rec["fits_card"] = rec["arg_bytes_per_device"]["total"] <= CARD_BYTES
    with torch.enable_grad():
        rec["flops"] = step_flops(arch, shape_name, mesh)
    rec["flops_per_device"] = rec["flops"] / mesh.size()
    rec["seconds"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-dlrm", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        cells = [(c["arch"], c["shape"]) for c in dryrun_cells(include_dlrm=args.include_dlrm)
                 if not c["skip"]]
    else:
        if not args.arch:
            ap.error("--arch (and --shape) or --all")
        shape = args.shape or (get_entry(args.arch).shapes[0].name)
        cells = [(args.arch, shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag.replace("/", "_") + ".json")
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mp)
                rec["ok"] = True
            except Exception as e:  # recorded per cell, as the reference does
                rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                failures += 1
                print(f"  FAILED: {rec['error']}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("ok"):
                b = rec["arg_bytes_per_device"]
                print(f"  ok arg_bytes/dev={b['total']:.4e} fits_card={rec['fits_card']} "
                      f"flops={rec['flops']:.4e} flops/dev={rec['flops_per_device']:.4e} "
                      f"({rec['seconds']}s)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
