"""Dry run of the port: for every (arch x input-shape x mesh) cell, what one
device of the production mesh holds, allocates and sends while it runs the
cell's step, without allocating; and the DLRM full-table train step it
lowers.

Port of ``repro/launch/dryrun.py``:

    python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] \\
        [--include-dlrm] [--out DIR]

Results: ``<out>/<arch>__<shape>__<mesh>.json`` (default ``build/dryrun/``,
git-ignored). Each cell records:

  * ``arg_bytes_per_device`` — the bytes of one device's arguments of the
    cell's step, by group (params; the AdamW state with ZeRO-1 for a train
    cell; the decode cache and the token ids and position for a decode
    cell; the batch), computed from the specs (``models/api.py``,
    ``launch/steps.py``) and the ``meta`` shapes: each leaf's bytes over
    the product of the mesh axes its spec names;
  * ``flops`` — the step's floating-point operations at the padded global
    shapes, from ``torch.utils.flop_counter.FlopCounterMode`` over the step
    on ``meta`` tensors (the hand-written kernels' wrappers send ``meta``
    tensors to their plain versions: ``kernels/ops.py``), and
    ``flops_per_device`` (an even split, computed);
  * ``fits_card`` — whether one device's arguments fit one 80 GB card;
  * ``memory`` and ``collectives`` — rank 0's step itself
    (:func:`rank_step`): ``make_train_step(cfg, mesh=)`` whole (loss,
    backward, the sum over data, the clip, the ZeRO-1 AdamW step and its
    all-gather), ``make_prefill_step``, ``make_serve_step`` or
    :func:`dlrm_full_train_step`, run on ``meta`` shards of its params,
    state and data over a fake process group of the mesh's world size
    (``launch/mesh.py: abstract_rank_mesh``). ``memory`` has the keys of
    the reference's ``memory_analysis()``: ``argument_size_in_bytes`` (the
    arguments' storages at entry, equal to ``arg_bytes_per_device``'s
    total), ``output_size_in_bytes`` (the outputs that alias no argument),
    ``alias_size_in_bytes`` (outputs written in place into arguments: a
    train step's params and state, a decode step's cache),
    ``peak_memory_in_bytes`` (the most live bytes during the step,
    arguments included: ``launch/hlo_stats.py: LiveBytes``) and
    ``temp_size_in_bytes`` (the peak less the arguments). The hand-written
    kernels' wrappers allocate there what they allocate on the card
    (``ops.kernel_footprint``), not the plain versions' temporaries.
    ``generated_code_size_in_bytes`` has no meaning without a compiled
    module and is left out. ``collectives`` is
    ``hlo_stats.collective_stats`` of the records the step's collectives
    kept, in the reference's shape; ``peak_fits_card`` whether the peak
    fits one 80 GB card.

``method`` says how each number was obtained. The peak counts the
storages the step's aten ops return, so not an allocator's rounding, a
library's own workspace (cuBLAS's, a sort's), or the communicator's
buffers; ``chip_smoke.py`` holds it against the card's allocator at (1, 1).

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
from repro_torch.configs.base import DLRMConfig, ShapeSpec
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro_torch.models import api, dlrm
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.parallel.sharding import (
    P,
    dp_axis,
    local_shard,
    mesh_axes,
    shard_dim,
    is_spec,
    shard_factor,
    tree_map_specs,
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


# ---------------------------------------------------------------------------
# one rank's step on meta shards: memory and collectives
# ---------------------------------------------------------------------------


def tensors(obj) -> list:
    """The tensors of a tree of dicts, lists and tuples (a module's
    parameters included), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters())
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors(v)]
    return []


def _own(spec, t, mesh):
    """This rank's shard of the global ``meta`` tensor ``t`` as a tensor
    of its own (a storage of the shard's bytes)."""
    return local_shard(t, spec, mesh).clone()


def _rank_call(cfg, shape: ShapeSpec, mesh):
    """(step fn, its arguments, bytes of a host scalar argument): the step
    of ``cfg`` at ``shape`` for this rank of ``mesh``, its arguments
    ``meta`` shards."""
    from repro_torch.launch import steps

    ax = mesh_axes(mesh)
    if isinstance(cfg, DLRMConfig):
        specs = dlrm.full_specs(cfg, ax)
        tables = torch.empty((cfg.total_rows, cfg.embed_dim), device="meta")
        params = {"tables": _own(specs["tables"], tables, mesh),
                  "mlps": dlrm.DLRM(cfg).to("meta")}
        batch = tree_map_specs(lambda sp, t: _own(sp, t, mesh), dlrm_batch_specs(ax),
                               dlrm_abstract_batch(cfg, shape))
        return (lambda p, b: dlrm_full_train_step(p, cfg, b, mesh)), (params, batch), 0
    params = api.local_params(api.abstract_params(cfg, ax), cfg, mesh)
    if shape.kind == "decode":
        dec, sp = steps.make_serve_step(cfg, mesh, shape)
        cache = tree_map_specs(lambda s_, t: _own(s_, t, mesh), sp["cache"],
                               steps.abstract_cache(cfg, mesh, shape))
        b_ax = shard_dim(ax, shape.global_batch, dp_axis(ax))
        tokens = _own(P(b_ax, None), torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                                 device="meta"), mesh)
        # the position is a host int: the reference's replicated int32 scalar
        return (lambda p, c, t: dec(p, c, t, shape.seq_len - 1)), (params, cache, tokens), 4
    batch = tree_map_specs(lambda sp, t: _own(sp, t, mesh), api.batch_specs(cfg, shape, ax),
                           api.abstract_batch(cfg, shape))
    if shape.kind == "prefill":
        pre, _ = steps.make_prefill_step(cfg, mesh, shape)
        return pre, (params, batch), 0
    step, opt = steps.make_train_step(cfg, mesh=mesh)
    return step, (params, opt.init(params), batch), 0


def rank_step(cfg, shape: ShapeSpec, mesh_shape, rank: int = 0) -> dict:
    """One rank's step of ``cfg`` (an LM config, its layers cut as a caller
    cuts them, or a ``DLRMConfig``: :func:`dlrm_full_train_step`) at
    ``shape`` over a mesh of ``mesh_shape`` ((data, model), or (pod, data,
    model); (1, 1) included), run on ``meta`` shards over a fake process
    group of the mesh's world size as ``rank``, the kernels' wrappers
    allocating what they allocate on the card. -> {"memory": the
    reference's ``memory_analysis()`` keys (the module docstring),
    "collectives": ``collective_stats`` of the step's records, "seconds"}."""
    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_stats import LiveBytes, collective_stats
    from repro_torch.launch.mesh import abstract_rank_mesh
    from repro_torch.parallel import collectives as C

    t0 = time.time()
    with abstract_rank_mesh(mesh_shape, rank=rank) as mesh:
        fn, args, host_bytes = _rank_call(cfg, shape, mesh)
        inputs = tensors(args)
        tracker = LiveBytes("meta")
        arguments = tracker.hold(inputs) + host_bytes
        C.reset_collective_records()
        with torch.enable_grad(), ops.kernel_footprint(), tracker:
            out = fn(*args)
        records = C.collective_records()
        del fn, args
        seen, output, alias = set(), 0, 0
        in_args = {id(t.untyped_storage()) for t in inputs}
        for t in tensors(out):
            st = t.untyped_storage()
            if t.device.type != "meta" or id(st) in seen:
                continue
            seen.add(id(st))
            if id(st) in in_args:
                alias += st.nbytes()
            else:
                output += st.nbytes()
        peak = tracker.peak + host_bytes
    memory = {"argument_size_in_bytes": arguments, "output_size_in_bytes": output,
              "alias_size_in_bytes": alias, "temp_size_in_bytes": peak - arguments,
              "peak_memory_in_bytes": peak}
    return {"memory": memory, "collectives": collective_stats(records),
            "seconds": round(time.time() - t0, 2)}


def cell_config(arch: str, shape_name: str):
    """(the cell's config, its ShapeSpec)."""
    entry = get_entry(arch)
    shape = entry.shapes[0] if arch == "dlrm-scratchpipe" else SHAPES_BY_NAME[shape_name]
    return entry.config, shape


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The cell's record: the computed argument bytes and flops, and rank
    0's step on the production mesh (:func:`rank_step`). Raises when the
    step's argument bytes are not the computed ones."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": name, "devices": mesh.size(),
           "rank": 0,
           "method": {
               "arg_bytes_per_device": "computed: each leaf's bytes over its spec's axes",
               "flops": "FlopCounterMode over the step at the global shapes on meta "
                        "tensors, the kernels' plain versions",
               "memory": f"rank 0's step on meta shards over a fake process group of "
                         f"{mesh.size()} ranks: the live bytes of the storages its ops "
                         "return, the hand-written kernels' own allocations",
               "collectives": "the records of rank 0's collectives in that step"}}
    t0 = time.time()
    rec["arg_bytes_per_device"] = arg_bytes(arch, shape_name, mesh)
    rec["fits_card"] = rec["arg_bytes_per_device"]["total"] <= CARD_BYTES
    with torch.enable_grad():
        rec["flops"] = step_flops(arch, shape_name, mesh)
    rec["flops_per_device"] = rec["flops"] / mesh.size()
    cfg, shape = cell_config(arch, shape_name)
    step = rank_step(cfg, shape, (MULTI_POD if multi_pod else SINGLE_POD)[0])
    rec["memory"], rec["collectives"] = step["memory"], step["collectives"]
    if rec["memory"]["argument_size_in_bytes"] != rec["arg_bytes_per_device"]["total"]:
        raise RuntimeError(f"{arch} {shape_name} {name}: the step's arguments hold "
                           f"{rec['memory']['argument_size_in_bytes']} bytes, the specs "
                           f"give {rec['arg_bytes_per_device']['total']}")
    rec["peak_fits_card"] = rec["memory"]["peak_memory_in_bytes"] <= CARD_BYTES
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
                b, m = rec["arg_bytes_per_device"], rec["memory"]
                c = rec["collectives"]["total"]
                print(f"  ok arg_bytes/dev={b['total']:.4e} fits_card={rec['fits_card']} "
                      f"flops={rec['flops']:.4e} flops/dev={rec['flops_per_device']:.4e}\n"
                      f"     peak/dev={m['peak_memory_in_bytes']:.4e} "
                      f"temp/dev={m['temp_size_in_bytes']:.4e} "
                      f"out={m['output_size_in_bytes']:.4e} alias={m['alias_size_in_bytes']:.4e} "
                      f"peak_fits_card={rec['peak_fits_card']} collectives={c['count']} "
                      f"coll_bytes/dev={c['bytes_in']:.4e} ({rec['seconds']}s)", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
