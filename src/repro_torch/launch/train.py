"""Training launcher of the port: the paper's DLRM through a cache runtime.

Port of the DLRM branch of ``repro/launch/train.py``: host-resident tables,
the ScratchPipe pipeline (or a baseline) and the DLRM [Train] stage, on the
card:

    python -m repro_torch.launch.train --arch dlrm-scratchpipe --batch 2048 \
        [--smoke] [--runtime scratchpipe|strawman|nocache|static] [--fused] \
        [--precision fp32|fp16|int8] [--rounding nearest|stochastic] \
        [--planner host|device] [--executor sync|overlapped]

``--device cpu`` runs the kernels' plain PyTorch versions instead. It prints
the same ``runtime=``, ``done:`` and ``traffic:`` lines as the reference
(``kernel=`` names the kernels that ran: ``cuda`` or ``plain``). Like the
reference, ``--batch`` defaults to 8; the paper's batch is 2048.
``--precision fp16|int8`` keeps fp32 host masters and fp16/int8 scratchpad
replicas (``core/quantize.py``); ``--rounding`` picks how in-cache updates
re-quantize (default ``stochastic``, as the reference).
``--trace <dir>`` replays a recorded workload trace (``repro_torch.traces``
format; the reference's traces too): its manifest sets the tables, rows,
dim, lookups, dense features and batch size, and a prefetch thread decodes
the next batches ahead of the pipeline. ``--scenario <name>`` draws a
non-stationary generator instead (``traces/scenarios.py``), and
``--record-trace <dir>`` records the run's workload while it trains.
``--planner device`` keeps the [Plan] state on the card
(``core/plan_device.py``) and ``--executor overlapped`` moves the host
gather and write-back to a worker thread and the copies back to a d2h
thread (``core/pipeline.py``); both give the same figures as the defaults
(``--planner host --executor sync``). A caller of :func:`train_dlrm`
calls ``close()`` on the returned runtime when done with it (the
overlapped executor's threads).

Not ported yet (each errors with a pointer to ROADMAP.md): the LM archs,
``--tables`` and a trace whose tables differ in rows (item 9),
``--adaptive-pad`` (item 10), and ``--supervise``/``--chaos`` (item 12).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

ARCH = "dlrm-scratchpipe"

#: options of the reference launcher that later slices port, with the
#: ROADMAP.md item that carries each
_NOT_PORTED = {
    "tables": ("multi-table", 9),
    "adaptive_pad": ("trace-derived pad buckets", 10),
    "supervise": ("recovery", 12),
    "chaos": ("recovery", 12),
}
_DEFAULTS = {"tables": 0, "adaptive_pad": False, "supervise": False, "chaos": None}
_HETERO_TRACE = ("a trace whose tables differ in rows needs per-table slot "
                 "budgets (multi-table), which are not ported to repro_torch yet "
                 "(ROADMAP.md Queue 1 item 9)")


def train_dlrm(args, cfg=None, host=None, mlps=None) -> Dict[str, Any]:
    """Build the host table, the trainer and the runtime from parsed
    ``args``, train ``args.steps`` mini-batches (synthetic, a scenario's,
    or a recorded trace's), print the reference's summary lines and return
    the run (stats, losses, the runtime, the trainer, the wall seconds).
    ``cfg`` replaces the configuration that ``--smoke`` selects (how a
    caller cuts table rows; with ``--trace`` the manifest sets the workload
    shape and ``cfg`` keeps its cache fraction and MLP sizes); ``host``
    replaces the host table the launcher would build from ``--seed`` (the
    caller's copy is trained in place); ``mlps`` (a ``DLRM`` state_dict,
    e.g. ``convert.mlps_from_reference``) replaces the seeded MLP init."""
    import dataclasses
    import itertools

    import torch

    from repro_torch.configs.dlrm_scratchpipe import config, smoke_config
    from repro_torch.core.dlrm_runtime import DLRMTrainer
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.data.synthetic import TraceConfig, dlrm_batches, hot_ids_for_group
    from repro_torch.device import resolve_device
    from repro_torch.traces import (
        TraceReader,
        TraceRecorder,
        TraceReplayStream,
        hot_ids_from_trace,
        profile_hot_ids,
        scenario_batches,
    )

    if args.runtime == "nocache" and args.precision != "fp32":
        raise SystemExit(
            "--precision applies to the device-resident caches; "
            "the nocache baseline holds no rows to quantize"
        )
    dev = resolve_device(args.device)  # fail before building tables, not after
    base = cfg if cfg is not None else (smoke_config() if args.smoke else config())
    reader = None
    if args.trace:  # replay a recorded workload trace
        reader = TraceReader(args.trace)
        if reader.num_batches < 1:
            raise SystemExit(f"--trace {args.trace}: empty trace (0 recorded batches)")
        if reader.num_dense_features < 1:
            raise SystemExit(
                f"--trace {args.trace}: no dense features (not a DLRM trace)"
            )
        group = reader.group
        if len(set(group.rows)) > 1:
            raise NotImplementedError(_HETERO_TRACE)
        # the trace manifest defines the workload shape; the MLP stack
        # follows (bottom-MLP output must match the trace's embed dim)
        cfg = dataclasses.replace(
            base,
            name="dlrm-trace",
            table_rows=tuple(group.rows),
            embed_dim=group.dim,
            lookups_per_table=reader.lookups_per_table,
            num_dense_features=reader.num_dense_features,
            batch_size=reader.batch_size,
            bottom_mlp=tuple(base.bottom_mlp[:-1]) + (group.dim,),
        )
        batch = reader.batch_size
        args.steps = min(args.steps, reader.num_batches)
    else:
        cfg = base
        group = TableGroup.from_config(cfg)
        batch = args.batch or cfg.batch_size
    if args.precision != "fp32":
        # scratchpad replica precision: fp32 masters stay on the host; the
        # trainer reads it from the config (so do the TableGroup specs)
        cfg = dataclasses.replace(cfg, precision=args.precision, rounding=args.rounding)
        group = (group.with_precision(args.precision) if reader is not None
                 else TableGroup.from_config(cfg))
    rows = group.total_rows
    slots = max(2048, int(rows * cfg.cache_fraction))

    def batches(steps):
        if reader is not None:
            return TraceReplayStream(reader, stop=steps)
        if args.scenario:  # non-stationary generator (traces/scenarios.py)
            return scenario_batches(
                args.scenario, group, steps, batch_size=batch,
                lookups_per_table=cfg.lookups_per_table, locality=args.locality,
                num_dense_features=cfg.num_dense_features, seed=args.seed,
            )
        tc = TraceConfig(
            num_tables=cfg.num_tables,
            rows_per_table=cfg.rows_per_table,
            lookups_per_table=cfg.lookups_per_table,
            batch_size=batch,
            locality=args.locality,
            seed=args.seed,
        )
        return dlrm_batches(tc, steps)

    kw: Dict[str, Any] = {"num_slots": slots, "precision": args.precision}
    if args.runtime == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    if args.runtime in ("scratchpipe", "strawman"):
        kw.update(executor=args.executor, planner=args.planner)
    if args.runtime == "static":
        if reader is not None:
            hot = hot_ids_from_trace(reader, cfg.cache_fraction,
                                     profile_batches=max(1, args.steps // 5))
        elif args.scenario:
            # offline profiling pass over the workload's own prefix
            hot = profile_hot_ids(
                itertools.islice(batches(args.steps), max(1, args.steps // 5)),
                group, cfg.cache_fraction,
            )
        else:
            hot = hot_ids_for_group(group, cfg.cache_fraction, locality=args.locality)
        kw = {"hot_ids": hot, "precision": args.precision}
    elif args.runtime == "nocache":
        kw = {}
    kw["device"] = dev

    if host is None:
        host = HostEmbeddingTable(rows, cfg.embed_dim, seed=args.seed)
    elif host.data.shape != (rows, cfg.embed_dim):
        raise ValueError(f"host table {host.data.shape} != ({rows}, {cfg.embed_dim})")
    trainer = DLRMTrainer(cfg, seed=args.seed, lr=args.lr, device=dev)
    if mlps is not None:
        trainer.model.load_state_dict(mlps)
    if args.runtime in ("scratchpipe", "strawman") and args.fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    pipe = make_runtime(args.runtime, host, trainer.train_fn, **kw)

    src = batches(args.steps)
    if args.record_trace:
        prov = {"generator": args.scenario or "synthetic",
                "locality": args.locality, "seed": args.seed}
        src = TraceRecorder(args.record_trace, group, provenance=prov).tee(src)
    # a replay stream already is a look-ahead source
    stream = src if hasattr(src, "peek_ids") else LookaheadStream(src)
    t0 = time.time()
    try:
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    finally:
        if isinstance(stream, TraceReplayStream):
            stream.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    losses = [float(s.aux["loss"]) for s in stats if s.aux]
    hit = float(np.mean([s.hit_rate for s in stats[6:]])) if len(stats) > 6 else 0
    source = (f"trace:{args.trace}" if args.trace
              else f"scenario:{args.scenario}" if args.scenario else "synthetic")
    print(
        f"runtime={args.runtime} source={source} "
        f"kernel={'cuda' if dev.type == 'cuda' else 'plain'} precision={args.precision} "
        f"tables={group.num_tables} rows={list(group.rows)}"
    )
    if args.record_trace:
        print(f"recorded trace -> {args.record_trace}")
    print(
        f"done: steps={len(stats)} loss {losses[0]:.4f}->{losses[-1]:.4f} "
        f"plan_hit={hit:.3f} {dt / max(len(stats), 1) * 1e3:.1f}ms/step"
    )
    tr = pipe.traffic()
    print(
        f"traffic: host {tr['host'].total / 1e6:.1f}MB "
        f"pcie {tr['pcie'].total / 1e6:.1f}MB hbm {tr['hbm'].total / 1e6:.1f}MB"
    )
    return {"stats": stats, "losses": losses, "plan_hit": hit, "pipe": pipe,
            "trainer": trainer, "host": host, "wall_s": dt, "cfg": cfg}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--locality", default="medium")
    ap.add_argument(
        "--runtime",
        default="scratchpipe",
        choices=("scratchpipe", "strawman", "nocache", "static"),
        help="embedding-cache runtime (EmbeddingCacheRuntime registry)",
    )
    ap.add_argument(
        "--fused",
        action="store_true",
        help="fuse [Insert]-fill into the [Train] forward (one kernel launch "
        "per cycle; bitwise equal to the split path)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="cuda (default; raises without a card) or cpu (plain PyTorch "
        "versions of the kernels)",
    )
    ap.add_argument(
        "--precision", choices=("fp32", "fp16", "int8"), default="fp32",
        help="scratchpad replica precision: fp32 host masters stay exact; "
        "fp16/int8 rows hold 2x/4x resident rows at the same byte budget "
        "(int8: per-row scale, dequantized in the kernel)",
    )
    ap.add_argument(
        "--rounding", choices=("nearest", "stochastic"), default="stochastic",
        help="re-quantization rounding of in-cache updates (reduced precision "
        "only); 'stochastic' keeps repeated small updates unbiased",
    )
    ap.add_argument(
        "--executor", choices=("sync", "overlapped"), default="sync",
        help="scratchpipe/strawman stage executor: 'overlapped' runs the host "
        "gather and write-back on a worker thread and waits for the d2h "
        "copies on another (bitwise equal to 'sync')",
    )
    ap.add_argument(
        "--planner", choices=("host", "device"), default="host",
        help="scratchpipe/strawman [Plan] placement: 'device' keeps the plan "
        "state on the card (equal plans to 'host')",
    )
    ap.add_argument(
        "--trace", default=None,
        help="replay a recorded workload trace directory (repro_torch.traces "
        "format; overrides the synthetic generator)",
    )
    ap.add_argument(
        "--scenario", default=None,
        help="non-stationary workload generator by name "
        "(drift, flash_crowd, diurnal, cold_start)",
    )
    ap.add_argument(
        "--record-trace", default=None,
        help="snapshot the training workload into this trace directory while "
        "training (repro_torch.traces.TraceRecorder.tee)",
    )
    later = ap.add_argument_group("not ported yet (error with a ROADMAP pointer)")
    later.add_argument("--tables", type=int, default=0)
    later.add_argument("--adaptive-pad", action="store_true")
    later.add_argument("--supervise", action="store_true")
    later.add_argument("--chaos", default=None)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch != ARCH:
        ap.error(f"--arch {args.arch}: the port trains {ARCH} only; the LM "
                 "training comes later (ROADMAP.md Queue 1 item 18)")
    for name, (what, item) in _NOT_PORTED.items():
        if getattr(args, name) != _DEFAULTS[name]:
            ap.error(f"--{name.replace('_', '-')} ({what}) is not ported to repro_torch "
                     f"yet (ROADMAP.md Queue 1 item {item})")
    if args.trace and args.scenario:
        ap.error("--trace and --scenario are mutually exclusive")
    if args.trace and not os.path.exists(os.path.join(args.trace, "manifest.json")):
        ap.error(f"--trace {args.trace}: not a recorded trace directory "
                 "(no manifest.json)")
    return train_dlrm(args)


if __name__ == "__main__":
    main()
