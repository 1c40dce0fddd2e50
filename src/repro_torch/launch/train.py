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
``--planner device`` keeps the [Plan] state on the card
(``core/plan_device.py``) and ``--executor overlapped`` moves the host
gather and write-back to a worker thread and the copies back to a d2h
thread (``core/pipeline.py``); both give the same figures as the defaults
(``--planner host --executor sync``). A caller of :func:`train_dlrm`
calls ``close()`` on the returned runtime when done with it (the
overlapped executor's threads).

Not ported yet (each errors with a pointer to ROADMAP.md): the LM archs,
``--tables``, ``--trace`` and ``--supervise``/``--chaos``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

ARCH = "dlrm-scratchpipe"

#: options of the reference launcher that later slices port, with the
#: ROADMAP.md item that carries each
_NOT_PORTED = {
    "tables": "Queue 1 item 9 (multi-table)",
    "trace": "Queue 1 item 10 (traces)",
    "supervise": "Queue 1 item 12 (recovery)",
    "chaos": "Queue 1 item 12 (recovery)",
}
_DEFAULTS = {"tables": 0, "trace": None, "supervise": False, "chaos": None}


def train_dlrm(args, cfg=None, host=None, mlps=None) -> Dict[str, Any]:
    """Build the host table, the trainer and the runtime from parsed
    ``args``, train ``args.steps`` synthetic mini-batches, print the
    reference's summary lines and return the run (stats, losses, the
    runtime, the trainer, the wall seconds). ``cfg`` replaces the
    configuration that ``--smoke`` selects (how a caller cuts table rows);
    ``host`` replaces the host table the launcher would build from
    ``--seed`` (the caller's copy is trained in place); ``mlps`` (a
    ``DLRM`` state_dict, e.g. ``convert.mlps_from_reference``) replaces the
    seeded MLP init."""
    import dataclasses

    import torch

    from repro_torch.configs.dlrm_scratchpipe import config, smoke_config
    from repro_torch.core.dlrm_runtime import DLRMTrainer
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.data.synthetic import TraceConfig, dlrm_batches, hot_ids_for_group
    from repro_torch.device import resolve_device

    if args.runtime == "nocache" and args.precision != "fp32":
        raise SystemExit(
            "--precision applies to the device-resident caches; "
            "the nocache baseline holds no rows to quantize"
        )
    dev = resolve_device(args.device)  # fail before building tables, not after
    if cfg is None:
        cfg = smoke_config() if args.smoke else config()
    if args.precision != "fp32":
        # scratchpad replica precision: fp32 masters stay on the host; the
        # trainer reads it from the config
        cfg = dataclasses.replace(cfg, precision=args.precision, rounding=args.rounding)
    group = TableGroup.from_config(cfg)
    batch = args.batch or cfg.batch_size
    rows = group.total_rows
    slots = max(2048, int(rows * cfg.cache_fraction))
    tc = TraceConfig(
        num_tables=cfg.num_tables,
        rows_per_table=cfg.rows_per_table,
        lookups_per_table=cfg.lookups_per_table,
        batch_size=batch,
        locality=args.locality,
        seed=args.seed,
    )
    kw: Dict[str, Any] = {"num_slots": slots, "precision": args.precision}
    if args.runtime == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    if args.runtime in ("scratchpipe", "strawman"):
        kw.update(executor=args.executor, planner=args.planner)
    if args.runtime == "static":
        kw = {"hot_ids": hot_ids_for_group(group, cfg.cache_fraction, locality=args.locality),
              "precision": args.precision}
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

    stream = LookaheadStream(dlrm_batches(tc, args.steps))
    t0 = time.time()
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    losses = [float(s.aux["loss"]) for s in stats if s.aux]
    hit = float(np.mean([s.hit_rate for s in stats[6:]])) if len(stats) > 6 else 0
    print(
        f"runtime={args.runtime} source=synthetic "
        f"kernel={'cuda' if dev.type == 'cuda' else 'plain'} precision={args.precision} "
        f"tables={group.num_tables} rows={list(group.rows)}"
    )
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
    later = ap.add_argument_group("not ported yet (error with a ROADMAP pointer)")
    later.add_argument("--tables", type=int, default=0)
    later.add_argument("--trace", default=None)
    later.add_argument("--supervise", action="store_true")
    later.add_argument("--chaos", default=None)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch != ARCH:
        ap.error(f"--arch {args.arch}: the port trains {ARCH} only; the LM "
                 "training comes later (ROADMAP.md Queue 1 item 18)")
    for name, item in _NOT_PORTED.items():
        if getattr(args, name) != _DEFAULTS[name]:
            ap.error(f"--{name} is not ported to repro_torch yet (ROADMAP.md {item})")
    return train_dlrm(args)


if __name__ == "__main__":
    main()
