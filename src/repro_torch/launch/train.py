"""Training launcher of the port: the paper's DLRM through a cache runtime,
and LM training of the transformer families.

Port of ``repro/launch/train.py``. LM archs (the dense, encoder, vlm and
MoE transformers) train through :func:`train_lm`:

    python -m repro_torch.launch.train --arch chatglm3-6b --batch 4 \
        [--smoke] [--steps N] [--seq-len S] [--lr 3e-4] [--seed 0] \
        [--ckpt-dir <dir>] [--ckpt-every 50]

random params from ``--seed`` (a ``torch.Generator`` on the device), the
reference's synthetic batches (``seed + i`` for step i), the train step of
``launch/steps.py`` (loss and backward; on the card the flash kernel and
its backward kernel; global-norm clip 1.0; AdamW with fp32 masters) under
``runtime.TrainSupervisor`` (checkpoints every ``--ckpt-every`` steps,
restore + replay on a failure), printing the reference's ``done:`` line.
Without ``--smoke`` the sequence is the reference's ``train_4k`` 4096
tokens, but the batch is ``--batch`` (default 8), not its global 256: one
card holds neither 256 x 4096 tokens of activations nor, at full depth,
the 16 bytes a parameter of bf16 params, grads and fp32 m, v and master
of the larger configs. ``--seq-len`` overrides the sequence (the smoke
default is the reference's 128). The hybrid and ssm families (zamba2,
mamba2) raise: their SSD kernel has no backward yet (ROADMAP.md Queue 1
item 20).

The DLRM branch: host-resident tables, the ScratchPipe pipeline (or a
baseline) and the DLRM [Train] stage, on the card:

    python -m repro_torch.launch.train --arch dlrm-scratchpipe --batch 2048 \
        [--smoke] [--runtime scratchpipe|strawman|nocache|static] [--fused] \
        [--precision fp32|fp16|int8] [--rounding nearest|stochastic] \
        [--planner host|device] [--executor sync|overlapped] [--tables N] \
        [--trace <dir> [--adaptive-pad]]

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
``--tables N`` trains the heterogeneous N-table DLRM
(``configs/dlrm_scratchpipe.py: multi_table_config``, streamed by
``data/synthetic.py: dlrm_batches_group``); it and a trace whose tables
differ in rows get per-table slot budgets with the §VI-D window floor
(6 mini-batches of lookups per table). ``--adaptive-pad`` (with
``--trace``) derives the pad-bucket set of the variable-length operands
from the trace's miss counts (``traces/profiling.py:
derive_pad_buckets``); the results are those of the pow-2 default. The
``sharded`` runtime (one manager per table) is reached through
``core.runtime.make_runtime``, as in the reference, not ``--runtime``.

Telemetry: ``--metrics-out m.jsonl`` writes an ``obs_metrics/v1`` snapshot
and ``--trace-out t.json`` a Chrome trace of spans on every thread
(``repro_torch.obs``; check both with ``python -m repro_torch.obs.check``),
with a provenance block; both are written on the way out, error paths
included, and the global install is cleared there.

Recovery: ``--supervise`` trains under
``runtime.EmbeddingTrainSupervisor`` (crash-consistent checkpoints every
``--ckpt-every`` admitted batches under ``--ckpt-dir``, default a fresh
temporary directory that is printed; restore + fast-forward on a fault; a
watchdog over the overlapped executor's workers) and prints a
``state_digest=`` line; ``--chaos <spec>`` (implies ``--supervise``) arms
``chaos.ChaosInjector`` on the runtime until each event has fired (across
restarts, unlike the reference, which arms the first incarnation only), and
``--verify-every k`` audits the host table's row checksums every k cycles.
A supervised run's results equal the plain run's bit for bit.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch import obs

ARCH = "dlrm-scratchpipe"
#: the reference's sequence lengths: ``--smoke`` (its ``--seq-len``
#: default) and ``train_4k``
SMOKE_SEQ, TRAIN_SEQ = 128, 4096


def obs_setup(trace_out, metrics_out):
    """Build and globally install the opt-in telemetry pair (either side
    may be None). Every runtime and stream built afterwards picks them up
    through ``repro_torch.obs.resolve`` — one call covers every thread."""
    tracer = obs.Tracer() if trace_out else None
    metrics = obs.MetricsRegistry() if metrics_out else None
    if tracer is not None or metrics is not None:
        obs.install(tracer, metrics)
    return tracer, metrics


def obs_export(trace_out, metrics_out, tracer, metrics, provenance):
    """Write the artifacts and clear the global install (also on error
    paths — callers wrap the run in try/finally)."""
    try:
        if metrics is not None:
            metrics.write_jsonl(metrics_out, provenance=provenance)
            print(f"metrics snapshot -> {metrics_out}")
        if tracer is not None:
            n = tracer.export_chrome(trace_out)
            print(f"chrome trace -> {trace_out} ({n} events)")
    finally:
        obs.install(None, None)


def _state_digest(pipe, trainer, stats) -> str:
    """SHA-256 over the final host tables, the dense parameters and the
    loss trajectory — one line two runs can diff to prove bit-parity (a
    chaos run against its clean twin)."""
    import hashlib

    h = hashlib.sha256()
    pipes = getattr(pipe, "pipes", None)
    for host in ([p.host for p in pipes] if pipes else [pipe.host]):
        h.update(np.ascontiguousarray(host.data).tobytes())
    if trainer is not None:
        for v in trainer.model.state_dict().values():
            h.update(v.detach().cpu().numpy().tobytes())
    for s in stats:
        loss = s.aux.get("loss") if isinstance(s.aux, dict) else s.aux
        if loss is not None:
            h.update(np.float64(float(loss)).tobytes())
    return h.hexdigest()


def _train_dlrm_supervised(args, build, batches, reader):
    """DLRM training under ``EmbeddingTrainSupervisor``: periodic
    crash-consistent checkpoints, restore + fast-forward on faults, and
    (with ``--chaos``) deterministic fault injection. One injector follows
    the runtime across restarts until each event has fired once (its
    counters count the calls of the whole run, replays included), so a
    plan of two restoring faults exercises two restores; the reference's
    launcher arms the first incarnation only, where a restore disarms the
    rest of the plan. Returns (runtime, trainer, stats, report, seconds, the
    specs of the chaos events that fired)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.runtime import EmbeddingTrainSupervisor
    from repro_torch.traces import TraceReplayStream

    injector = None
    if args.chaos:
        from repro_torch.chaos import ChaosInjector, ChaosPlan

        injector = ChaosInjector(ChaosPlan.parse(args.chaos), seed=args.chaos_seed)
        print(f"chaos plan: {injector.plan.spec} (seed {args.chaos_seed})")
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"checkpoints -> {args.ckpt_dir}")
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    first = [True]

    def runtime_factory():
        _host, trainer, pipe = build(supervised=True, first=first[0],
                                     restoring=ckpt.latest_step() is not None)
        if injector is not None and not all(e.fired for e in injector.plan.events):
            injector.attach(pipe)
        first[0] = False
        return pipe, trainer

    streams = []

    def stream_factory(skip):
        if reader is not None:
            st = TraceReplayStream(reader, start=skip, stop=args.steps)
            streams.append(st)
            return st
        it = iter(batches(args.steps))
        for _ in range(skip):
            next(it)
        return LookaheadStream(it)

    sup = EmbeddingTrainSupervisor(
        ckpt, runtime_factory, stream_factory,
        ckpt_every=args.ckpt_every, verify_every=args.verify_every,
    )
    t0 = time.time()
    try:
        stats, report = sup.run(args.steps)
    finally:
        for st in streams:
            st.close()
    dt = time.time() - t0
    fired = [e.spec for e in injector.fired] if injector is not None else []
    print(
        f"supervised: restarts={report.restarts} "
        f"checkpoints={report.checkpoints} "
        f"nan_skipped={report.nan_steps_skipped} "
        f"restore_ms={[round(m, 1) for m in report.restore_ms]} "
        f"chaos_fired={fired}"
    )
    return sup.runtime, sup.trainer, stats, report, dt, fired


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
    e.g. ``convert.mlps_from_reference``) replaces the seeded MLP init.
    Under ``--supervise``/``--chaos`` the run goes through
    ``EmbeddingTrainSupervisor``; the result then also carries the
    supervisor's ``report``, and ``host`` is the live runtime's table (a
    restart rebuilds the runtime, whose table the checkpoint fills)."""
    import dataclasses
    import itertools

    import torch

    from repro_torch.configs.dlrm_scratchpipe import (
        config,
        multi_table_config,
        multi_table_smoke_config,
        smoke_config,
    )
    from repro_torch.core.dlrm_runtime import DLRMTrainer
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.data.synthetic import (
        TraceConfig,
        dlrm_batches,
        dlrm_batches_group,
        hot_ids_for_group,
    )
    from repro_torch.device import resolve_device
    from repro_torch.traces import (
        TraceReader,
        TraceRecorder,
        TraceReplayStream,
        derive_pad_buckets,
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
    if cfg is not None:
        base = cfg
    elif args.tables and args.trace is None:  # heterogeneous multi-table scenario
        base = (multi_table_smoke_config(args.tables) if args.smoke
                else multi_table_config(args.tables))
    else:
        base = smoke_config() if args.smoke else config()
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
        if args.tables:
            return dlrm_batches_group(
                group, steps, batch_size=batch,
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
    if args.tables or (reader is not None and len(set(group.rows)) > 1):
        # heterogeneous tables: per-table budgets with the §VI-D window floor
        # (the worst-case 6-batch window working set of each table)
        floor = group.window_floor(batch * cfg.lookups_per_table)
        slots = max(slots, sum(min(floor, r) for r in group.rows))
        # byte-budget slot math: per-table budgets in ROWS of each table's
        # replica precision (the plain budgets at fp32)
        budgets = group.precision_slot_budgets(slots, min_per_table=floor)
        kw.update(num_slots=slots, table_group=group, slot_budgets=budgets)
    if args.runtime == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    if args.runtime in ("scratchpipe", "strawman"):
        kw.update(executor=args.executor, planner=args.planner)
        if args.adaptive_pad:
            # trace-derived fill/evict pad buckets (vs the pow-2 default)
            pw, fw = ((cfg.past_window, cfg.future_window)
                      if args.runtime == "scratchpipe" else (0, 0))
            kw["pad_buckets"] = derive_pad_buckets(
                reader, slots, past_window=pw, future_window=fw,
                profile_batches=min(args.steps, 512),
            )
            print(f"adaptive pad buckets: {kw['pad_buckets']}")
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

    if host is not None and host.data.shape != (rows, cfg.embed_dim):
        raise ValueError(f"host table {host.data.shape} != ({rows}, {cfg.embed_dim})")

    def build(supervised: bool = False, first: bool = True, restoring: bool = False):
        """One runtime stack — host table, trainer, runtime. Under
        supervision a restart rebuilds it from scratch (a clean process
        image): the table is then empty when a checkpoint will fill it, and
        the seeded one when the run restarts from the beginning."""
        if first and host is not None:
            h = host
        elif restoring:
            h = HostEmbeddingTable(rows, cfg.embed_dim,
                                   data=np.empty((rows, cfg.embed_dim), np.float32))
        elif host is not None:
            raise RuntimeError("a restart before the first checkpoint needs the "
                               "caller's initial host table, which was trained in place")
        else:
            h = HostEmbeddingTable(rows, cfg.embed_dim, seed=args.seed)
        trainer = DLRMTrainer(cfg, seed=args.seed, lr=args.lr, device=dev)
        if mlps is not None:
            trainer.model.load_state_dict(mlps)
        kw2 = dict(kw)
        if args.runtime in ("scratchpipe", "strawman") and args.fused:
            kw2["fused_train_fn"] = trainer.fused_train_fn
        if supervised:
            from repro_torch.runtime import SupervisePolicy

            kw2["supervise"] = SupervisePolicy()
        return h, trainer, make_runtime(args.runtime, h, trainer.train_fn, **kw2)

    report, fired = None, []
    if args.chaos:
        args.supervise = True
    if args.supervise:
        pipe, trainer, stats, report, dt, fired = _train_dlrm_supervised(
            args, build, batches, reader)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    else:
        host, trainer, pipe = build()
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
    digest = None
    if args.supervise:
        # settle every cached row so the digest covers the full model state
        pipe.flush_to_host()
        digest = _state_digest(pipe, trainer, stats)
        print(f"state_digest={digest}")
    tr = pipe.traffic()
    print(
        f"traffic: host {tr['host'].total / 1e6:.1f}MB "
        f"pcie {tr['pcie'].total / 1e6:.1f}MB hbm {tr['hbm'].total / 1e6:.1f}MB"
    )
    return {"stats": stats, "losses": losses, "plan_hit": hit, "pipe": pipe,
            "trainer": trainer, "host": pipe.host, "wall_s": dt, "cfg": cfg,
            "report": report, "chaos_fired": fired, "state_digest": digest}


def synth_lm_stream(cfg, shape, steps: int, seed: int = 0, skip: int = 0, device="cpu"):
    """The reference's synthetic LM batches, ``seed + i`` for step i, from
    step ``skip`` on, as tensors on ``device``."""
    from repro_torch.models import api

    for i in range(skip, steps):
        yield api.synth_batch(cfg, shape, seed=seed + i, device=device)


def train_lm(args, cfg=None, step_hook=None) -> Dict[str, Any]:
    """Port of the reference's ``train_lm`` at one card (module docstring).
    ``cfg`` overrides the arch's config (the same arch, e.g. fewer layers);
    ``step_hook()`` runs at the start of every step (a drill's
    ``FailureInjector.maybe_fail``, whose error the supervisor recovers).
    Prints the ``done:`` line and returns the final params and AdamW
    state, each step's loss and grad norm, the host clock at the start of
    each step (the loss of a step is read on the host inside it, so step
    i's span is synchronized), the supervisor's report and the config."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as S
    from repro_torch.models import api
    from repro_torch.runtime import TrainSupervisor

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    seq = args.seq_len or (SMOKE_SEQ if args.smoke else TRAIN_SEQ)
    shape = ShapeSpec("smoke" if args.smoke else "train_4k", seq, args.batch, "train")
    train_step, opt = S.make_train_step(cfg, lr=args.lr)
    params = api.init(cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = opt.init(params)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"checkpoints -> {args.ckpt_dir}")
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    losses, grad_norms, starts = [], [], []

    def step_fn(state, batch):
        starts.append(time.perf_counter())
        if step_hook is not None:
            step_hook()
        p, o, metrics = train_step(*state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        losses.append(loss)
        grad_norms.append(gnorm)
        return (p, o), {"loss": loss, "grad_norm": gnorm}

    def stream_factory(skip):
        return synth_lm_stream(cfg, shape, args.steps, seed=args.seed, skip=skip, device=dev)

    sup = TrainSupervisor(ckpt, step_fn, stream_factory, ckpt_every=args.ckpt_every)
    t0 = time.time()
    (params, opt_state), report = sup.run((params, opt_state), args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    starts.append(time.perf_counter())
    print(f"done: steps={report.steps_run} restarts={report.restarts} time={dt:.1f}s "
          f"({dt / max(report.steps_run, 1):.3f}s/step)")
    return {"cfg": cfg, "shape": shape, "params": params, "opt_state": opt_state,
            "losses": losses, "grad_norms": grad_norms, "step_starts": starts,
            "report": report, "wall_s": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument(
        "--seq-len", type=int, default=None,
        help="LM archs: tokens per sequence (default 128 with --smoke, else "
        "the reference's train_4k 4096)",
    )
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
    ap.add_argument(
        "--tables", type=int, default=0,
        help="N>0: heterogeneous N-table DLRM (per-table slot budgets); "
        "0: the paper's uniform 8-table config",
    )
    ap.add_argument(
        "--adaptive-pad", action="store_true",
        help="derive the fill/evict pad-bucket set from the --trace's "
        "miss-count distribution instead of the pow-2 default",
    )
    ap.add_argument(
        "--ckpt-dir", default=None,
        help="checkpoint directory of --supervise (default: a fresh temporary "
        "directory, printed)",
    )
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument(
        "--supervise", action="store_true",
        help="train under EmbeddingTrainSupervisor: crash-consistent "
        "checkpoints (any cycle, mid-window), restore + fast-forward on "
        "faults, a watchdog over the overlapped executor; prints a "
        "state_digest= line for bit-parity diffs",
    )
    ap.add_argument(
        "--chaos", default=None,
        help="fault-injection spec armed on the runtime until each event has "
        "fired once, across restarts (implies --supervise), e.g. "
        "'kill-gather@3;stall-d2h@12:0.2;corrupt-row@13:5;nan-loss@9'",
    )
    ap.add_argument(
        "--chaos-seed", type=int, default=0,
        help="RNG seed of the chaos victims (corrupt-row targets)",
    )
    ap.add_argument(
        "--verify-every", type=int, default=0,
        help="audit the host table's row checksums every N cycles (0 = off; "
        "corruption triggers a checkpoint restore)",
    )
    ap.add_argument(
        "--metrics-out", default=None,
        help="write an obs_metrics/v1 JSONL snapshot here at exit",
    )
    ap.add_argument(
        "--trace-out", default=None,
        help="write a Chrome trace-event JSON here at exit (spans on every "
        "pipeline thread; Perfetto / chrome://tracing)",
    )
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.arch != ARCH:
        from repro_torch.configs import get_config

        try:
            get_config(args.arch)
        except KeyError as e:
            ap.error(str(e))
        return train_lm(args)
    if args.tables < 0:
        ap.error("--tables must be >= 0 (0 = uniform paper config)")
    if args.trace and args.scenario:
        ap.error("--trace and --scenario are mutually exclusive")
    if args.adaptive_pad and not args.trace:
        ap.error("--adaptive-pad derives buckets from a recorded trace; pass --trace")
    if args.trace and not os.path.exists(os.path.join(args.trace, "manifest.json")):
        ap.error(f"--trace {args.trace}: not a recorded trace directory "
                 "(no manifest.json)")
    if (args.supervise or args.chaos) and args.record_trace:
        ap.error("--record-trace cannot ride a supervised run: a restart "
                 "would re-record already-captured batches")
    if (args.supervise or args.chaos) and args.runtime not in ("scratchpipe", "strawman"):
        ap.error("--supervise/--chaos cover the scratchpipe-family runtimes")
    if args.chaos:
        from repro_torch.chaos import ChaosPlan

        try:
            ChaosPlan.parse(args.chaos)
        except ValueError as e:
            ap.error(f"--chaos: {e}")
    tracer, metrics = obs_setup(args.trace_out, args.metrics_out)
    try:
        return train_dlrm(args)
    finally:
        obs_export(
            args.trace_out, args.metrics_out, tracer, metrics,
            provenance={
                "mode": "train", "arch": args.arch, "runtime": args.runtime,
                "executor": args.executor, "planner": args.planner,
                "device": args.device, "fused": bool(args.fused),
                "precision": args.precision, "steps": args.steps,
                "smoke": bool(args.smoke), "supervise": bool(args.supervise),
                "chaos": args.chaos,
            },
        )


if __name__ == "__main__":
    main()
