#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its kernels to their
plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card    — the card's name and power limit, as nvidia-smi gives them;
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc
               (one nvcc per source, all started together);
  3. kernels — each CUDA kernel against its plain version on the card,
               bitwise (torch.equal), over duplicates within and across
               bags, a slot repeated all through one bag, drop sentinels,
               fills gathered in the same call, empty operands (which must
               launch nothing), D in {8, 40, 128, 192}, L in {1, 3, 20} and
               the serving and training paths' own shapes;
  4. serve   — the main path: ``repro_torch.launch.serve`` with
               ``scratchpipe-serve`` at the full width of dlrm-scratchpipe
               (8 tables, D=128 fp32, 20 lookups per table, 2048 requests per
               micro-batch; inference_mix, queue depth 2, 24 micro-batches).
               One cut: 1M rows per table instead of 10M (the 10M host table
               is 41 GB of fp32). Launch counts are reset just before and
               read just after; the plain versions are made to raise during
               the run, so no CPU tensor reaches a kernel wrapper. The same
               batches then go through ``nocache-serve``: the bags must be
               bitwise equal, and the post-warm-up hit rate 1.000;
               Each serving stage's host time is summed on the way.
  5. timing  — each kernel at the operands the main path gave it (CUDA
               events, median, L2 flushed before each launch) beside its
               bound, its plain version and one PyTorch library call that
               computes the same function (a yardstick the port never calls).
  6. train   — the training path: ``repro_torch.launch.train.train_dlrm``
               at the full width of dlrm-scratchpipe (8 tables, D=128 fp32,
               20 lookups per table, batch 2048, bottom MLP 13-512-256-128,
               dot interaction, top MLP 164-1024-1024-512-256-1), 24 steps,
               seed 0: ``scratchpipe`` split, ``scratchpipe --fused``, then
               ``nocache``, each from a copy of one host table. One cut:
               1M rows per table instead of 10M, with the uncut config's
               4,000,000-slot scratchpad (cache_fraction 0.5 at the cut).
               Counts are reset just before each run and read just after;
               the plain versions raise during the runs. The losses of the
               three runs must be bitwise equal step by step, and so must
               the host tables after ``flush_to_host`` (TF32 off, cuBLAS
               workspace pinned); losses finite.
  7. timing  — ``scatter_add`` and ``fill_gather_reduce`` at the operands
               the training runs gave them, and ``gather_reduce`` again at
               the training bags.
  8. train q — the same training path at fp16 and int8 replica precision
               (``--precision``, ``stochastic`` rounding, the launcher's
               default): fp16 split, fp16 fused, int8 split, int8 fused, 24
               steps each, from copies of the same host table, in a nominal
               budget of 1,000,000 fp32-row slots (cache_fraction 0.125 at
               the cut): fp16 holds 2,000,000 rows and evicts (checked), so
               the victim read, its d2h and the dequantized write-back run on
               the card; int8 holds 4,000,000. Per precision the split and
               fused losses and flushed host tables must be bitwise equal,
               and every step's loss within 1e-2 (fp16) / 1e-1 (int8)
               relative of the fp32 split run's; launch counts as designed,
               the plain versions raise.
  9. timing  — ``gather_reduce_q``, ``fill_gather_reduce_q`` and the fp16/
               int8 forms of ``gather_reduce``, ``fill`` and
               ``fill_gather_reduce`` at the operands of the middle step of
               phase 8, and the plain ``requantize_update`` epilogue.

The sweep of phase 3 covers the fp16 and int8 forms too. The last three lines are the ``kernels`` JSON line, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS picks a fixed reduction order only with a pinned workspace; set
# before CUDA starts (the three training runs must agree bitwise)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/gather_reduce.cu"
CU_SOURCE_BWD = "src/repro_torch/kernels/csrc/grad_coalesce.cu"
DEVICE = "cuda"
# the serving slice at the full width of dlrm-scratchpipe
# (src/repro/configs/base.py: DLRMConfig), cut to 1M rows per table
TABLES, ROWS, DIM, LOOKUPS, BATCH = 8, 1_000_000, 128, 20, 2048
STEPS, DEPTH, CACHE_FRAC = 24, 2, 0.25
# the training slice: the same width and cut; the scratchpad keeps the uncut
# config's 0.05 x 80M = 4,000,000 slots (above the 6 x 327,680-row window floor)
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_CACHE_FRAC = 24, 6, 0.5
TRAIN_RUNS = (("scratchpipe split", "scratchpipe", False),
              ("scratchpipe fused", "scratchpipe", True),
              ("nocache", "nocache", False))
# the reduced-precision slice: the same width and cut, a nominal budget of
# 1,000,000 fp32-row slots (cache_fraction 0.125 of the 8M rows): fp16 holds
# 2,000,000 rows and evicts after ~15 steps of ~130k misses, int8 4,000,000
Q_CACHE_FRAC, Q_NOMINAL_SLOTS = 0.125, 1_000_000
Q_MULT = {"fp16": 2, "int8": 4}
Q_RUNS = (("fp16 split", "fp16", False), ("fp16 fused", "fp16", True),
          ("int8 split", "int8", False), ("int8 fused", "int8", True))
# each step's loss against the fp32 split run's: the reference's P3 bounds
# (tests/test_precision_parity.py)
Q_LOSS_RTOL = {"fp16": 1e-2, "int8": 1e-1}


def serve_args(design: str) -> list:
    return [
        "--embedding", "--design", design, "--scenario", "inference_mix",
        "--steps", str(STEPS), "--depth", str(DEPTH), "--tables", str(TABLES),
        "--rows", str(ROWS), "--dim", str(DIM), "--lookups", str(LOOKUPS),
        "--batch", str(BATCH), "--cache-frac", str(CACHE_FRAC), "--seed", "0",
        "--device", DEVICE,
    ]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------------- #
def zipf_ids(torch, g, shape, n_rows: int, s: float = 0.77):
    """Ids with the training stream's skew (data/synthetic.py: the medium
    locality's Zipf exponent), scattered over [0, n_rows)."""
    u = torch.rand(shape, generator=g, dtype=torch.float64)
    ranks = torch.clamp((n_rows * u ** (1.0 / (1.0 - s))).long(), max=n_rows - 1)
    return ((ranks * 2_654_435_761) % n_rows).to(torch.int32)


#: launch-count keys of the reduced-precision forms: (gather, fill, fused)
Q_KEYS = {"fp16": ("gather_reduce_f16", "fill_f16", "fill_gather_reduce_f16"),
          "int8": ("gather_reduce_q", "fill_i8", "fill_gather_reduce_q")}


def sweep_kernels(torch, ops, ref, qz, dev) -> dict:
    """Bitwise sweep; returns the largest |kernel - plain| per kernel."""
    g = torch.Generator(device="cpu").manual_seed(0)
    err = {"gather_reduce": 0.0, "fill": 0.0, "scatter_add": 0.0,
           "fill_gather_reduce": 0.0}
    err.update({k: 0.0 for keys in Q_KEYS.values() for k in keys})

    def q_storage(N, D, precision):
        """Quantized rows on the card: fp16, or an int8 payload with snapped
        per-row scales (scale None for fp16)."""
        if precision == "fp16":
            return (torch.randn(N, D, generator=g) * 0.1).half().to(dev), None
        data = torch.randint(-127, 128, (N, D), generator=g, dtype=torch.int8)
        scale = qz._snap_scale(torch.rand(N, 1, generator=g) * 1e-2 + 1e-4)
        return data.to(dev), scale.to(dev)

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0

    def gather_q_case(N, D, nb, L, precision, ids):
        data, scale = q_storage(N, D, precision)
        key = Q_KEYS[precision][0]
        ids = ids.to(dev)
        before = ops.launch_counts()[key]
        got = ops.gather_reduce_q(data, scale, ids)
        want = ref.gather_reduce_q_ref(data, scale, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()[key] == before + 1, f"{key} launch count")
        check(got.dtype == torch.float32 and torch.equal(got, want),
              f"{key} differs at N={N} D={D} nb={nb} L={L}")
        err[key] = max(err[key], diff(got, want))

    def fill_q_case(N, D, n_valid, F, precision):
        st = q_storage(N, D, precision)[0]
        slots = torch.full((F,), N, dtype=torch.int32)  # drop sentinels
        slots[torch.randperm(F, generator=g)[:n_valid]] = (
            torch.randperm(N, generator=g)[:n_valid].to(torch.int32))
        rows, slots = q_storage(F, D, precision)[0], slots.to(dev)
        key = Q_KEYS[precision][1]
        before = ops.launch_counts()[key]
        got = ops.fill(st.clone(), slots, rows)
        want = ref.fill_ref(st.clone(), slots, rows)
        torch.cuda.synchronize()
        check(ops.launch_counts()[key] == before + 1, f"{key} launch count")
        check(torch.equal(got, want), f"{key} differs at N={N} D={D} F={F}")
        err[key] = max(err[key], diff(got, want))

    def fused_q_case(N, D, F, n_valid, nb, L, precision):
        data, scale = q_storage(N, D, precision)
        slots = torch.full((F,), N, dtype=torch.int32)
        slots[torch.randperm(F, generator=g)[:n_valid]] = (
            torch.randperm(N, generator=g)[:n_valid].to(torch.int32))
        filled = slots[slots < N]
        ids = torch.where(
            torch.rand(nb, L, generator=g) < 0.5,
            filled[torch.randint(0, filled.numel(), (nb, L), generator=g)],
            torch.randint(0, N, (nb, L), generator=g, dtype=torch.int32))
        rows, rows_scale = q_storage(F, D, precision)
        slots, ids = slots.to(dev), ids.to(dev)
        if scale is not None:  # the scale column is scattered before the launch
            keep = slots < N
            scale[slots[keep].long()] = rows_scale[keep]
        key = Q_KEYS[precision][2]
        before = ops.launch_counts()[key]
        got_st, got = ops.fill_gather_reduce_q(data.clone(), scale, slots, rows, ids)
        want_st, want = ref.fill_gather_reduce_q_ref(data.clone(), scale, slots, rows, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()[key] == before + 1, f"{key} launch count")
        check(torch.equal(got_st, want_st) and torch.equal(got, want),
              f"{key} differs at N={N} D={D} F={F} nb={nb} L={L}")
        err[key] = max(err[key], diff(got, want), diff(got_st, want_st))

    def scatter_case(N, D, ids, scale=1.0):
        nb = ids.shape[0]
        st = torch.randn(N, D, generator=g).to(dev)
        deltas = (torch.randn(nb, D, generator=g) * scale).to(dev)
        ids = ids.to(dev)
        before = ops.launch_counts()["scatter_add"]
        got = ops.coalesce_deltas(st.clone(), ids, deltas)
        want = ref.scatter_add_ref(st.clone(), ids, deltas)
        torch.cuda.synchronize()
        check(ops.launch_counts()["scatter_add"] == before + 1, "scatter_add launch count")
        check(torch.equal(got, want),
              f"scatter_add differs at N={N} D={D} ids={tuple(ids.shape)}")
        err["scatter_add"] = max(err["scatter_add"], (got - want).abs().max().item())

    def fused_case(N, D, F, n_valid, nb, L, ids=None):
        st = torch.randn(N, D, generator=g).to(dev)
        slots = torch.full((F,), N, dtype=torch.int32)  # drop sentinels
        slots[torch.randperm(F, generator=g)[:n_valid]] = (
            torch.randperm(N, generator=g)[:n_valid].to(torch.int32))
        if ids is None:  # half the lookups read a slot filled in this call
            filled = slots[slots < N]
            ids = torch.where(
                torch.rand(nb, L, generator=g) < 0.5,
                filled[torch.randint(0, filled.numel(), (nb, L), generator=g)],
                torch.randint(0, N, (nb, L), generator=g, dtype=torch.int32))
        rows = torch.randn(F, D, generator=g).to(dev)
        slots, ids = slots.to(dev), ids.to(dev)
        before = ops.launch_counts()["fill_gather_reduce"]
        got_st, got = ops.fill_gather_reduce(st.clone(), slots, rows, ids)
        want_st, want = ref.fill_gather_reduce_ref(st.clone(), slots, rows, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()["fill_gather_reduce"] == before + 1,
              "fill_gather_reduce launch count")
        check(torch.equal(got_st, want_st) and torch.equal(got, want),
              f"fill_gather_reduce differs at N={N} D={D} F={F} nb={nb} L={L}")
        err["fill_gather_reduce"] = max(
            err["fill_gather_reduce"], (got - want).abs().max().item(),
            (got_st - want_st).abs().max().item())

    def gather_case(N, D, nb, L, id_hi):
        st = torch.randn(N, D, generator=g).to(dev)
        ids = torch.randint(0, id_hi, (nb, L), generator=g, dtype=torch.int32).to(dev)
        before = ops.launch_counts()["gather_reduce"]
        got = ops.gather_reduce(st, ids)
        want = ref.gather_reduce_ref(st, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()["gather_reduce"] == before + 1, "gather launch count")
        check(torch.equal(got, want), f"gather_reduce differs at N={N} D={D} nb={nb} L={L}")
        err["gather_reduce"] = max(err["gather_reduce"], (got - want).abs().max().item())

    def fill_case(N, D, n_valid, F):
        st = torch.randn(N, D, generator=g).to(dev)
        slots = torch.full((F,), N, dtype=torch.int32)  # drop sentinels
        pos = torch.randperm(F, generator=g)[:n_valid]
        slots[pos] = torch.randperm(N, generator=g)[:n_valid].to(torch.int32)
        rows = torch.randn(F, D, generator=g).to(dev)
        slots = slots.to(dev)
        before = ops.launch_counts()["fill"]
        got = ops.fill(st.clone(), slots, rows)
        want = ref.fill_ref(st.clone(), slots, rows)
        torch.cuda.synchronize()
        check(ops.launch_counts()["fill"] == before + 1, "fill launch count")
        check(torch.equal(got, want), f"fill differs at N={N} D={D} F={F}")
        err["fill"] = max(err["fill"], (got - want).abs().max().item())

    for D in (8, 40, 128, 192):
        for L in (1, 3, 20):
            gather_case(4096, D, 257, L, 64)  # ids < 64: duplicates everywhere
            gather_case(4096, D, 33, L, 4096)
            scatter_case(4096, D, torch.randint(0, 64, (257, L), generator=g,
                                                dtype=torch.int32))
            scatter_case(4096, D, torch.randint(0, 4096, (33, L), generator=g,
                                                dtype=torch.int32))
            fused_case(4096, D, 1024, 1000, 257, L)
        fill_case(4096, D, 1000, 1024)
        fill_case(4096, D, 4096, 4096)  # every slot, no sentinel
        fused_case(4096, D, 4096, 4096, 100, 3)  # every slot filled
    # a slot repeated all through one bag, one row in every bag, and deltas
    # whose magnitudes make any reordering of the adds show
    rep = torch.randint(0, 64, (200, 20), generator=g, dtype=torch.int32)
    rep[0] = 5
    rep[:, 7] = 9
    scatter_case(64, 128, rep, scale=1e6)
    st = torch.randn(64, 40, generator=g).to(dev)
    dup = torch.tensor([[3, 3, 3, 5], [5, 3, 5, 3], [0, 0, 0, 0]], dtype=torch.int32)
    check(torch.equal(ops.gather_reduce(st, dup.to(dev)),
                      ref.gather_reduce_ref(st, dup.to(dev))), "explicit duplicates")
    # the fp16 and int8 forms over the same sweep; D=3 copies 6- and 3-byte
    # rows (2- and 1-byte chunks)
    for precision in Q_KEYS:
        for D in (8, 40, 128, 192):
            for L in (1, 3, 20):
                gather_q_case(4096, D, 257, L, precision,
                              torch.randint(0, 64, (257, L), generator=g, dtype=torch.int32))
                gather_q_case(4096, D, 33, L, precision,
                              torch.randint(0, 4096, (33, L), generator=g, dtype=torch.int32))
                fused_q_case(4096, D, 1024, 1000, 257, L, precision)
            fill_q_case(4096, D, 1000, 1024, precision)
            fill_q_case(4096, D, 4096, 4096, precision)
            fused_q_case(4096, D, 4096, 4096, 100, 3, precision)
        fill_q_case(4096, 3, 1000, 1024, precision)
    # the slice's shapes: the serving scratchpad (2M slots), BATCH x TABLES
    # bags of LOOKUPS, and a pow-2 padded fill of an eighth of the slots
    slots = max(int(TABLES * ROWS * CACHE_FRAC),
                TABLES * min(ROWS, BATCH * LOOKUPS * (DEPTH + 2)))
    gather_case(slots, DIM, BATCH * TABLES, LOOKUPS, slots)
    fill_case(slots, DIM, slots // 10, 1 << (slots // 8 - 1).bit_length())
    # the training path's shapes: a 4M-slot scratchpad, BATCH x TABLES bags
    # of LOOKUPS Zipf-skewed slots, a pow-2 padded fill of ~200k rows
    n_train = int(TABLES * ROWS * TRAIN_CACHE_FRAC)
    train_ids = zipf_ids(torch, g, (BATCH * TABLES, LOOKUPS), n_train)
    scatter_case(n_train, DIM, train_ids, scale=1e-3)
    fused_case(n_train, DIM, 1 << 18, min(200_000, n_train // 2), BATCH * TABLES, LOOKUPS)
    # the reduced-precision runs' shapes: 2M fp16 and 4M int8 rows in the
    # nominal 1M-row budget
    for precision in Q_KEYS:
        n_q = Q_NOMINAL_SLOTS * Q_MULT[precision]
        gather_q_case(n_q, DIM, BATCH * TABLES, LOOKUPS, precision,
                      zipf_ids(torch, g, (BATCH * TABLES, LOOKUPS), n_q))
        fused_q_case(n_q, DIM, 1 << 18, min(200_000, n_q // 2), BATCH * TABLES, LOOKUPS,
                     precision)

    before = ops.launch_counts()
    for shape in ((0, 5), (3, 0), (0, 0)):
        out = ops.gather_reduce(st, torch.zeros(shape, dtype=torch.int32, device=dev))
        check(out.shape == shape[:-1] + (40,) and not out.any(), "empty gather result")
    no_ids = torch.zeros(0, dtype=torch.int32, device=dev)
    ops.fill(st, no_ids, torch.zeros(0, 40, device=dev))
    for shape in ((0, 5), (3, 0)):
        ids = torch.zeros(shape, dtype=torch.int32, device=dev)
        ops.coalesce_apply(st, ids, torch.zeros(shape[0], 40, device=dev), 0.1)
        ops.coalesce_deltas(st, ids, torch.zeros(shape[0], 40, device=dev))
        ops.fill_gather_reduce(st, no_ids, torch.zeros(0, 40, device=dev), ids)
        for precision in Q_KEYS:
            data, scale = q_storage(8, 40, precision)
            ops.gather_reduce_q(data, scale, ids)
            ops.fill_gather_reduce_q(data, scale, no_ids, data[:0], ids)
            ops.fill(data, no_ids, data[:0])
    torch.cuda.synchronize()
    check(ops.launch_counts() == before, "an empty operand launched a kernel")
    return err


# --------------------------------------------------------------------------- #
# 4. the main path
# --------------------------------------------------------------------------- #
def stage_timers(targets):
    """Wrap stage methods with host-clock timers: ``targets`` is a list of
    (object, attribute, label). They add two clock reads per call and no
    synchronization, so a stage's queued device work is charged to the
    stage that next waits for the device. Returns (stages — seconds and
    calls per label —, ends — the clock at each call's return, per label —,
    restore)."""
    stages, ends = {}, {}
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]

    def timed(fn, label):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t1 = time.perf_counter()
                st = stages.setdefault(label, {"s": 0.0, "calls": 0})
                st["s"] += t1 - t0
                st["calls"] += 1
                ends.setdefault(label, []).append(t1)
        return wrapper

    for (obj, name, label), (_, _, fn) in zip(targets, saved):
        setattr(obj, name, timed(fn, label))

    def restore():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return stages, ends, restore


def serve_targets(serving_cache):
    cls = serving_cache.ReadOnlyCacheServer
    return [(cls, "serve_next", "serve (whole cycle)"),
            (cls, "_plan_entry", "plan"), (cls, "_fetch", "exchange (host gather)"),
            (cls, "_insert", "insert (h2d + fill)"),
            (cls, "_emergency_fill", "emergency fill"),
            (serving_cache, "_lookup_bags", "lookup (h2d ids + gather + d2h bags)")]


def serve_main_path(torch, ops, ref, serve, serving_cache):
    """Run scratchpipe-serve through the launcher; returns (result,
    launch counts of the run, captured kernel operands, stage times)."""
    captured = {"gather": None, "fill": None, "fill_sizes": []}
    real_gather, real_fill = ops.gather_reduce, ops.fill
    real_refs = (ref.gather_reduce_ref, ref.fill_ref)

    def spy_gather(storage, slot_ids):
        captured["gather"] = (storage, slot_ids)
        return real_gather(storage, slot_ids)

    def spy_fill(storage, fill_slots, rows):
        captured["fill_sizes"].append(int(fill_slots.numel()))
        best = captured["fill"]
        if best is None or fill_slots.numel() > best[0].numel():
            captured["fill"] = (fill_slots.clone(), rows.clone())
        return real_fill(storage, fill_slots, rows)

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    args = serve.build_parser().parse_args(serve_args("scratchpipe-serve"))
    ops.gather_reduce, ops.fill = spy_gather, spy_fill
    ref.gather_reduce_ref = ref.fill_ref = no_plain
    stages, _, restore = stage_timers(serve_targets(serving_cache))
    try:
        ops.reset_launch_counts()
        res = serve.run_embedding(args, collect_bags=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        restore()
        ops.gather_reduce, ops.fill = real_gather, real_fill
        ref.gather_reduce_ref, ref.fill_ref = real_refs
    return res, counts, captured, stages


# --------------------------------------------------------------------------- #
# 5. timing
# --------------------------------------------------------------------------- #
def median_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events
    around each launch; the L2 is flushed before each, as a serve finds
    it after its other work)."""
    for _ in range(2):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def time_kernels(torch, ops, ref, gr, captured, counts, sweep_err, dev):
    import torch.nn.functional as F

    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2

    storage, slot_ids = captured["gather"]
    L = slot_ids.shape[-1]
    flat = slot_ids.reshape(-1, L).contiguous()
    nb, D = flat.shape[0], storage.shape[1]
    got, want = gr.gather_reduce(storage, flat), ref.gather_reduce_ref(storage, flat)
    check(torch.equal(got, want), "gather_reduce differs at the main path's operands")
    n_unique = int(torch.unique(flat).numel())
    g_bytes = n_unique * D * 4 + flat.numel() * 4 + nb * D * 4
    g_ops = nb * (L - 1) * D
    long_ids = flat.long()
    gather = {
        "name": "gather_reduce", "route": "cuda", "source": CU_SOURCE,
        "replaces": "src/repro/kernels/gather_reduce.py:55",
        "launches": counts["gather_reduce"],
        "max_abs_err": max(sweep_err["gather_reduce"], (got - want).abs().max().item()),
        "ms": median_ms(torch, lambda: gr.gather_reduce(storage, flat), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.gather_reduce_ref(storage, flat), 10, flush),
        "bound_ms": max(g_bytes / HBM_BYTES_PER_S, g_ops / FP32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if g_bytes / HBM_BYTES_PER_S >= g_ops / FP32_OPS_PER_S else "operations",
        "library_ms": median_ms(
            torch, lambda: F.embedding_bag(long_ids, storage, mode="sum"), 30, flush),
    }

    slots, rows = captured["fill"]
    valid = slots < storage.shape[0]
    n_valid = int(valid.sum().item())
    scratch = storage.clone()
    gr.fill(scratch, slots, rows)
    want_st = ref.fill_ref(storage.clone(), slots, rows)
    check(torch.equal(scratch, want_st), "fill differs at the main path's operands")
    fill_err = (scratch - want_st).abs().max().item()
    del want_st
    f_bytes = 2 * n_valid * D * 4 + slots.numel() * 4
    v_slots, v_rows = slots[valid].long(), rows[valid]
    fill = {
        "name": "fill", "route": "cuda", "source": CU_SOURCE,
        "replaces": "src/repro/kernels/gather_reduce.py:146",
        "launches": counts["fill"],
        "max_abs_err": max(sweep_err["fill"], fill_err),
        "ms": median_ms(torch, lambda: gr.fill(scratch, slots, rows), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.fill_ref(scratch, slots, rows), 10, flush),
        "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": median_ms(
            torch, lambda: scratch.index_copy_(0, v_slots, v_rows), 30, flush),
    }
    details = {
        "gather_reduce": {"storage": list(storage.shape), "bags": nb, "L": L,
                          "unique_rows": n_unique, "bytes": g_bytes,
                          "no_reuse_bound_ms": (nb * L * D * 4 + flat.numel() * 4
                                                + nb * D * 4) / HBM_BYTES_PER_S * 1e3},
        "fill": {"F": int(slots.numel()), "valid_rows": n_valid, "bytes": f_bytes,
                 "fill_calls": len(captured["fill_sizes"]),
                 "F_per_call": captured["fill_sizes"]},
    }
    return [gather, fill], details


# --------------------------------------------------------------------------- #
# 6. the training path
# --------------------------------------------------------------------------- #
PLAIN_VERSIONS = ("gather_reduce_ref", "fill_ref", "fill_gather_reduce_ref",
                  "scatter_add_ref", "coalesce_apply_ref", "gather_reduce_q_ref",
                  "fill_gather_reduce_q_ref")
TRAIN_STEP_LABEL = {"scratchpipe": "train (fwd + bwd + update)",
                    "nocache": "step (whole nocache step)"}


def train_targets(pipeline, static_cache, dlrm_runtime):
    sp, tr = pipeline.ScratchPipe, dlrm_runtime.DLRMTrainer
    return [(sp, "_stage_plan", "plan"),
            (sp, "_stage_collect", "collect (host gather + victim read)"),
            (sp, "_stage_exchange", "exchange (h2d rows + d2h victims)"),
            (sp, "_stage_insert_host", "insert host (write-back)"),
            (sp, "_stage_insert_fill", "insert fill"),
            (sp, "_stage_train", TRAIN_STEP_LABEL["scratchpipe"]),
            (tr, "fused_train_fn", "fused fill + train calls"),
            (static_cache.NoCacheBaseline, "_step", TRAIN_STEP_LABEL["nocache"])]


def train_run(torch, mods, cfg, base_table, name, runtime, fused, captured):
    """One training run through the launcher's ``train_dlrm`` from a copy of
    ``base_table``; the plain versions raise during it. Captures kernel
    operands of the middle step into ``captured``. Returns (result, launch
    counts of the run, stage times, ms/step after the warm-up)."""
    ops, ref, gr, gc = mods["ops"], mods["ref"], mods["gr"], mods["gc"]
    at = TRAIN_STEPS // 2
    calls = {"gather": 0, "scatter": 0, "fused": 0}
    real = {"gather": ops.gather_reduce, "scatter": gc.scatter_add,
            "fused": gr.fill_gather_reduce}
    real_refs = {n: getattr(ref, n) for n in PLAIN_VERSIONS}

    def spy_gather(storage, slot_ids):
        calls["gather"] += 1
        if name == "scratchpipe split" and calls["gather"] == at:
            captured["train_gather"] = (storage, slot_ids)
        return real["gather"](storage, slot_ids)

    def spy_scatter(storage, flat_ids, deltas):
        calls["scatter"] += 1
        if name == "scratchpipe split" and calls["scatter"] == at:
            captured["scatter"] = (storage.clone(), flat_ids.clone(), deltas.clone())
        return real["scatter"](storage, flat_ids, deltas)

    def spy_fused(storage, fill_slots, rows, flat_ids):
        calls["fused"] += 1
        if calls["fused"] == at:
            captured["fused"] = (storage.clone(), fill_slots.clone(), rows.clone(),
                                 flat_ids.clone())
        return real["fused"](storage, fill_slots, rows, flat_ids)

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    argv = ["--arch", "dlrm-scratchpipe", "--steps", str(TRAIN_STEPS), "--batch",
            str(BATCH), "--seed", "0", "--runtime", runtime, "--device", DEVICE]
    args = mods["train"].build_parser().parse_args(argv + (["--fused"] if fused else []))
    host = mods["HostEmbeddingTable"](base_table.shape[0], base_table.shape[1],
                                      data=base_table.copy())
    ops.gather_reduce, gc.scatter_add, gr.fill_gather_reduce = (
        spy_gather, spy_scatter, spy_fused)
    for n in PLAIN_VERSIONS:
        setattr(ref, n, no_plain)
    stages, ends, restore = stage_timers(
        train_targets(mods["pipeline"], mods["static_cache"], mods["dlrm_runtime"]))
    try:
        ops.reset_launch_counts()
        res = mods["train"].train_dlrm(args, cfg=cfg, host=host)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        restore()
        ops.gather_reduce, gc.scatter_add, gr.fill_gather_reduce = (
            real["gather"], real["scatter"], real["fused"])
        for n, fn in real_refs.items():
            setattr(ref, n, fn)
    step_ends = ends[TRAIN_STEP_LABEL[runtime]]
    ms_per_step = ((step_ends[-1] - step_ends[TRAIN_WARMUP - 1])
                   / (len(step_ends) - TRAIN_WARMUP) * 1e3)
    return res, counts, stages, ms_per_step


def check_train_counts(name, stats, counts, stages):
    """Every kernel of the run's path fired, and only where it should."""
    n = len(stats)
    with_fills = sum(1 for st in stats if st.n_miss > 0)
    check(n == TRAIN_STEPS and with_fills > 0, f"{name}: {n} steps, {with_fills} with fills")
    check(counts["scatter_add"] == n, f"{name}: one scatter_add per step: {counts}")
    if name == "scratchpipe split":
        check(counts["gather_reduce"] == n and counts["fill"] == with_fills
              and counts["fill_gather_reduce"] == 0, f"{name}: launches {counts}")
    elif name == "scratchpipe fused":
        fused = stages.get("fused fill + train calls", {}).get("calls", 0)
        check(counts["fill_gather_reduce"] == fused > 0
              and counts["fill_gather_reduce"] + counts["fill"] == with_fills
              and counts["fill_gather_reduce"] + counts["gather_reduce"] == n,
              f"{name}: launches {counts}, fused cycles {fused}")
    else:
        check(counts["gather_reduce"] == n and counts["fill"] == 0
              and counts["fill_gather_reduce"] == 0, f"{name}: launches {counts}")


def train_main_path(torch, mods, dev):
    """The three training runs on copies of one host table; returns
    (summaries, launch counts per run, captured operands, the host table,
    the losses)."""
    cfg = mods["DLRMConfig"](rows_per_table=ROWS, cache_fraction=TRAIN_CACHE_FRAC)
    check((cfg.num_tables, cfg.embed_dim, cfg.lookups_per_table) == (TABLES, DIM, LOOKUPS)
          and cfg.bottom_mlp == (512, 256, 128)
          and cfg.top_mlp == (1024, 1024, 512, 256, 1)
          and mods["interaction_dim"](cfg) == 164, "the training config is not full width")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    base = mods["HostEmbeddingTable"](cfg.total_rows, cfg.embed_dim, seed=0).data
    log(f"train: host table {base.shape} fp32 built in {time.perf_counter() - t0:.1f}s")
    captured, summaries, counts_by_run = {}, [], {}
    first_losses = first_table = None
    for name, runtime, fused in TRAIN_RUNS:
        t0 = time.perf_counter()
        res, counts, stages, ms = train_run(torch, mods, cfg, base, name, runtime,
                                            fused, captured)
        stats, pipe = res["stats"], res["pipe"]
        check(pipe.device.type == dev.type, f"{name}: the runtime is not on the card")
        check_train_counts(name, stats, counts, stages)
        losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
        check(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
        pipe.flush_to_host()
        table = res["host"].data
        if first_losses is None:
            first_losses, first_table = losses, table
        else:
            check(torch.equal(losses, first_losses),
                  f"{name}: losses differ from {TRAIN_RUNS[0][0]} at steps "
                  f"{torch.nonzero(losses != first_losses).flatten().tolist()}")
            check(first_table.shape == table.shape and (first_table == table).all(),
                  f"{name}: flushed host table differs from {TRAIN_RUNS[0][0]}")
        tr = pipe.traffic()
        summaries.append({
            "run": name, "ms_per_step": ms, "warmup_steps": TRAIN_WARMUP,
            "plan_hit": res["plan_hit"], "wall_s": res["wall_s"],
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
            "launches": counts, "stages_s": stages,
            "scratchpad_slots": int(getattr(pipe, "num_slots", 0)),
        })
        print("train: " + json.dumps(summaries[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"train: {name} done ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, table
    log(f"train: losses of all {TRAIN_STEPS} steps and the flushed host tables bitwise "
        f"equal across {', '.join(r[0] for r in TRAIN_RUNS)}")
    return summaries, counts_by_run, captured, base, first_losses


# --------------------------------------------------------------------------- #
# 7. timing at the training operands
# --------------------------------------------------------------------------- #
def bound(n_bytes: int, n_ops: int):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_train_kernels(torch, ops, ref, gr, gc, captured, dev):
    """Times of gather_reduce, scatter_add and fill_gather_reduce at the
    training run's operands; returns ({kernel: numbers}, details)."""
    import torch.nn.functional as F

    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    out, details = {}, {}

    storage, slot_ids = captured["train_gather"]
    L = slot_ids.shape[-1]
    flat = slot_ids.reshape(-1, L).contiguous()
    nb, D = flat.shape[0], storage.shape[1]
    got, want = gr.gather_reduce(storage, flat), ref.gather_reduce_ref(storage, flat)
    check(torch.equal(got, want), "gather_reduce differs at the training operands")
    n_unique = int(torch.unique(flat).numel())
    b_ms, b_by = bound(n_unique * D * 4 + flat.numel() * 4 + nb * D * 4, nb * (L - 1) * D)
    long_ids = flat.long()
    out["gather_reduce"] = {
        "ms": median_ms(torch, lambda: gr.gather_reduce(storage, flat), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.gather_reduce_ref(storage, flat), 10, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(
            torch, lambda: F.embedding_bag(long_ids, storage, mode="sum"), 30, flush),
        "max_abs_err": (got - want).abs().max().item(),
    }
    details["gather_reduce"] = {"storage": list(storage.shape), "bags": nb, "L": L,
                                "unique_rows": n_unique}

    st0, flat, deltas = captured["scatter"]
    nb, L = flat.shape
    got = st0.clone()
    gc.scatter_add(got, flat, deltas)
    want = ref.scatter_add_ref(st0.clone(), flat, deltas)
    check(torch.equal(got, want), "scatter_add differs at the training operands")
    err = (got - want).abs().max().item()
    del got, want
    n_unique = int(torch.unique(flat).numel())
    seg = torch.unique(flat, return_counts=True)[1]
    b_ms, b_by = bound(2 * n_unique * D * 4 + flat.numel() * 4 + nb * D * 4, flat.numel() * D)
    scratch = st0.clone()
    keys, perm = gc.sort_by_slot(flat)
    dup, idx = deltas.repeat_interleave(L, dim=0), flat.reshape(-1).long()
    out["scatter_add"] = {
        "ms": median_ms(torch, lambda: gc.scatter_add(scratch, flat, deltas), 30, flush),
        "sort_ms": median_ms(torch, lambda: gc.sort_by_slot(flat), 30, flush),
        "accumulate_ms": median_ms(
            torch, lambda: gc.scatter_add_sorted(scratch, keys, perm, deltas, L), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.scatter_add_ref(scratch, flat, deltas), 3, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(torch, lambda: scratch.index_add_(0, idx, dup), 30, flush),
        "max_abs_err": err,
    }
    details["scatter_add"] = {"storage": list(st0.shape), "bags": nb, "L": L,
                              "unique_rows": n_unique, "longest_segment": int(seg.max()),
                              "sort": "torch.sort(stable=True), timed apart as sort_ms"}
    del st0, scratch, dup, idx, keys, perm, captured["scatter"]

    st0, slots, rows, flat = captured["fused"]
    nb, L = flat.shape
    got_st = st0.clone()
    got = gr.fill_gather_reduce(got_st, slots, rows, flat)
    want_st, want = ref.fill_gather_reduce_ref(st0.clone(), slots, rows, flat)
    check(torch.equal(got_st, want_st) and torch.equal(got, want),
          "fill_gather_reduce differs at the training operands")
    err = max((got - want).abs().max().item(), (got_st - want_st).abs().max().item())
    del got_st, want_st
    valid = slots < st0.shape[0]
    n_valid = int(valid.sum().item())
    n_unique = int(torch.unique(flat).numel())
    b_ms, b_by = bound(2 * n_valid * D * 4 + slots.numel() * 4 + n_unique * D * 4
                       + flat.numel() * 4 + nb * D * 4, nb * (L - 1) * D)
    scratch = st0.clone()
    v_slots, v_rows, long_ids = slots[valid].long(), rows[valid], flat.long()

    def library():
        scratch.index_copy_(0, v_slots, v_rows)
        return F.embedding_bag(long_ids, scratch, mode="sum")

    out["fill_gather_reduce"] = {
        "ms": median_ms(torch, lambda: gr.fill_gather_reduce(scratch, slots, rows, flat),
                        30, flush),
        "plain_ms": median_ms(
            torch, lambda: ref.fill_gather_reduce_ref(scratch, slots, rows, flat), 10, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(torch, library, 30, flush),
        "max_abs_err": err,
    }
    details["fill_gather_reduce"] = {
        "storage": list(st0.shape), "F": int(slots.numel()), "valid_rows": n_valid,
        "bags": nb, "L": L, "unique_rows": n_unique,
        "library": "index_copy_ + F.embedding_bag (two calls)"}
    del st0, scratch, captured["fused"]
    return out, details


# --------------------------------------------------------------------------- #
# 8. the reduced-precision training path
# --------------------------------------------------------------------------- #
def clone_args(torch, args):
    """Copies of a call's tensor arguments (an int8 pair stays a pair)."""
    def c(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            out = [c(a) for a in x]
            return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
        return x
    return tuple(c(a) for a in args)


def train_run_q(torch, mods, cfg, base_table, name, precision, fused, captured):
    """One reduced-precision run through ``train_dlrm`` (``--precision``,
    stochastic rounding) from a copy of ``base_table``; the plain versions
    raise during it. Captures the middle step's kernel and epilogue operands
    into ``captured`` under "<precision> <kernel>". Returns (result, launch
    counts, stage times, ms/step after the warm-up)."""
    ops, ref, gr, qz = mods["ops"], mods["ref"], mods["gr"], mods["qz"]
    at = TRAIN_STEPS // 2
    fused_names = ("fill_gather_reduce", "fill_gather_reduce_q")
    targets = [(gr, n) for n in ("gather_reduce", "gather_reduce_q", "fill") + fused_names]
    targets.append((qz, "requantize_update"))
    real = {n: getattr(m, n) for m, n in targets}
    real_refs = {n: getattr(ref, n) for n in PLAIN_VERSIONS}
    calls = {}

    def spy(n):
        fn = real[n]
        wanted = (n in fused_names) == fused  # split runs: the rest

        def wrapper(*a):
            calls[n] = calls.get(n, 0) + 1
            if wanted and calls[n] == at:
                captured[f"{precision} {n}"] = clone_args(torch, a)
            return fn(*a)
        return wrapper

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    argv = ["--arch", "dlrm-scratchpipe", "--steps", str(TRAIN_STEPS), "--batch",
            str(BATCH), "--seed", "0", "--runtime", "scratchpipe", "--device", DEVICE,
            "--precision", precision]
    args = mods["train"].build_parser().parse_args(argv + (["--fused"] if fused else []))
    host = mods["HostEmbeddingTable"](base_table.shape[0], base_table.shape[1],
                                      data=base_table.copy())
    for m, n in targets:
        setattr(m, n, spy(n))
    for n in PLAIN_VERSIONS:
        setattr(ref, n, no_plain)
    stages, ends, restore = stage_timers(
        train_targets(mods["pipeline"], mods["static_cache"], mods["dlrm_runtime"]))
    try:
        ops.reset_launch_counts()
        res = mods["train"].train_dlrm(args, cfg=cfg, host=host)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        restore()
        for m, n in targets:
            setattr(m, n, real[n])
        for n, fn in real_refs.items():
            setattr(ref, n, fn)
    step_ends = ends[TRAIN_STEP_LABEL["scratchpipe"]]
    ms_per_step = ((step_ends[-1] - step_ends[TRAIN_WARMUP - 1])
                   / (len(step_ends) - TRAIN_WARMUP) * 1e3)
    return res, counts, stages, ms_per_step


def check_q_counts(name, precision, fused, stats, counts, stages):
    """The run launched its precision's kernels where designed, no other
    form, one scatter_add per step."""
    gk, fk, fgk = Q_KEYS[precision]
    n = len(stats)
    with_fills = sum(1 for st in stats if st.n_miss > 0)
    check(n == TRAIN_STEPS and with_fills > 0, f"{name}: {n} steps, {with_fills} with fills")
    check(counts["scatter_add"] == n, f"{name}: one scatter_add per step: {counts}")
    other = {k: v for k, v in counts.items() if k not in (gk, fk, fgk, "scatter_add")}
    check(not any(other.values()), f"{name}: another form launched: {counts}")
    if not fused:
        check(counts[gk] == n and counts[fk] == with_fills and counts[fgk] == 0,
              f"{name}: launches {counts}")
    else:
        cycles = stages.get("fused fill + train calls", {}).get("calls", 0)
        check(counts[fgk] == cycles > 0 and counts[fgk] + counts[fk] == with_fills
              and counts[fgk] + counts[gk] == n,
              f"{name}: launches {counts}, fused cycles {cycles}")


def train_q_main_path(torch, mods, dev, base, fp32_losses):
    """fp16 and int8, split and fused, on copies of ``base``. Per precision
    the split and fused losses and flushed host tables must be bitwise
    equal; every step's loss within Q_LOSS_RTOL of ``fp32_losses``; the
    fp16 runs must evict. Returns (summaries, launch counts per run,
    captured operands)."""
    cfg = mods["DLRMConfig"](rows_per_table=ROWS, cache_fraction=Q_CACHE_FRAC)
    check(int(cfg.total_rows * cfg.cache_fraction) == Q_NOMINAL_SLOTS,
          "the nominal budget is not 1,000,000 fp32-row slots")
    captured, summaries, counts_by_run, split = {}, [], {}, {}
    for name, precision, fused in Q_RUNS:
        t0 = time.perf_counter()
        res, counts, stages, ms = train_run_q(torch, mods, cfg, base, name, precision,
                                              fused, captured)
        stats, pipe = res["stats"], res["pipe"]
        check(pipe.device.type == dev.type and pipe.precision == precision
              and pipe.num_slots == Q_NOMINAL_SLOTS * Q_MULT[precision]
              and pipe.nominal_slots == Q_NOMINAL_SLOTS,
              f"{name}: the runtime is not the {precision} one on the card")
        check_q_counts(name, precision, fused, stats, counts, stages)
        losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
        check(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
        rel = ((losses - fp32_losses).abs() / fp32_losses.abs()).max().item()
        check(rel <= Q_LOSS_RTOL[precision],
              f"{name}: loss {rel:.3g} relative from fp32 > {Q_LOSS_RTOL[precision]}")
        evicted = sum(st.n_evict for st in stats)
        if precision == "fp16":
            check(evicted > 0, f"{name}: nothing was evicted")
        pipe.flush_to_host()
        table = res["host"].data
        if not fused:
            split[precision] = (losses, table)
        else:
            s_losses, s_table = split.pop(precision)
            check(torch.equal(losses, s_losses),
                  f"{name}: losses differ from the split run at steps "
                  f"{torch.nonzero(losses != s_losses).flatten().tolist()}")
            check((s_table == table).all(), f"{name}: flushed host table differs from split")
        tr = pipe.traffic()
        summaries.append({
            "run": name, "precision": precision, "rounding": res["cfg"].rounding,
            "ms_per_step": ms, "warmup_steps": TRAIN_WARMUP,
            "plan_hit": res["plan_hit"], "wall_s": res["wall_s"],
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "max_rel_loss_vs_fp32": rel, "evicted_rows": evicted,
            "evicting_steps": sum(1 for st in stats if st.n_evict > 0),
            "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
            "launches": counts, "stages_s": stages,
            "scratchpad_rows": pipe.num_slots, "nominal_slots": pipe.nominal_slots,
        })
        print("train: " + json.dumps(summaries[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"train: {name} done ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, table
    log("train: per precision, split and fused losses and flushed host tables bitwise "
        "equal; losses within " + ", ".join(f"{p} {t:g}" for p, t in Q_LOSS_RTOL.items())
        + " of fp32")
    return summaries, counts_by_run, captured


# --------------------------------------------------------------------------- #
# 9. timing at the reduced-precision operands
# --------------------------------------------------------------------------- #
NO_LIBRARY = {
    "gather": "no single PyTorch call sums dequantized {p} rows into fp32 bags "
              "(F.embedding_bag returns bags in the weight's dtype)",
    "fused": "no single PyTorch call fills {p} rows and sums dequantized rows into "
             "fp32 bags",
}


def time_q_kernels(torch, mods, captured, dev):
    """The fp16/int8 gathers, fills and fused kernels at the operands the
    reduced-precision runs gave them (the middle step), each against its
    plain version (bitwise) and its bound; the plain requantize epilogue
    timed apart. Returns ({kernel: numbers}, details)."""
    ops, ref, gr, qz = mods["ops"], mods["ref"], mods["gr"], mods["qz"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    out, details = {}, {}
    for precision in Q_KEYS:
        gk, fk, fgk = Q_KEYS[precision]
        int8 = precision == "int8"

        # the gather: fp16 storage, or int8 payload + scale
        if int8:
            data, scale, flat = captured.pop("int8 gather_reduce_q")
            kernel = lambda: gr.gather_reduce_q(data, scale, flat)  # noqa: E731
        else:
            (data, flat), scale = captured.pop("fp16 gather_reduce"), None
            kernel = lambda: gr.gather_reduce(data, flat)  # noqa: E731
        plain = lambda: ref.gather_reduce_q_ref(data, scale, flat)  # noqa: E731
        got, want = kernel(), plain()
        check(torch.equal(got, want), f"{gk} differs at the training operands")
        nb, L = flat.shape
        D, item = data.shape[1], data.element_size()
        row_b = D * item + (4 if int8 else 0)
        n_unique = int(torch.unique(flat).numel())
        g_bytes = n_unique * row_b + flat.numel() * 4 + nb * D * 4
        g_ops = nb * (L - 1) * D + (nb * L * D if int8 else 0)
        b_ms, b_by = bound(g_bytes, g_ops)
        out[gk] = {
            "ms": median_ms(torch, kernel, 30, flush),
            "plain_ms": median_ms(torch, plain, 10, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": NO_LIBRARY["gather"].format(p=precision),
            "max_abs_err": (got - want).abs().max().item(),
        }
        details[gk] = {"storage": list(data.shape), "dtype": str(data.dtype), "bags": nb,
                       "L": L, "unique_rows": n_unique, "bytes": g_bytes}
        del data, scale, flat, got, want

        # the fill (the payload of an int8 pair)
        st0, slots, rows = captured.pop(f"{precision} fill")
        scratch = st0.clone()
        gr.fill(scratch, slots, rows)
        want = ref.fill_ref(st0.clone(), slots, rows)
        check(torch.equal(scratch, want), f"{fk} differs at the training operands")
        fill_err = (scratch.float() - want.float()).abs().max().item()
        valid = slots < st0.shape[0]
        n_valid = int(valid.sum().item())
        f_bytes = 2 * n_valid * D * item + slots.numel() * 4
        v_slots, v_rows = slots[valid].long(), rows[valid]
        out[fk] = {
            "ms": median_ms(torch, lambda: gr.fill(scratch, slots, rows), 30, flush),
            "plain_ms": median_ms(torch, lambda: ref.fill_ref(scratch, slots, rows), 10,
                                  flush),
            "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": median_ms(
                torch, lambda: scratch.index_copy_(0, v_slots, v_rows), 30, flush),
            "max_abs_err": fill_err,
        }
        details[fk] = {"storage": list(st0.shape), "F": int(slots.numel()),
                       "valid_rows": n_valid, "bytes": f_bytes}
        del st0, scratch, want, slots, rows, v_slots, v_rows

        # the fused fill + gather (the int8 scale column already scattered)
        if int8:
            st0, scale, slots, rows, flat = captured.pop("int8 fill_gather_reduce_q")
            kernel = lambda st: gr.fill_gather_reduce_q(st, scale, slots, rows, flat)  # noqa: E731
        else:
            (st0, slots, rows, flat), scale = captured.pop("fp16 fill_gather_reduce"), None
            kernel = lambda st: gr.fill_gather_reduce(st, slots, rows, flat)  # noqa: E731
        got_st = st0.clone()
        got = kernel(got_st)
        want_st, want = ref.fill_gather_reduce_q_ref(st0.clone(), scale, slots, rows, flat)
        check(torch.equal(got_st, want_st) and torch.equal(got, want),
              f"{fgk} differs at the training operands")
        err = (got - want).abs().max().item()
        del got_st, want_st
        valid = slots < st0.shape[0]
        n_valid = int(valid.sum().item())
        nb, L = flat.shape
        n_unique = int(torch.unique(flat).numel())
        fg_bytes = (2 * n_valid * D * item + slots.numel() * 4 + n_unique * row_b
                    + flat.numel() * 4 + nb * D * 4)
        b_ms, b_by = bound(fg_bytes, g_ops)
        scratch = st0.clone()
        out[fgk] = {
            "ms": median_ms(torch, lambda: kernel(scratch), 30, flush),
            "plain_ms": median_ms(
                torch, lambda: ref.fill_gather_reduce_q_ref(scratch, scale, slots, rows, flat),
                10, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": NO_LIBRARY["fused"].format(p=precision),
            "max_abs_err": err,
        }
        details[fgk] = {"storage": list(st0.shape), "F": int(slots.numel()),
                        "valid_rows": n_valid, "bags": nb, "L": L, "unique_rows": n_unique,
                        "bytes": fg_bytes}
        del st0, scratch, scale, slots, rows, flat, got, want

        # the plain re-quantization epilogue of the backward (torch, not a
        # kernel of the TPU package: the reference leaves it to XLA too)
        st0, rows_u, delta = captured.pop(f"{precision} requantize_update")[:3]
        gen = torch.Generator(device=dev)
        details[f"requantize_update_{precision}"] = {
            "ms": median_ms(torch, lambda: qz.requantize_update(
                st0, rows_u, delta, precision, "stochastic", gen.manual_seed(0)), 10, flush),
            "touched_rows": int(rows_u.numel()), "D": int(delta.shape[1]),
        }
        del st0, rows_u, delta
    return out, details


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the root of "
              "a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.base import DLRMConfig
    from repro_torch.core import dlrm_runtime, pipeline, serving_cache, static_cache
    from repro_torch.core import quantize as qz
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import gather_reduce as gr
    from repro_torch.kernels import grad_coalesce as gc
    from repro_torch.launch import serve, train
    from repro_torch.models.dlrm import interaction_dim

    mods = {"ops": ops, "ref": ref, "gr": gr, "gc": gc, "qz": qz, "train": train,
            "pipeline": pipeline, "static_cache": static_cache,
            "dlrm_runtime": dlrm_runtime, "HostEmbeddingTable": HostEmbeddingTable,
            "DLRMConfig": DLRMConfig, "interaction_dim": interaction_dim}

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device(DEVICE, 0)

    t0 = time.perf_counter()
    built = _build.build_all()
    for b in built.values():
        regs = [ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln]
        log(f"build: {b.name} in {b.seconds:.2f}s -> {b.path.relative_to(ROOT)}")
        for ln in regs:
            print(f"    {ln}")
    log(f"build: {time.perf_counter() - t0:.2f}s in all")

    t0 = time.perf_counter()
    sweep_err = sweep_kernels(torch, ops, ref, qz, dev)
    log(f"kernels: bitwise equal to their plain versions across the sweep "
        f"({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    log("serve: " + " ".join(serve_args("scratchpipe-serve")))
    res, counts, captured, stages = serve_main_path(torch, ops, ref, serve, serving_cache)
    backend = res["backend"]
    log(f"serve: launches on the main path {counts} ({time.perf_counter() - t0:.1f}s)")
    check(backend.storage.device.type == dev.type, "the scratchpad is not on the card")
    check(captured["gather"][1].device.type == dev.type, "slot ids not on the card")
    check(counts["gather_reduce"] > 0 and counts["fill"] > 0,
          f"a kernel of the main path never launched: {counts}")
    check(counts["gather_reduce"] == res["served"], "one gather_reduce per serve")
    check(res["hit_rate"] == 1.0, f"post-warm-up hit rate {res['hit_rate']} != 1.000")

    t0 = time.perf_counter()
    oracle_args = serve.build_parser().parse_args(serve_args("nocache-serve"))
    oracle = serve.run_embedding(oracle_args, collect_bags=True)
    check(len(oracle["bags"]) == len(res["bags"]) == STEPS, "every micro-batch served")
    for i, (a, b) in enumerate(zip(res["bags"], oracle["bags"])):
        check(a.shape == (BATCH, TABLES, DIM) and a.dtype == b.dtype,
              f"bag shape of serve {i}")
        check((a == b).all(), f"bags of serve {i} differ from nocache-serve")
        check(bool(torch.isfinite(torch.from_numpy(a)).all()), f"non-finite bag in serve {i}")
    log(f"serve: bags of all {STEPS} micro-batches bitwise equal to nocache-serve "
        f"({time.perf_counter() - t0:.1f}s)")
    lat = res["latency"]
    summary = {
        "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
        "lookups_per_s": res["lookups_per_s"], "hit_rate": res["hit_rate"],
        "warmup": res["warmup"], "served": res["served"],
        "oracle_p50_ms": oracle["latency"]["p50_ms"],
        "oracle_p99_ms": oracle["latency"]["p99_ms"],
        "oracle_lookups_per_s": oracle["lookups_per_s"],
        "wall_s": res["wall_s"], "oracle_wall_s": oracle["wall_s"],
        # rows the cache had to fetch and fill, against the unique rows the
        # micro-batches looked up: the share the plan-ahead cache missed
        "rows_filled": backend.pcie.written // (DIM * 4),
        "unique_rows_looked_up": sum(st.n_unique for st in res["stats"]),
    }
    print("serve: " + json.dumps(summary), flush=True)
    print("stages: " + json.dumps(stages), flush=True)
    del oracle

    t0 = time.perf_counter()
    kernels, details = time_kernels(torch, ops, ref, gr, captured, counts,
                                    sweep_err, dev)
    log(f"timing: done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(details), flush=True)
    del res, backend, captured
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    summaries, train_counts, train_captured, base, fp32_losses = train_main_path(
        torch, mods, dev)
    log(f"train: three runs done ({time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    train_times, train_details = time_train_kernels(torch, ops, ref, gr, gc,
                                                    train_captured, dev)
    log(f"timing: training operands done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(train_details), flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, q_counts, q_captured = train_q_main_path(torch, mods, dev, base, fp32_losses)
    del base
    log(f"train: four reduced-precision runs done ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    q_times, q_details = time_q_kernels(torch, mods, q_captured, dev)
    log(f"timing: reduced-precision operands done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(q_details), flush=True)

    by_run = {"serve": counts, **train_counts, **q_counts}
    gather, fill = kernels
    for k in (gather, fill):
        k["launches_by_run"] = {run: c[k["name"]] for run, c in by_run.items()}
        k["launches"] = sum(k["launches_by_run"].values())
    gather["max_abs_err"] = max(gather["max_abs_err"],
                                train_times["gather_reduce"].pop("max_abs_err"))
    gather["train"] = train_times["gather_reduce"]
    train_times.update(q_times)
    for name, source, replaces in (
            ("scatter_add", CU_SOURCE_BWD, "src/repro/kernels/grad_coalesce.py:44"),
            ("fill_gather_reduce", CU_SOURCE, "src/repro/kernels/gather_reduce.py:210"),
            ("gather_reduce_q", CU_SOURCE, "src/repro/kernels/gather_reduce.py:103"),
            ("fill_gather_reduce_q", CU_SOURCE, "src/repro/kernels/gather_reduce.py:304"),
            ("gather_reduce_f16", CU_SOURCE, "src/repro/kernels/gather_reduce.py:55"),
            ("fill_f16", CU_SOURCE, "src/repro/kernels/gather_reduce.py:146"),
            ("fill_i8", CU_SOURCE, "src/repro/kernels/gather_reduce.py:146"),
            ("fill_gather_reduce_f16", CU_SOURCE, "src/repro/kernels/gather_reduce.py:210")):
        t = train_times[name]
        launches = {run: c[name] for run, c in by_run.items() if run != "serve"}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_run": launches,
            "max_abs_err": max(sweep_err[name], t.pop("max_abs_err")), **t,
        })
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
