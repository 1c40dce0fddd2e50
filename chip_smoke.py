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
               the serving and training paths' own shapes; for
               ``scatter_add`` also segments of T - 1, T and T + 1 lookups
               of one row (T = the long-segment threshold), several long
               segments in one launch, a 4,000-long segment among 10^5
               short ones, and ids == N (which the kernel drops); and two
               host threads launching it at once, each on a stream and a
               storage of its own, 40 times, on ids with long segments (the
               side stream is per thread): each result equal to its plain
               version;
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
               Then two more: ``scratchpipe --planner device --executor
               overlapped``, split and ``--fused`` (the plan state on the
               card, the host gather and write-back on a worker thread, the
               copies back on a d2h thread). Counts are reset just before
               each run and read just after; the plain versions raise
               during the runs, every kernel wrapper fails a launch off the
               main thread, and in the device-planner runs the numpy
               ``Planner.plan`` raises. The losses of the five runs must be
               bitwise equal step by step, and so must the host tables
               after ``flush_to_host`` (TF32 off, cuBLAS workspace pinned);
               losses finite. Each ``train:`` line has ms/step, the main
               thread's seconds per stage (under ``overlapped`` the main
               thread's only) and its seconds waiting on worker futures.
  7. timing  — ``scatter_add`` and ``fill_gather_reduce`` at the operands
               the training runs gave them, and ``gather_reduce`` again at
               the training bags. ``scatter_add`` is split too: the sort,
               the accumulate, the accumulate of as many lookups with no
               repeated id, and of the longest segment alone; its
               long-segment worklist is checked against torch's; and it is
               timed again on ids of the sweep's Zipf skew.
  8. train q — the same training path at fp16 and int8 replica precision
               (``--precision``, ``stochastic`` rounding, the launcher's
               default): fp16 split, fp16 fused, int8 split, int8 fused, 24
               steps each, from copies of the same host table, in a nominal
               budget of 1,000,000 fp32-row slots (cache_fraction 0.125 at
               the cut): fp16 holds 2,000,000 rows and evicts (checked), so
               the victim read, its d2h and the dequantized write-back run on
               the card; int8 holds 4,000,000. Then ``fp16`` and ``int8
               device+overlapped fused`` (the fp16 one evicts: its victims'
               d2h and dequantized write-back run on the worker threads).
               Per precision the split, fused and device+overlapped losses
               and flushed host tables must be bitwise equal,
               and every step's loss within 1e-2 (fp16) / 1e-1 (int8)
               relative of the fp32 split run's; launch counts as designed,
               the plain versions raise.
  9. timing  — ``gather_reduce_q``, ``fill_gather_reduce_q`` and the fp16/
               int8 forms of ``gather_reduce``, ``fill`` and
               ``fill_gather_reduce`` at the operands of the middle step of
               phase 8 (checked to take the int8 kernels' staged path), with
               each gather's and fused kernel's GB/s and random accesses per
               microsecond, and the plain ``requantize_update`` epilogue.
 10. lm serve — the LM serving path: ``repro_torch.launch.serve``'s
               ``run_lm`` for ``--arch zamba2-1.2b --batch 4 --prompt-len
               2048 --gen 16 --seed 0`` at full width (38 mamba2 layers,
               d_model 2048, the shared attention block applied 6 times,
               vocab 32000), bf16, no cut: one prefill, then 15 greedy
               decode steps against the KV + SSM cache. Counts are reset
               just before and read just after, and at the first decode
               step: exactly 38 ``ssd_chunk_scan`` and 6 ``flash_attention``
               launches in the prefill, none in decode; the plain versions
               raise during the run. Logits finite, tokens in the vocab,
               caches of the grown shape. Then each LM kernel against its
               plain version at the run's first operands and over a sweep
               (flash: GQA, MQA, causal + window, non-causal with ragged
               keys past a block, Sq not a block multiple, hd 64/128, and
               the tensor-core kernel's edges: Sq = Skv in {127, 129, 255,
               257}, a window across KV blocks, Sq != Skv, hd 16/20/32/48,
               GQA H/K = 4; SSD:
               ng 1/2, S not a multiple of Q, Q 64/256, ds 64/128, and the
               tensor-core kernel's edges: hd 16/20/48/96, ds 16/128, S
               below, at and one past Q = 64/128/256, ng 2 x hpg 8, S = 4096
               (16 chunks of state); fp32 and bf16), at the reference's
               tolerances (flash atol 2e-5 fp32,
               3e-2 bf16; SSD atol 2e-4 fp32, and 3e-2 + 1e-2 |plain| for
               its bf16 output). Then the same prefill and decode at fp32
               (params and activations; TF32 off) through the kernels and
               with the plain versions swapped in: last-position logits
               within 1e-3 of the plain run's largest logit, the 16 greedy
               tokens equal. A warm prefill and one decode step are traced
               with torch.profiler (device time by kernel, busy share).
 11. timing  — ``flash_attention`` and ``ssd_chunk_scan`` at the main
               path's operands beside their bounds, their plain versions
               and (flash) ``F.scaled_dot_product_attention``; achieved
               TFLOP/s; the SSD's two launches (G, then the scan) timed
               apart, its GB/s and operations at the bf16 splits it uses,
               and the traced prefill's per-launch means of both SSD
               kernels beside the CUDA-event medians (a cross-check of the
               profiler); the fp32 forms' bounds at the fp32 rate and
               SDPA's fp32 time at flash's operands.
 12. plan_step — the device planner's ``plan_step`` at the operands of
               phase 6's device+overlapped split run at its 12th step
               (327,680 ids and the 655,360-id look-ahead union, padded by
               the planner to its pow-2 lengths 524,288 and 1,048,576;
               4,000,000 slots, 8,000,000 rows): once under
               ``torch.cuda.set_sync_debug_mode("error")`` (a host sync
               inside fails the phase), every output and the new state
               equal to the same call on the CPU; then ms per call (CUDA
               events, median), the slots' stable sort timed apart.

 13. trace serve — phase 4's 24 ``inference_mix`` micro-batches recorded with
               ``record_serving_trace`` as three traces whose tables say fp32,
               fp16 and int8, served through ``repro_torch.launch.serve
               --embedding --trace`` on one host table (``run_embedding(...,
               host=)``, built once): fp32 ``scratchpipe-serve`` at depth 2
               (bags bitwise equal to phase 4's); fp16 and int8 at depths 2
               and 0 in a nominal budget set by the launcher's window floor
               (``--cache-frac 0.125``; fp16 2,621,440 rows, which evict,
               checked; int8 5,242,880), bags bitwise equal to
               ``nocache-serve`` over host rows quantized and dequantized the
               same way, ``hit_rate`` 1.000 at depth 2, exactly one gather of
               the precision's form per micro-batch and fills of its form, no
               fp32 gather; ``static-serve`` over the fp32 trace (hot rows of
               the first quarter of the batches), bitwise equal to
               ``nocache-serve``, one ``gather_reduce`` per micro-batch; and
               ``EmbeddingServer`` over an int8 ``scratchpipe-serve``: four
               host threads each submit one micro-batch's 2048 requests one
               at a time, every future's bags bitwise equal to the oracle's
               for that request, every kernel launch from the front end's
               worker thread (the wrappers record the launching thread).
               Counts are reset before and read after each run, the plain
               versions raise during the runs, and each run prints a
               ``serve:`` line (p50, p99, lookups/s, stage seconds). Then
               ``gather_reduce_q``, the fp16 gather and the fp16/int8 fills
               are timed at the depth-2 runs' operands.
 14. trace train — phase 6's 24 synthetic batches recorded with
               ``record_trace`` and replayed by ``train_dlrm --trace`` through
               ``scratchpipe --planner device --executor overlapped --fused``
               with phase 6's configuration: the losses and the flushed host
               table (its SHA-256) bitwise equal to phase 6's, every launch on
               the main thread (the replay's prefetch thread launches
               nothing); ms/step beside phase 6's.

The traces go to a temporary directory removed at exit. The sweep of
phase 3 covers the fp16 and int8 forms too, and for them also D in {256,
1024} (rows of several warp loads), L in {33, 64} (more than one 32-lookup
group), a payload 4 but not 16 bytes aligned, fused calls whose
fills are all sentinels, and ragged fills. The last three lines are the
``kernels`` JSON line (``scatter_add``, ``flash_attention`` and
``ssd_chunk_scan`` carry their ``details``; ``gather_reduce_q`` and the fp16
gather and fp16/int8 fills their times at phase 13's operands under
``serve``), the nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
CU_SOURCE_FA = "src/repro_torch/kernels/csrc/flash_attention.cu"
CU_SOURCE_SSD = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor cores (fp32 operands)
DEVICE = "cuda"
# the serving slice at the full width of dlrm-scratchpipe
# (src/repro/configs/base.py: DLRMConfig), cut to 1M rows per table
TABLES, ROWS, DIM, LOOKUPS, BATCH = 8, 1_000_000, 128, 20, 2048
STEPS, DEPTH, CACHE_FRAC = 24, 2, 0.25
# the training slice: the same width and cut; the scratchpad keeps the uncut
# config's 0.05 x 80M = 4,000,000 slots (above the 6 x 327,680-row window floor)
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_CACHE_FRAC = 24, 6, 0.5
# (name, runtime, fused, fast): ``fast`` adds --planner device --executor
# overlapped (the device-resident planner and the overlapped executor)
TRAIN_RUNS = (("scratchpipe split", "scratchpipe", False, False),
              ("scratchpipe fused", "scratchpipe", True, False),
              ("nocache", "nocache", False, False),
              ("scratchpipe device+overlapped", "scratchpipe", False, True),
              ("scratchpipe device+overlapped fused", "scratchpipe", True, True))
FAST_ARGV = ["--planner", "device", "--executor", "overlapped"]
# the reduced-precision slice: the same width and cut, a nominal budget of
# 1,000,000 fp32-row slots (cache_fraction 0.125 of the 8M rows): fp16 holds
# 2,000,000 rows and evicts after ~15 steps of ~130k misses, int8 4,000,000
Q_CACHE_FRAC, Q_NOMINAL_SLOTS = 0.125, 1_000_000
Q_MULT = {"fp16": 2, "int8": 4}
Q_RUNS = (("fp16 split", "fp16", False, False), ("fp16 fused", "fp16", True, False),
          ("fp16 device+overlapped fused", "fp16", True, True),
          ("int8 split", "int8", False, False), ("int8 fused", "int8", True, False),
          ("int8 device+overlapped fused", "int8", True, True))
# each step's loss against the fp32 split run's: the reference's P3 bounds
# (tests/test_precision_parity.py)
Q_LOSS_RTOL = {"fp16": 1e-2, "int8": 1e-1}
# the LM serving slice: zamba2-1.2b at full width, no cut
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "zamba2-1.2b", 4, 2048, 16
LM_ARGV = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
           "--gen", str(LM_GEN), "--seed", "0", "--device", DEVICE]
LM_PREFILL_LAUNCHES = {"ssd_chunk_scan": 38, "flash_attention": 6}
# the reference's tolerances (tests/test_kernels.py); a bf16 SSD output is
# held to 3e-2 + 1e-2 |plain| (two bf16 steps of 2^-8 relative, plus flash's
# bf16 bound)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
SSD_ATOL, SSD_BF16_ATOL, SSD_BF16_RTOL = 2e-4, 3e-2, 1e-2
LM_LOGIT_RTOL = 1e-3  # fp32 kernels vs plain: max |diff| / max |plain logit|


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


def offset_copy(torch, t, offset: int):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    64-byte-aligned address (0: the copy is aligned)."""
    n_bytes = t.numel() * t.element_size()
    buf = torch.empty(n_bytes + 64, dtype=torch.uint8, device=t.device)
    base = (-buf.data_ptr()) % 64 + offset
    view = buf[base:base + n_bytes].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


#: launch-count keys of the reduced-precision forms: (gather, fill, fused)
Q_KEYS = {"fp16": ("gather_reduce_f16", "fill_f16", "fill_gather_reduce_f16"),
          "int8": ("gather_reduce_q", "fill_i8", "fill_gather_reduce_q")}


def scatter_two_threads(torch, ref, gc, g, dev, reps: int = 40) -> None:
    """Two host threads launch ``scatter_add`` at once, each on a stream and
    a storage of its own, ``reps`` times, on ids with long segments (so each
    call forks and joins its side stream): each result equals its plain
    version, the same adds repeated."""
    import threading

    cases = []
    for i in range(2):
        ids = torch.randint(0, 4096, (40_000,), generator=g, dtype=torch.int32)
        ids[torch.randperm(40_000, generator=g)[:3000]] = 11 + i
        ids[torch.randperm(40_000, generator=g)[:500]] = 100 + i
        ids = ids.reshape(-1, 4)
        cases.append((torch.randn(4096, 128, generator=g).to(dev), ids.to(dev),
                      (torch.randn(ids.shape[0], 128, generator=g) * 1e3).to(dev),
                      torch.cuda.Stream(dev)))
    torch.cuda.synchronize()
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def work(i):
        st, ids, deltas, stream = cases[i]
        try:
            with torch.cuda.stream(stream):
                out = st.clone()
                start.wait(timeout=60)
                for _ in range(reps):
                    gc.scatter_add(out, ids, deltas)
                got[i] = out
        except Exception as e:  # reported on the main thread below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and not errors,
          f"scatter_add from two threads: {errors}")
    torch.cuda.synchronize()
    for i, (st, ids, deltas, _) in enumerate(cases):
        want = st.clone()
        for _ in range(reps):
            want = ref.scatter_add_ref(want, ids, deltas)
        check(torch.equal(got[i], want), f"scatter_add from two threads: thread {i} differs")
    log(f"kernels: scatter_add from two host threads at once ({reps} launches each, "
        "two streams, long segments) equals its plain version")


def sweep_kernels(torch, ops, ref, gc, qz, dev) -> dict:
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

    def gather_q_case(N, D, nb, L, precision, ids, offset=0):
        """offset 4: a payload 4 but not 16 bytes aligned (the int8 gather's
        old path); bag 0 looks up one slot all through."""
        data, scale = q_storage(N, D, precision)
        data = offset_copy(torch, data, offset)
        key = Q_KEYS[precision][0]
        ids = ids.clone()
        ids[0] = 5
        ids = ids.to(dev)
        before = ops.launch_counts()[key]
        got = ops.gather_reduce_q(data, scale, ids)
        want = ref.gather_reduce_q_ref(data, scale, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()[key] == before + 1, f"{key} launch count")
        check(got.dtype == torch.float32 and torch.equal(got, want),
              f"{key} differs at N={N} D={D} nb={nb} L={L} offset={offset}")
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

    def fused_q_case(N, D, F, n_valid, nb, L, precision, offset=0):
        """n_valid 0: every fill a sentinel; offset as in gather_q_case."""
        data, scale = q_storage(N, D, precision)
        slots = torch.full((F,), N, dtype=torch.int32)
        slots[torch.randperm(F, generator=g)[:n_valid]] = (
            torch.randperm(N, generator=g)[:n_valid].to(torch.int32))
        filled = slots[slots < N]
        ids = torch.randint(0, N, (nb, L), generator=g, dtype=torch.int32)
        if n_valid:
            ids = torch.where(torch.rand(nb, L, generator=g) < 0.5,
                              filled[torch.randint(0, filled.numel(), (nb, L), generator=g)],
                              ids)
        rows, rows_scale = q_storage(F, D, precision)
        slots, ids = slots.to(dev), ids.to(dev)
        if scale is not None:  # the scale column is scattered before the launch
            keep = slots < N
            scale[slots[keep].long()] = rows_scale[keep]
        key = Q_KEYS[precision][2]
        before = ops.launch_counts()[key]
        got_st, got = ops.fill_gather_reduce_q(offset_copy(torch, data, offset), scale, slots,
                                               rows, ids)
        want_st, want = ref.fill_gather_reduce_q_ref(data.clone(), scale, slots, rows, ids)
        torch.cuda.synchronize()
        check(ops.launch_counts()[key] == before + 1, f"{key} launch count")
        check(torch.equal(got_st, want_st) and torch.equal(got, want),
              f"{key} differs at N={N} D={D} F={F} n_valid={n_valid} nb={nb} L={L} "
              f"offset={offset}")
        err[key] = max(err[key], diff(got, want), diff(got_st, want_st))

    def scatter_case(N, D, ids, scale=1.0):
        """ids may hold N, which the kernel drops: the plain version (which
        takes ids in [0, N) only) adds those to a row N past the kernel's."""
        nb = ids.shape[0]
        st = torch.randn(N + 1, D, generator=g).to(dev)
        deltas = (torch.randn(nb, D, generator=g) * scale).to(dev)
        ids = ids.to(dev)
        before = ops.launch_counts()["scatter_add"]
        got = ops.coalesce_deltas(st[:N].clone(), ids, deltas)
        want = ref.scatter_add_ref(st.clone(), ids, deltas)[:N]
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
    # segments at the long-segment threshold T and past it, several long ones
    # in one launch, one 4,000-long among 10^5 short ones; ids == N dropped
    T = gc.LONG_SEGMENT
    for D in (8, 40, 128, 192):
        for lens in ((T - 1,), (T,), (T + 1,), (T + 1, 3 * T, 5, T - 1, 2000, 1, 700)):
            ids = torch.cat([torch.full((n,), 7 * i + 3, dtype=torch.int32)
                             for i, n in enumerate(lens)] + [torch.full((3,), 4096, dtype=torch.int32)])
            ids = ids[torch.randperm(ids.numel(), generator=g)]
            ids = torch.cat([ids, torch.randint(0, 4096, ((-ids.numel()) % 4,), generator=g,
                                                dtype=torch.int32)])
            scatter_case(4096, D, ids.reshape(-1, 4), scale=1e3)
    hot = torch.randint(0, 1_000_000, (100_000,), generator=g, dtype=torch.int32)
    hot[torch.randperm(100_000, generator=g)[:4000]] = 17
    scatter_case(1_000_000, 128, hot.reshape(-1, 4), scale=1e3)
    scatter_two_threads(torch, ref, gc, g, dev)
    st = torch.randn(64, 40, generator=g).to(dev)
    dup = torch.tensor([[3, 3, 3, 5], [5, 3, 5, 3], [0, 0, 0, 0]], dtype=torch.int32)
    check(torch.equal(ops.gather_reduce(st, dup.to(dev)),
                      ref.gather_reduce_ref(st, dup.to(dev))), "explicit duplicates")
    # the fp16 and int8 forms over the same sweep, plus rows of several warp
    # loads (D 256, 1024), more than one 32-lookup group (L 33, 64), a
    # payload 4 but not 16 bytes aligned, fused calls whose fills are all
    # sentinels, and ragged fills; narrow rows fill several per warp, the
    # fp32 D=128 rows above (exactly 512 bytes) one per warp. D=3 copies 6-
    # and 3-byte rows (2- and 1-byte chunks)
    for precision in Q_KEYS:
        for D in (8, 40, 128, 192, 256, 1024):
            for L in (1, 3, 20, 33, 64):
                gather_q_case(4096, D, 257, L, precision,
                              torch.randint(0, 64, (257, L), generator=g, dtype=torch.int32))
                gather_q_case(4096, D, 33, L, precision,
                              torch.randint(0, 4096, (33, L), generator=g, dtype=torch.int32))
                fused_q_case(4096, D, 1024, 1000, 257, L, precision)
            gather_q_case(4096, D, 33, 20, precision,
                          torch.randint(0, 4096, (33, 20), generator=g, dtype=torch.int32),
                          offset=4)
            fused_q_case(4096, D, 1024, 1000, 33, 20, precision, offset=4)
            fused_q_case(4096, D, 1024, 0, 33, 3, precision)  # every fill a sentinel
            fill_q_case(4096, D, 1000, 1024, precision)
            fill_q_case(4096, D, 999, 1023, precision)
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
def median_ms(torch, fn, reps: int, flush, warm=None) -> float:
    """Median device time of ``fn`` over ``reps`` launches (CUDA events
    around each launch; the L2 is flushed before each, as a serve finds
    it after its other work). ``warm``, if given, runs after the flush and
    outside the events (to time ``fn`` with some operand L2-resident)."""
    for _ in range(2):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        flush.zero_()
        if warm is not None:
            warm()
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


def plain_versions_raise(ref):
    """Make every plain PyTorch version raise while a main path runs (no
    CPU tensor may reach a kernel wrapper); returns restore()."""
    saved = {n: getattr(ref, n) for n in PLAIN_VERSIONS}

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    for n in saved:
        setattr(ref, n, no_plain)

    def restore():
        for n, fn in saved.items():
            setattr(ref, n, fn)
    return restore


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


#: every kernel wrapper that launches (each adds one to its count there)
LAUNCHERS = {"gr": ("gather_reduce", "gather_reduce_q", "fill", "fill_gather_reduce",
                    "fill_gather_reduce_q"),
             "gc": ("scatter_add", "scatter_add_sorted"),
             "fa": ("flash_attention",), "ssd": ("ssd_chunk_scan",)}


def run_guards(mods, fast: bool, captured=None):
    """Wrap every kernel wrapper so that a launch off the main thread is
    recorded (and raises where it happens); under ``fast`` make the numpy
    ``Planner.plan`` raise, and capture ``plan_step``'s operands at the
    middle step into ``captured`` (when given); time the main thread's
    waits on worker futures. Returns (report, restore): report() -> (the
    off-main-thread launches, the main thread's seconds in Future.result)."""
    import concurrent.futures
    import threading

    off_main, waited = [], [0.0]
    saved = []

    def patch(obj, name, fn):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def guarded(name, fn):
        def wrapper(*a, **k):
            if threading.current_thread() is not threading.main_thread():
                off_main.append((name, threading.current_thread().name))
                raise RuntimeError(f"{name} launched off the main thread")
            return fn(*a, **k)
        return wrapper

    for mod, names in LAUNCHERS.items():
        for n in names:
            patch(mods[mod], n, guarded(n, getattr(mods[mod], n)))
    real_result = concurrent.futures.Future.result

    def timed_result(self, timeout=None):
        if threading.current_thread() is not threading.main_thread():
            return real_result(self, timeout)
        t0 = time.perf_counter()
        try:
            return real_result(self, timeout)
        finally:
            waited[0] += time.perf_counter() - t0

    patch(concurrent.futures.Future, "result", timed_result)
    if fast:
        def no_host_plan(*_a, **_k):
            raise RuntimeError("the numpy Planner.plan ran on a device-planner path")

        patch(mods["plan"].Planner, "plan", no_host_plan)
        pd, calls = mods["plan_device"], [0]
        real_step = pd.plan_step

        def spy_step(state, ids, fut, *, past_window=3):
            calls[0] += 1
            if captured is not None and calls[0] == TRAIN_STEPS // 2:
                captured["plan_step"] = (state, ids, fut, past_window)
            return real_step(state, ids, fut, past_window=past_window)

        patch(pd, "plan_step", spy_step)

    def restore():
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)
    return (lambda: (list(off_main), waited[0])), restore


def train_summary(name, fast, ms, res, stages, report):
    """The fields every ``train:`` line has."""
    off_main, waited = report()
    check(not off_main, f"{name}: kernel launches off the main thread: {off_main[:5]}")
    return {
        "run": name, "planner": "device" if fast else "host",
        "executor": "overlapped" if fast else "sync", "ms_per_step": ms,
        "warmup_steps": TRAIN_WARMUP, "plan_hit": res["plan_hit"], "wall_s": res["wall_s"],
        "stages_s": stages,
        "stages_s_are": ("the main thread's seconds only (the host gather, write-back "
                         "and copies back run on worker threads)") if fast
        else "seconds per stage (all on the main thread)",
        "main_thread_wait_on_workers_s": waited,
    }


def train_run(torch, mods, cfg, base_table, name, runtime, fused, fast, captured,
              extra_argv=()):
    """One training run through the launcher's ``train_dlrm`` from a copy of
    ``base_table``; the plain versions raise during it, and every kernel
    launch must come from the main thread (``run_guards``). Captures kernel
    operands of the middle step into ``captured`` (and under ``fast``
    plan_step's). Returns (result, launch counts of the run, stage times,
    ms/step after the warm-up, the guards' report)."""
    ops, ref, gr, gc = mods["ops"], mods["ref"], mods["gr"], mods["gc"]
    report, unguard = run_guards(mods, fast, captured if fast and not fused else None)
    at = TRAIN_STEPS // 2
    calls = {"gather": 0, "scatter": 0, "fused": 0}
    real = {"gather": ops.gather_reduce, "scatter": gc.scatter_add,
            "fused": gr.fill_gather_reduce}

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
        if name == "scratchpipe fused" and calls["fused"] == at:
            captured["fused"] = (storage.clone(), fill_slots.clone(), rows.clone(),
                                 flat_ids.clone())
        return real["fused"](storage, fill_slots, rows, flat_ids)

    argv = ["--arch", "dlrm-scratchpipe", "--steps", str(TRAIN_STEPS), "--batch",
            str(BATCH), "--seed", "0", "--runtime", runtime, "--device", DEVICE]
    args = mods["train"].build_parser().parse_args(
        argv + (["--fused"] if fused else []) + (FAST_ARGV if fast else [])
        + list(extra_argv))
    host = mods["HostEmbeddingTable"](base_table.shape[0], base_table.shape[1],
                                      data=base_table.copy())
    ops.gather_reduce, gc.scatter_add, gr.fill_gather_reduce = (
        spy_gather, spy_scatter, spy_fused)
    restore_plain = plain_versions_raise(ref)
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
        restore_plain()
        unguard()
    step_ends = ends[TRAIN_STEP_LABEL[runtime]]
    ms_per_step = ((step_ends[-1] - step_ends[TRAIN_WARMUP - 1])
                   / (len(step_ends) - TRAIN_WARMUP) * 1e3)
    return res, counts, stages, ms_per_step, report


def table_digest(table) -> str:
    """SHA-256 of a host table's bytes: two flushed tables with the same
    digest are bitwise equal (phase 14 checks against phase 6's without
    keeping a fourth 4 GB table alive)."""
    import hashlib

    return hashlib.sha256(table.data).hexdigest()


def check_train_counts(name, runtime, fused, stats, counts, stages):
    """Every kernel of the run's path fired, and only where it should."""
    n = len(stats)
    with_fills = sum(1 for st in stats if st.n_miss > 0)
    check(n == TRAIN_STEPS and with_fills > 0, f"{name}: {n} steps, {with_fills} with fills")
    check(counts["scatter_add"] == n, f"{name}: one scatter_add per step: {counts}")
    if runtime == "scratchpipe" and not fused:
        check(counts["gather_reduce"] == n and counts["fill"] == with_fills
              and counts["fill_gather_reduce"] == 0, f"{name}: launches {counts}")
    elif runtime == "scratchpipe":
        fused = stages.get("fused fill + train calls", {}).get("calls", 0)
        check(counts["fill_gather_reduce"] == fused > 0
              and counts["fill_gather_reduce"] + counts["fill"] == with_fills
              and counts["fill_gather_reduce"] + counts["gather_reduce"] == n,
              f"{name}: launches {counts}, fused cycles {fused}")
    else:
        check(counts["gather_reduce"] == n and counts["fill"] == 0
              and counts["fill_gather_reduce"] == 0, f"{name}: launches {counts}")


def train_main_path(torch, mods, dev):
    """The five training runs on copies of one host table; returns
    (summaries, launch counts per run, captured operands, the host table,
    the losses, the flushed table's SHA-256)."""
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
    first_losses = first_table = first_digest = None
    for name, runtime, fused, fast in TRAIN_RUNS:
        t0 = time.perf_counter()
        res, counts, stages, ms, report = train_run(torch, mods, cfg, base, name, runtime,
                                                    fused, fast, captured)
        stats, pipe = res["stats"], res["pipe"]
        check(pipe.device.type == dev.type, f"{name}: the runtime is not on the card")
        if fast:
            check(isinstance(pipe.planner, mods["plan_device"].DevicePlanner)
                  and pipe.executor == "overlapped",
                  f"{name}: not the device planner with the overlapped executor")
        check_train_counts(name, runtime, fused, stats, counts, stages)
        losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
        check(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
        pipe.flush_to_host()
        if runtime == "scratchpipe":
            pipe.close()
        table = res["host"].data
        if first_losses is None:
            first_losses, first_table = losses, table
            first_digest = table_digest(table)
        else:
            check(torch.equal(losses, first_losses),
                  f"{name}: losses differ from {TRAIN_RUNS[0][0]} at steps "
                  f"{torch.nonzero(losses != first_losses).flatten().tolist()}")
            check(first_table.shape == table.shape and (first_table == table).all(),
                  f"{name}: flushed host table differs from {TRAIN_RUNS[0][0]}")
        tr = pipe.traffic()
        summaries.append({
            **train_summary(name, fast, ms, res, stages, report),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
            "launches": counts,
            "scratchpad_slots": int(getattr(pipe, "num_slots", 0)),
        })
        print("train: " + json.dumps(summaries[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"train: {name} done ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, table
    log(f"train: losses of all {TRAIN_STEPS} steps and the flushed host tables bitwise "
        f"equal across {', '.join(r[0] for r in TRAIN_RUNS)}; every kernel launched on the "
        "main thread; the device-planner runs never called the numpy planner")
    return summaries, counts_by_run, captured, base, first_losses, first_digest


# --------------------------------------------------------------------------- #
# 7. timing at the training operands
# --------------------------------------------------------------------------- #
def bound(n_bytes: int, n_ops: int):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def access_rates(torch, ms: float, n_bytes: int, flat, row_bytes: int, scaled: bool,
                 fill_rows: int = 0) -> dict:
    """What a gather (or fused) launch achieved: the bound's bytes per
    second, and random accesses per microsecond. An access is a unique
    payload line (128 bytes; a row of ``row_bytes`` from a line-aligned
    base spans ceil(row_bytes / 128)), for int8 a unique scale sector (32
    bytes: ids // 8), and in the fused kernels each valid fill row's lines
    stored."""
    unique = torch.unique(flat)
    per_row = -(-row_bytes // 128)
    lines = unique.numel() * per_row
    sectors = int(torch.unique(unique // 8).numel()) if scaled else 0
    accesses = lines + sectors + fill_rows * per_row
    return {"GB_per_s": n_bytes / ms / 1e6, "accesses_per_us": accesses / (ms * 1e3),
            "payload_lines": lines, "scale_sectors": sectors,
            "fill_lines": fill_rows * per_row}


def scatter_zipf(torch, ref, gc, storage, deltas, flush, dev) -> dict:
    """scatter_add on ids of the sweep's Zipf skew (``zipf_ids``, seed 1: a
    harder skew than the training stream's, with a longest segment of
    thousands more lookups) at the training operands' shapes: checked
    bitwise, then timed."""
    nb, L = deltas.shape[0], LOOKUPS
    flat = zipf_ids(torch, torch.Generator().manual_seed(1), (nb, L), storage.shape[0]).to(dev)
    got, want = storage.clone(), ref.scatter_add_ref(storage.clone(), flat, deltas)
    gc.scatter_add(got, flat, deltas)
    check(torch.equal(got, want), "scatter_add differs on the Zipf ids")
    del got, want
    seg = torch.unique(flat, return_counts=True)[1]
    keys, perm = gc.sort_by_slot(flat)
    scratch = storage.clone()
    dup, idx = deltas.repeat_interleave(L, dim=0), flat.reshape(-1).long()
    return {
        "unique_rows": int(seg.numel()), "longest_segment": int(seg.max()),
        "long_segments": int((seg > gc.LONG_SEGMENT).sum()),
        "ms": median_ms(torch, lambda: gc.scatter_add(scratch, flat, deltas), 30, flush),
        "sort_ms": median_ms(torch, lambda: gc.sort_by_slot(flat), 30, flush),
        "accumulate_ms": median_ms(
            torch, lambda: gc.scatter_add_sorted(scratch, keys, perm, deltas, L), 30, flush),
        "library_ms": median_ms(torch, lambda: scratch.index_add_(0, idx, dup), 30, flush),
    }


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
    g_bytes = n_unique * D * 4 + flat.numel() * 4 + nb * D * 4
    b_ms, b_by = bound(g_bytes, nb * (L - 1) * D)
    long_ids = flat.long()
    out["gather_reduce"] = {
        "ms": median_ms(torch, lambda: gr.gather_reduce(storage, flat), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.gather_reduce_ref(storage, flat), 10, flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": median_ms(
            torch, lambda: F.embedding_bag(long_ids, storage, mode="sum"), 30, flush),
        "max_abs_err": (got - want).abs().max().item(),
    }
    details["gather_reduce"] = {
        "storage": list(storage.shape), "bags": nb, "L": L, "unique_rows": n_unique,
        **access_rates(torch, out["gather_reduce"]["ms"], g_bytes, flat, D * 4, False)}

    st0, flat, deltas = captured["scatter"]
    nb, L = flat.shape
    got = st0.clone()
    gc.scatter_add(got, flat, deltas)
    want = ref.scatter_add_ref(st0.clone(), flat, deltas)
    check(torch.equal(got, want), "scatter_add differs at the training operands")
    err = (got - want).abs().max().item()
    del got, want
    seg = torch.unique(flat, return_counts=True)[1]
    n_unique, longest = int(seg.numel()), int(seg.max())
    b_ms, b_by = bound(2 * n_unique * D * 4 + flat.numel() * 4 + nb * D * 4, flat.numel() * D)
    scratch = st0.clone()
    keys, perm = gc.sort_by_slot(flat)
    # the long-segment worklist the first launch builds, against torch's
    work = gc.scatter_add_sorted(scratch, keys, perm, deltas, L)
    heads = gc.long_segment_heads(keys, st0.shape[0])
    n_long = int(work[0])
    check(torch.equal(torch.sort(work[2:2 + n_long]).values, heads),
          "the long-segment worklist differs from long_segment_heads")
    # the same number of lookups with no repeated id, and the longest
    # segment alone: what the short class and the long class cost
    distinct = torch.randperm(st0.shape[0], device=dev)[:flat.numel()].to(torch.int32)
    keys_u, perm_u = gc.sort_by_slot(distinct.reshape(nb, L))
    keys_1, perm_1 = gc.sort_by_slot(torch.zeros(longest, 1, dtype=torch.int32, device=dev))
    deltas_1 = deltas[torch.arange(longest, device=dev) % nb]
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
    details["scatter_add"] = {
        "storage": list(st0.shape), "bags": nb, "L": L, "unique_rows": n_unique,
        "longest_segment": longest, "long_threshold_T": gc.LONG_SEGMENT,
        "long_segments": n_long,
        "lookups_in_long_segments": int(seg[seg > gc.LONG_SEGMENT].sum()),
        "accumulate_no_repeat_ms": median_ms(
            torch, lambda: gc.scatter_add_sorted(scratch, keys_u, perm_u, deltas, L), 30, flush),
        "no_repeat_bound_ms": bound(2 * flat.numel() * D * 4 + flat.numel() * 4
                                    + nb * D * 4, flat.numel() * D)[0],
        "accumulate_longest_alone_ms": median_ms(
            torch, lambda: gc.scatter_add_sorted(scratch, keys_1, perm_1, deltas_1, 1), 30,
            flush),
        "zipf": scatter_zipf(torch, ref, gc, st0, deltas, flush, dev),
        "design": "torch.sort(stable=True) (timed apart as sort_ms), then a warp per 32 "
                  "sorted positions for segments <= T and, on a side stream beside it, a "
                  "CTA per (segment > T, 16-column slab), delta rows through a 4-stage "
                  "cp.async ring; every row's adds in flat order",
    }
    del st0, scratch, dup, idx, keys, perm, distinct, keys_u, perm_u, captured["scatter"]

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
    fg_bytes = (2 * n_valid * D * 4 + slots.numel() * 4 + n_unique * D * 4
                + flat.numel() * 4 + nb * D * 4)
    b_ms, b_by = bound(fg_bytes, nb * (L - 1) * D)
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
        "library": "index_copy_ + F.embedding_bag (two calls)",
        **access_rates(torch, out["fill_gather_reduce"]["ms"], fg_bytes, flat, D * 4, False,
                       n_valid)}
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


def train_run_q(torch, mods, cfg, base_table, name, precision, fused, fast, captured):
    """One reduced-precision run through ``train_dlrm`` (``--precision``,
    stochastic rounding) from a copy of ``base_table``; the plain versions
    raise during it, and every kernel launch must come from the main thread.
    Captures the middle step's kernel and epilogue operands into
    ``captured`` under "<precision> <kernel>" (not in ``fast`` runs).
    Returns (result, launch counts, stage times, ms/step after the warm-up,
    the guards' report)."""
    ops, ref, gr, qz = mods["ops"], mods["ref"], mods["gr"], mods["qz"]
    report, unguard = run_guards(mods, fast)
    at = TRAIN_STEPS // 2
    fused_names = ("fill_gather_reduce", "fill_gather_reduce_q")
    targets = [(gr, n) for n in ("gather_reduce", "gather_reduce_q", "fill") + fused_names]
    targets.append((qz, "requantize_update"))
    real = {n: getattr(m, n) for m, n in targets}
    calls = {}

    def spy(n):
        fn = real[n]
        wanted = (n in fused_names) == fused  # split runs: the rest

        def wrapper(*a):
            calls[n] = calls.get(n, 0) + 1
            if wanted and not fast and calls[n] == at:
                captured[f"{precision} {n}"] = clone_args(torch, a)
            return fn(*a)
        return wrapper

    argv = ["--arch", "dlrm-scratchpipe", "--steps", str(TRAIN_STEPS), "--batch",
            str(BATCH), "--seed", "0", "--runtime", "scratchpipe", "--device", DEVICE,
            "--precision", precision]
    args = mods["train"].build_parser().parse_args(
        argv + (["--fused"] if fused else []) + (FAST_ARGV if fast else []))
    host = mods["HostEmbeddingTable"](base_table.shape[0], base_table.shape[1],
                                      data=base_table.copy())
    for m, n in targets:
        setattr(m, n, spy(n))
    restore_plain = plain_versions_raise(ref)
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
        restore_plain()
        unguard()
    step_ends = ends[TRAIN_STEP_LABEL["scratchpipe"]]
    ms_per_step = ((step_ends[-1] - step_ends[TRAIN_WARMUP - 1])
                   / (len(step_ends) - TRAIN_WARMUP) * 1e3)
    return res, counts, stages, ms_per_step, report


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
    for name, precision, fused, fast in Q_RUNS:
        t0 = time.perf_counter()
        res, counts, stages, ms, report = train_run_q(torch, mods, cfg, base, name,
                                                      precision, fused, fast, captured)
        stats, pipe = res["stats"], res["pipe"]
        check(pipe.device.type == dev.type and pipe.precision == precision
              and pipe.num_slots == Q_NOMINAL_SLOTS * Q_MULT[precision]
              and pipe.nominal_slots == Q_NOMINAL_SLOTS,
              f"{name}: the runtime is not the {precision} one on the card")
        if fast:
            check(isinstance(pipe.planner, mods["plan_device"].DevicePlanner)
                  and pipe.executor == "overlapped",
                  f"{name}: not the device planner with the overlapped executor")
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
        pipe.close()
        table = res["host"].data
        if not fused:
            split[precision] = (losses, table)
        else:
            s_losses, s_table = split[precision]
            check(torch.equal(losses, s_losses),
                  f"{name}: losses differ from the split run at steps "
                  f"{torch.nonzero(losses != s_losses).flatten().tolist()}")
            check((s_table == table).all(), f"{name}: flushed host table differs from split")
        tr = pipe.traffic()
        summaries.append({
            **train_summary(name, fast, ms, res, stages, report),
            "precision": precision, "rounding": res["cfg"].rounding,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "max_rel_loss_vs_fp32": rel, "evicted_rows": evicted,
            "evicting_steps": sum(1 for st in stats if st.n_evict > 0),
            "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
            "launches": counts,
            "scratchpad_rows": pipe.num_slots, "nominal_slots": pipe.nominal_slots,
        })
        print("train: " + json.dumps(summaries[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"train: {name} done ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, table
    del split
    log("train: per precision, split, fused and device+overlapped fused losses and flushed "
        "host tables bitwise equal; losses within " + ", ".join(f"{p} {t:g}" for p, t in Q_LOSS_RTOL.items())
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


def staged_path(data, bags) -> bool:
    """Whether csrc/gather_reduce.cu stages this int8 payload's rows in
    shared memory (its redesigned gather): D % 16 == 0, payload and bags
    16-byte aligned."""
    return (data.shape[1] % 16 == 0 and data.data_ptr() % 16 == 0
            and bags.data_ptr() % 16 == 0)


def q_gather_times(torch, mods, precision, data, scale, flat, flush, what):
    """The fp16 gather (``scale`` None) or the int8 ``gather_reduce_q`` at
    one call's operands: checked bitwise against its plain version, then
    timed beside its bound. Returns (numbers, details)."""
    gr, ref = mods["gr"], mods["ref"]
    int8 = precision == "int8"
    gk = Q_KEYS[precision][0]
    if int8:
        kernel = lambda: gr.gather_reduce_q(data, scale, flat)  # noqa: E731
    else:
        kernel = lambda: gr.gather_reduce(data, flat)  # noqa: E731
    plain = lambda: ref.gather_reduce_q_ref(data, scale, flat)  # noqa: E731
    got, want = kernel(), plain()
    check(torch.equal(got, want), f"{gk} differs at the {what} operands")
    nb, L = flat.shape
    D, item = data.shape[1], data.element_size()
    if int8:  # the times below are of the staged path
        check(staged_path(data, got), "the int8 gather's operands miss the staged path: "
              f"D={D}, payload at {data.data_ptr()}, bags at {got.data_ptr()}")
    row_b = D * item + (4 if int8 else 0)
    n_unique = int(torch.unique(flat).numel())
    g_bytes = n_unique * row_b + flat.numel() * 4 + nb * D * 4
    g_ops = nb * (L - 1) * D + (nb * L * D if int8 else 0)
    b_ms, b_by = bound(g_bytes, g_ops)
    out = {
        "ms": median_ms(torch, kernel, 30, flush),
        "plain_ms": median_ms(torch, plain, 10, flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": NO_LIBRARY["gather"].format(p=precision),
        "max_abs_err": (got - want).abs().max().item(),
    }
    details = {"storage": list(data.shape), "dtype": str(data.dtype), "bags": nb,
               "L": L, "unique_rows": n_unique, "bytes": g_bytes,
               **access_rates(torch, out["ms"], g_bytes, flat, D * item, int8)}
    return out, details


def q_fill_times(torch, mods, precision, st0, slots, rows, flush, what):
    """The fp16 fill or the int8 payload fill at one call's operands, into
    a copy of ``st0``: checked bitwise against its plain version, then
    timed beside its bound and ``index_copy_``. Returns (numbers,
    details)."""
    gr, ref = mods["gr"], mods["ref"]
    fk = Q_KEYS[precision][1]
    scratch = st0.clone()
    gr.fill(scratch, slots, rows)
    want = ref.fill_ref(st0.clone(), slots, rows)
    check(torch.equal(scratch, want), f"{fk} differs at the {what} operands")
    fill_err = (scratch.float() - want.float()).abs().max().item()
    del want
    valid = slots < st0.shape[0]
    n_valid = int(valid.sum().item())
    D, item = st0.shape[1], st0.element_size()
    f_bytes = 2 * n_valid * D * item + slots.numel() * 4
    v_slots, v_rows = slots[valid].long(), rows[valid]
    out = {
        "ms": median_ms(torch, lambda: gr.fill(scratch, slots, rows), 30, flush),
        "plain_ms": median_ms(torch, lambda: ref.fill_ref(scratch, slots, rows), 10,
                              flush),
        "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": median_ms(
            torch, lambda: scratch.index_copy_(0, v_slots, v_rows), 30, flush),
        "max_abs_err": fill_err,
    }
    details = {"storage": list(st0.shape), "F": int(slots.numel()),
               "valid_rows": n_valid, "bytes": f_bytes}
    return out, details


def time_q_kernels(torch, mods, captured, dev):
    """The fp16/int8 gathers, fills and fused kernels at the operands the
    reduced-precision runs gave them (the middle step), each against its
    plain version (bitwise) and its bound; the plain requantize epilogue
    timed apart. Returns ({kernel: numbers}, details)."""
    ref, gr, qz = mods["ref"], mods["gr"], mods["qz"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    out, details = {}, {}
    for precision in Q_KEYS:
        gk, fk, fgk = Q_KEYS[precision]
        int8 = precision == "int8"

        # the gather: fp16 storage, or int8 payload + scale
        if int8:
            data, scale, flat = captured.pop("int8 gather_reduce_q")
        else:
            (data, flat), scale = captured.pop("fp16 gather_reduce"), None
        out[gk], details[gk] = q_gather_times(torch, mods, precision, data, scale, flat,
                                              flush, "training")
        if int8:  # the same launch with the scale column read into L2 first:
            # what the scale's random sectors cost, and what the payload's cost
            sink = torch.empty(1, device=dev)
            details[gk]["ms_scale_in_L2"] = median_ms(
                torch, lambda: gr.gather_reduce_q(data, scale, flat), 30, flush,
                warm=lambda: torch.sum(scale, dim=(0,), out=sink))
        D, item = data.shape[1], data.element_size()
        row_b = D * item + (4 if int8 else 0)
        del data, scale, flat

        # the fill (the payload of an int8 pair)
        st0, slots, rows = captured.pop(f"{precision} fill")
        out[fk], details[fk] = q_fill_times(torch, mods, precision, st0, slots, rows,
                                            flush, "training")
        del st0, slots, rows

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
        if int8:
            check(staged_path(got_st, got), "the fused int8 operands miss the staged path: "
                  f"D={D}, payload at {got_st.data_ptr()}, bags at {got.data_ptr()}")
        err = (got - want).abs().max().item()
        del got_st, want_st
        valid = slots < st0.shape[0]
        n_valid = int(valid.sum().item())
        nb, L = flat.shape
        g_ops = nb * (L - 1) * D + (nb * L * D if int8 else 0)
        n_unique = int(torch.unique(flat).numel())
        fg_bytes = (2 * n_valid * D * item + slots.numel() * 4 + n_unique * row_b
                    + flat.numel() * 4 + nb * D * 4)
        b_ms, b_by = bound(fg_bytes, g_ops)
        scratch = st0.clone()
        check(not int8 or scratch.data_ptr() % 16 == 0, "the timed payload is not 16-byte aligned")
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
                        "bytes": fg_bytes,
                        **access_rates(torch, out[fgk]["ms"], fg_bytes, flat, D * item, int8,
                                       n_valid)}
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


# --------------------------------------------------------------------------- #
# 10. the LM serving path
# --------------------------------------------------------------------------- #
LM_PLAIN_VERSIONS = PLAIN_VERSIONS + ("flash_attention_ref", "ssd_chunk_scan_ref")


def lm_run(torch, mods, cfg=None, plain=False):
    """One ``run_lm`` (``cfg`` overrides the arch's config). With
    ``plain=False`` the plain versions raise during the run and the first
    operands of each kernel are captured; with ``plain=True`` the launchers
    are swapped for the plain versions (run on the card). Returns (result,
    launch counts after the prefill, launch counts at the end, captured
    operands, host ms of each decode step, its token on the host)."""
    ops, ref, fa, ssd, hybrid = (mods[k] for k in ("ops", "ref", "fa", "ssd", "hybrid"))
    real = {"fa": fa.flash_attention, "ssd": ssd.ssd_chunk_scan,
            "decode": hybrid.decode_step}
    real_refs = {n: getattr(ref, n) for n in LM_PLAIN_VERSIONS}
    captured, at_decode, step_ms = {}, [], []

    def spy_fa(q, k, v, causal, window):
        captured.setdefault("flash", (q.clone(), k.clone(), v.clone(), causal, window))
        return real["fa"](q, k, v, causal, window)

    def spy_ssd(x, dt, A, Bm, Cm, Q):
        captured.setdefault("ssd", tuple(t.clone() for t in (x, dt, A, Bm, Cm)) + (Q,))
        return real["ssd"](x, dt, A, Bm, Cm, Q)

    def spy_decode(*a, **k):
        if not at_decode:
            at_decode.append(ops.launch_counts())
        t = time.perf_counter()
        out = real["decode"](*a, **k)
        out[0].cpu()  # the step's token reaches the host, as the launcher reads it
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    if plain:
        fa.flash_attention = lambda q, k, v, causal, window: real_refs[
            "flash_attention_ref"](q, k, v, causal=causal, window=window)
        ssd.ssd_chunk_scan = lambda x, dt, A, Bm, Cm, Q: real_refs[
            "ssd_chunk_scan_ref"](x, dt, A, Bm, Cm, Q)
    else:
        fa.flash_attention, ssd.ssd_chunk_scan = spy_fa, spy_ssd
        for n in LM_PLAIN_VERSIONS:
            setattr(ref, n, no_plain)
    hybrid.decode_step = spy_decode
    try:
        ops.reset_launch_counts()
        res = mods["serve"].run_lm(mods["serve"].build_parser().parse_args(LM_ARGV),
                                   cfg=cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        fa.flash_attention, ssd.ssd_chunk_scan = real["fa"], real["ssd"]
        hybrid.decode_step = real["decode"]
        for n, fn in real_refs.items():
            setattr(ref, n, fn)
    return res, (at_decode[0] if at_decode else counts), counts, captured, step_ms


def check_lm_result(torch, res, cfg, dev, what):
    vocab, G = cfg.vocab_size, cfg.hybrid_groups
    logits, cache, tokens = res["logits"], res["cache"], res["tokens"]
    check(logits.device.type == dev.type and tuple(logits.shape) == (LM_BATCH, vocab)
          and logits.dtype == torch.float32, f"{what}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{what}: non-finite logits")
    check(tokens.shape == (LM_BATCH, LM_GEN) and tokens.min() >= 0
          and tokens.max() < vocab, f"{what}: tokens {tokens.shape}")
    kv = (G, LM_BATCH, LM_PROMPT + LM_GEN + 1, cfg.num_kv_heads, cfg.head_dim)
    check(tuple(cache["k"].shape) == kv == tuple(cache["v"].shape),
          f"{what}: KV cache {tuple(cache['k'].shape)} != {kv}")
    check(bool(torch.isfinite(cache["groups"][-1][-1]["ssm"]).all()),
          f"{what}: non-finite SSM state")


def check_lm_counts(what, after_prefill, counts):
    want = LM_PREFILL_LAUNCHES
    got = {k: after_prefill[k] for k in want}
    check(got == want, f"{what}: prefill launched {got}, expected {want}")
    check({k: counts[k] for k in want} == want,
          f"{what}: decode launched LM kernels: {counts}")
    other = {k: v for k, v in counts.items() if k not in want and v}
    check(not other, f"{what}: other kernels launched: {other}")


def device_summary(torch, prof, wall_ms: float, named=("ssd_", "flash_fwd")) -> dict:
    """Kernel (device) time of a torch.profiler trace: the CUDA events only
    (an aten op's own device time is its kernels', so it is not added
    again), against the host wall of the traced region; the port's LM
    kernels (names containing one of ``named``) with their per-launch mean."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms, "kernel_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "ms": ms, "calls": n} for k, ms, n in rows[:12]],
            "named": [{"name": k[:90], "ms": ms, "calls": n, "mean_ms": ms / n}
                      for k, ms, n in rows if any(w in k for w in named)]}


def lm_profile(torch, mods, res):
    """Two warm prefills of ``res``'s params and prompt on the host clock,
    then one more prefill and one decode step (on ``res``'s grown cache, at
    its last free position) traced with torch.profiler. Returns (summary,
    the faster warm prefill's ms)."""
    from torch.profiler import ProfilerActivity, profile

    api, cfg = mods["api"], res["cfg"]
    batch = api.synth_batch(cfg, mods["ShapeSpec"]("serve", LM_PROMPT, LM_BATCH, "prefill"),
                            seed=0, device=DEVICE)
    prefill, decode = api.make_prefill_fn(cfg), api.make_decode_fn(cfg)
    tok = torch.as_tensor(res["tokens"][:, -1:], device=DEVICE)
    walls, summary = [], {}
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(res["params"], batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        for what, fn in (("prefill", lambda: prefill(res["params"], batch)),
                         ("decode step", lambda: decode(res["params"], res["cache"], tok,
                                                        LM_PROMPT + LM_GEN - 1))):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            summary[what] = device_summary(torch, prof, wall)
    summary["warm_prefill_ms"] = walls
    return summary, min(walls)


# --------------------------------------------------------------------------- #
# the LM kernels against their plain versions
# --------------------------------------------------------------------------- #
def lm_flash_check(torch, ops, ref, q, k, v, causal, window):
    """One flash launch against its plain version; returns (dtype, err)."""
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(ops.launch_counts()["flash_attention"] == before + 1, "flash launch count")
    err = (got.float() - want.float()).abs().max().item()
    name = str(q.dtype).split(".")[-1]
    check(got.dtype == q.dtype and err <= FLASH_ATOL[name],
          f"flash_attention differs by {err} > {FLASH_ATOL[name]} at q {tuple(q.shape)} "
          f"k {tuple(k.shape)} causal={causal} window={window} {name}")
    return name, err


def lm_ssd_check(torch, ops, ref, ssd_in, Q):
    """One SSD launch against its plain version; returns (dtype, err)."""
    before = ops.launch_counts()["ssd_chunk_scan"]
    y, h = ops.ssd_chunk_scan(*ssd_in, Q)
    y_ref, h_ref = ref.ssd_chunk_scan_ref(*ssd_in, Q)
    torch.cuda.synchronize()
    check(ops.launch_counts()["ssd_chunk_scan"] == before + 1, "ssd launch count")
    dy = (y.float() - y_ref.float()).abs()
    dh = (h - h_ref).abs().max().item()
    name = str(ssd_in[0].dtype).split(".")[-1]
    where = f"x {tuple(ssd_in[0].shape)} B {tuple(ssd_in[3].shape)} Q={Q} {name}"
    if name == "float32":
        check(dy.max().item() <= SSD_ATOL, f"ssd y differs by {dy.max().item()} at {where}")
    else:
        check(bool((dy <= SSD_BF16_ATOL + SSD_BF16_RTOL * y_ref.float().abs()).all()),
              f"ssd y (bf16) differs by {dy.max().item()} at {where}")
    check(dh <= SSD_ATOL, f"ssd state differs by {dh} at {where}")
    return name, max(dy.max().item(), dh)


def lm_sweep(torch, ops, ref, dev, captured) -> dict:
    """Both LM kernels against their plain versions at the main path's
    operands and over the sweep (the reference's input distributions);
    returns the largest error per kernel and dtype."""
    g = torch.Generator(device=dev).manual_seed(0)
    err = {}

    def keep(kernel, name_err):
        key = f"{kernel} {name_err[0]}"
        err[key] = max(err.get(key, 0.0), name_err[1])

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    q, k, v, causal, window = captured["flash"]
    keep("flash_attention", lm_flash_check(torch, ops, ref, q, k, v, causal, window))
    *ssd_in, Q = captured["ssd"]
    keep("ssd_chunk_scan", lm_ssd_check(torch, ops, ref, ssd_in, Q))
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, K, hd, causal, window in (
                (2, 128, 128, 8, 2, 64, True, None),  # GQA
                (2, 160, 160, 4, 1, 32, True, None),  # MQA, Sq not a block multiple
                (2, 256, 256, 8, 2, 64, True, 64),  # causal + window
                (1, 300, 300, 4, 4, 64, False, 100),
                (2, 200, 200, 4, 4, 64, False, None),  # non-causal, ragged keys
                (2, 70, 300, 4, 2, 64, False, None),
                (1, 100, 100, 4, 4, 128, True, None),  # hd 128
                (1, 1000, 1000, 8, 2, 128, True, None),
                # the tensor-core kernel's edges: 128-row q tiles, 64-key
                # blocks, GQA H/K = 4, hd padded to 32/64/128 (20: no
                # 16-byte rows)
                (2, 127, 127, 8, 2, 64, True, None), (2, 129, 129, 8, 2, 64, True, None),
                (1, 255, 255, 8, 2, 64, True, None), (1, 257, 257, 8, 2, 64, True, None),
                (2, 257, 257, 8, 2, 64, True, 100),  # the window crosses KV blocks
                (1, 257, 257, 8, 2, 64, False, 70),
                (2, 300, 70, 8, 2, 64, True, None), (1, 129, 257, 8, 2, 64, False, None),
                (2, 200, 200, 8, 2, 16, True, None), (2, 200, 200, 8, 2, 32, False, None),
                (2, 200, 200, 8, 2, 48, True, 64), (1, 257, 257, 8, 2, 128, True, None),
                (1, 100, 100, 4, 4, 20, True, None)):
            keep("flash_attention", lm_flash_check(
                torch, ops, ref, randn(B, Sq, H, hd, dtype=dtype),
                randn(B, Skv, K, hd, dtype=dtype), randn(B, Skv, K, hd, dtype=dtype),
                causal, window))
        for B, S, ng, hpg, hd, ds, Q in (
                (2, 300, 1, 4, 64, 64, 64),  # S % Q != 0
                (1, 600, 2, 2, 64, 128, 256), (2, 512, 1, 4, 64, 64, 256),
                (1, 130, 2, 2, 128, 128, 64), (1, 1000, 2, 8, 64, 64, 256),
                # the tensor-core kernel's edges: head dims not a multiple of
                # its 64-dim slab (20: rows not 16-byte multiples), ds padded
                # to 16 / 128, S below, at and one past Q = 64, 128, 256 (nc
                # = 1 among them), ng = 2 with hpg = 8, 16 chunks of state
                (1, 200, 1, 2, 16, 64, 64), (1, 200, 1, 2, 20, 64, 64),
                (1, 200, 1, 2, 48, 64, 64), (1, 200, 1, 2, 96, 64, 64),
                (1, 300, 1, 2, 64, 16, 128), (1, 300, 1, 2, 64, 128, 128),
                (1, 50, 1, 2, 64, 64, 64), (1, 64, 1, 2, 64, 64, 64),
                (1, 65, 1, 2, 64, 64, 64), (1, 100, 1, 2, 64, 64, 128),
                (1, 128, 1, 2, 64, 64, 128), (1, 129, 1, 2, 64, 64, 128),
                (1, 200, 1, 2, 64, 64, 256), (2, 256, 1, 4, 64, 64, 256),
                (1, 257, 1, 2, 64, 64, 256), (2, 700, 2, 8, 64, 64, 256),
                (1, 4096, 1, 4, 64, 64, 256)):
            nh = ng * hpg
            ssd_in = (randn(B, S, nh, hd, dtype=dtype), uniform(0.05, 1.0, B, S, nh),
                      -uniform(0.3, 4.0, nh), randn(B, S, ng, ds), randn(B, S, ng, ds))
            keep("ssd_chunk_scan", lm_ssd_check(torch, ops, ref, ssd_in, Q))
    before = ops.launch_counts()
    z = torch.zeros(2, 0, 4, 16, device=dev)
    ops.flash_attention(z, z, z)
    ops.flash_attention(torch.zeros(2, 5, 4, 16, device=dev), z, z)
    ops.ssd_chunk_scan(torch.zeros(2, 0, 4, 8, device=dev), torch.zeros(2, 0, 4, device=dev),
                       -torch.ones(4, device=dev), torch.zeros(2, 0, 1, 16, device=dev),
                       torch.zeros(2, 0, 1, 16, device=dev), 8)
    torch.cuda.synchronize()
    check(ops.launch_counts() == before, "an empty LM operand launched a kernel")
    return err


def lm_fp32_check(torch, mods, dev):
    """The prefill and decode at fp32 through the kernels, then with the
    plain versions on the card (TF32 off): logits within LM_LOGIT_RTOL of
    the plain run's largest, the greedy tokens equal. Returns a summary and
    the kernels' first fp32 operands."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = dataclasses.replace(mods["get_config"](LM_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    res_k, after_prefill, counts, captured, _ = lm_run(torch, mods, cfg=cfg)
    check_lm_result(torch, res_k, cfg, dev, "lm fp32 kernels")
    check_lm_counts("lm fp32 kernels", after_prefill, counts)
    logits_k, tokens_k = res_k["logits"].clone(), res_k["tokens"]
    summary = {"kernels_prefill_s": res_k["prefill_s"], "kernels_decode_s": res_k["decode_s"]}
    del res_k
    torch.cuda.empty_cache()
    res_p, _, counts_p, _, _ = lm_run(torch, mods, cfg=cfg, plain=True)
    check_lm_result(torch, res_p, cfg, dev, "lm fp32 plain")
    check(not any(counts_p.values()), f"the plain run launched kernels: {counts_p}")
    diff = (logits_k - res_p["logits"]).abs().max().item()
    scale = res_p["logits"].abs().max().item()
    check(diff <= LM_LOGIT_RTOL * scale,
          f"fp32 logits: kernels vs plain differ by {diff} > {LM_LOGIT_RTOL} x {scale}")
    check((tokens_k == res_p["tokens"]).all(),
          f"fp32 greedy tokens differ:\n{tokens_k}\n{res_p['tokens']}")
    summary.update({"plain_prefill_s": res_p["prefill_s"], "plain_decode_s": res_p["decode_s"],
                    "max_abs_logit_diff": diff, "max_abs_logit": scale,
                    "tokens_equal": True, "tf32": False, "tokens": tokens_k.tolist()})
    del res_p
    torch.cuda.empty_cache()
    return summary, captured


# --------------------------------------------------------------------------- #
# 11. timing of the LM kernels
# --------------------------------------------------------------------------- #
def valid_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(q, k) pairs the attention of these shapes needs (the unmasked ones)."""
    n = 0
    for qp in range(Sq):
        hi = min(Skv - 1, qp) if causal else Skv - 1
        lo = max(0, qp - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def time_lm_kernels(torch, mods, captured, captured32, sweep_err, dev, prefill_profile):
    """flash_attention and ssd_chunk_scan at the main path's (bf16) first
    operands: median ms (CUDA events, L2 flushed) beside the bound, the plain
    version and, for flash, SDPA; the fp32 run's operands timed too; the
    SSD's two launches apart, beside the traced prefill's per-launch means
    (``prefill_profile``, from lm_profile)."""
    import torch.nn.functional as F

    fa, ssd, ref = mods["fa"], mods["ssd"], mods["ref"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    out, details = {}, {}

    q, k, v, causal, window = captured["flash"]
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    pairs = valid_pairs(Sq, Skv, causal, window)
    f_ops = 4 * B * H * hd * pairs  # QK^T and PV, 2 flops per multiply-add
    f_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    t_ops, t_bytes = f_ops / BF16_OPS_PER_S, f_bytes / HBM_BYTES_PER_S
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out["flash_attention"] = {
        "ms": median_ms(torch, lambda: fa.flash_attention(q, k, v, causal, window), 20, flush),
        "plain_ms": median_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), 5, flush),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), 20, flush) if causal and window is None and H == K
        else None,
        "library": "F.scaled_dot_product_attention(is_causal=True), (B, H, S, hd) bf16",
        "max_abs_err": max(e for n, e in sweep_err.items() if n.startswith("flash")),
    }
    q32, k32, v32, c32, w32 = captured32["flash"]
    q32h, k32h, v32h = (t.transpose(1, 2).contiguous() for t in (q32, k32, v32))
    f32_ops, f32_bytes = f_ops / FP32_OPS_PER_S, f_bytes * 4 / q.element_size() / HBM_BYTES_PER_S
    details["flash_attention"] = {
        "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "hd": hd},
        "dtype": str(q.dtype), "causal": causal, "window": window, "pairs": pairs,
        "flops": f_ops, "bytes": f_bytes, "ops_ms_bf16": t_ops * 1e3,
        "bytes_ms": t_bytes * 1e3,
        "design": fa.ROUTES[q.dtype], "fp32_design": fa.ROUTES[torch.float32],
        "tflops_per_s": f_ops / out["flash_attention"]["ms"] / 1e9,
        "fp32_ms": median_ms(torch, lambda: fa.flash_attention(q32, k32, v32, c32, w32),
                             10, flush),
        # the fp32 form's bound at FP32_OPS_PER_S (it runs on fp32 FMAs) and
        # SDPA's fp32 time on the same operands (TF32 off)
        "fp32_bound_ms": max(f32_ops, f32_bytes) * 1e3,
        "fp32_bound_by": "operations" if f32_ops >= f32_bytes else "bytes",
        "fp32_library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
            q32h, k32h, v32h, is_causal=True), 10, flush)
        if c32 and w32 is None and H == K else None,
        "max_abs_err_by_dtype": {n: e for n, e in sweep_err.items() if n.startswith("flash")},
    }
    del qh, kh, vh, q32, k32, v32, q32h, k32h, v32h

    x, dt, A, Bm, Cm, Q = captured["ssd"]
    B, S, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2  # (i, j) pairs with j <= i in a full chunk
    s_ops = (B * nh * nc * (2 * tri * hd + 4 * Q * ds * hd)  # y_intra, C.h, state
             + B * ng * nc * 2 * tri * ds)  # C.B^T once per group
    s_bytes = (2 * x.numel() * x.element_size()  # x in, y out
               + 4 * (dt.numel() + A.numel() + Bm.numel() + Cm.numel() + B * nh * hd * ds))
    t_ops, t_bytes = s_ops / TF32_OPS_PER_S, s_bytes / HBM_BYTES_PER_S
    out["ssd_chunk_scan"] = {
        "ms": median_ms(torch, lambda: ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, Q), 20, flush),
        "plain_ms": median_ms(torch, lambda: ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, Q),
                              5, flush),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "library": "no single PyTorch call computes the chunked SSD scan",
        "max_abs_err": max(e for n, e in sweep_err.items() if n.startswith("ssd")),
    }
    # the operations the tensor-core route does: S.x on hi + lo of S, C.h
    # and the state update on three bf16 products each, C.B^T once per
    # group in fp32 FMAs
    s_ops_split = (B * nh * nc * (2 * 2 * tri * hd + 3 * 2 * Q * ds * hd + 3 * 2 * Q * ds * hd)
                   + B * ng * nc * 2 * tri * ds)
    # its two launches apart, on the same operands and workspace
    lib, stream = ssd._lib(), torch.cuda.current_stream(dev).cuda_stream
    work = torch.empty(ssd.workspace_shape(B, S, ng, ds, Q), dtype=torch.float32, device=dev)
    y_p, h_p = torch.empty_like(x), torch.empty((B, nh, hd, ds), device=dev)

    def gram():
        check(lib.repro_ssd_gram_bf16(Bm.data_ptr(), Cm.data_ptr(), work.data_ptr(), B, S, nh,
                                      ng, ds, Q, stream) == 0, "ssd G launch failed")

    def scan():
        check(lib.repro_ssd_scan_bf16(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                      work.data_ptr(), y_p.data_ptr(), h_p.data_ptr(), B, S,
                                      nh, hd, ng, ds, Q, stream) == 0, "ssd scan launch failed")

    gram_ms, scan_ms = median_ms(torch, gram, 20, flush), median_ms(torch, scan, 20, flush)
    y_c, h_c = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    check(torch.equal(y_c, y_p) and torch.equal(h_c, h_p),
          "ssd: the two launches apart differ from one call")
    ms = out["ssd_chunk_scan"]["ms"]
    traced = {r["name"]: r["mean_ms"] for r in prefill_profile["named"] if "ssd_" in r["name"]}
    log(f"ssd cross-check: CUDA events call {ms:.4f} = G {gram_ms:.4f} + scan {scan_ms:.4f} "
        f"ms; traced prefill per-launch means {traced}")
    x32, dt32, A32, B32, C32, Q32 = captured32["ssd"]
    s32_ops = s_ops / FP32_OPS_PER_S
    s32_bytes = (s_bytes + 2 * x32.numel() * (4 - x.element_size())) / HBM_BYTES_PER_S
    details["ssd_chunk_scan"] = {
        "shape": {"B": B, "S": S, "nh": nh, "hd": hd, "ng": ng, "ds": ds, "Q": Q},
        "dtype": str(x.dtype), "flops": s_ops, "bytes": s_bytes,
        "ops_ms_tf32": t_ops * 1e3, "ops_ms_bf16": s_ops / BF16_OPS_PER_S * 1e3,
        "bytes_ms": t_bytes * 1e3,
        "design": ssd.ROUTES[x.dtype], "fp32_design": ssd.ROUTES[torch.float32],
        "flops_at_splits": s_ops_split,
        "ops_ms_bf16_at_splits": s_ops_split / BF16_OPS_PER_S * 1e3,
        "gram_ms": gram_ms, "scan_ms": scan_ms,
        "tflops_per_s": s_ops / ms / 1e9, "tflops_per_s_at_splits": s_ops_split / ms / 1e9,
        "gb_per_s": s_bytes / ms / 1e6,
        "workspace_MB": work.numel() * 4 / 1e6,
        "traced_prefill_mean_ms": traced,
        "fp32_ms": median_ms(torch, lambda: ssd.ssd_chunk_scan(x32, dt32, A32, B32, C32, Q32),
                             10, flush),
        "fp32_bound_ms": max(s32_ops, s32_bytes) * 1e3,
        "fp32_bound_by": "operations" if s32_ops >= s32_bytes else "bytes",
        "max_abs_err_by_dtype": {n: e for n, e in sweep_err.items() if n.startswith("ssd")},
    }
    return out, details


# --------------------------------------------------------------------------- #
# 12. the device planner's plan_step at the main path's operands
# --------------------------------------------------------------------------- #
def plan_step_phase(torch, pd, captured, dev) -> dict:
    """plan_step on the card at the operands the device+overlapped run gave
    its middle step (state, ids, look-ahead union): run once under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync inside fails
    the phase), every output and the new state equal to the same call on
    the CPU; then ms per call (CUDA events, median, L2 flushed), and the
    stable sort of the slots' priorities timed apart."""
    state, ids, fut, pw = captured.pop("plan_step")
    cpu = pd.PlanState(*(t.cpu() for t in state))
    want_state, want = pd.plan_step(cpu, ids.cpu(), fut.cpu(), past_window=pw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_state, got = pd.plan_step(state, ids, fut, past_window=pw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for k, v in want.items():
        check(got[k].device.type == dev.type and torch.equal(got[k].cpu(), v),
              f"plan_step: output {k} differs from the CPU's")
    for f, v in zip(pd.PlanState._fields, want_state):
        # the dummy element takes padded writes in any order: not compared
        a, b = getattr(got_state, f).cpu(), v
        if a.ndim:
            a, b = a[:-1], b[:-1]
        check(torch.equal(a, b), f"plan_step: state {f} differs from the CPU's")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    prio = state.last_use[:-1].clone()
    out = {
        "ids": ids.numel(), "future_ids": fut.numel(),
        "slots": state.slot_to_id.numel() - 1, "rows": state.hitmap.numel() - 1,
        "n_unique": int(want["n_unique"]), "n_hits": int(want["n_hits"]),
        "n_miss": int((want["miss_ids"] >= 0).sum()), "n_evict": int(want["n_evict"]),
        "sync_debug_mode": "error: no host sync inside plan_step",
        "ms": median_ms(torch, lambda: pd.plan_step(state, ids, fut, past_window=pw), 20,
                        flush),
        "slot_sort_ms": median_ms(torch, lambda: torch.sort(prio, stable=True), 20, flush),
        "ids_sort_ms": median_ms(torch, lambda: torch.sort(ids), 20, flush),
    }
    return out



# --------------------------------------------------------------------------- #
# 13. trace serve: recorded serving traces at fp32, fp16 and int8
# --------------------------------------------------------------------------- #
#: the reduced-precision serving budget: 0.125 x 8M = 1,000,000 nominal
#: slots, under the launcher's depth-2 window floor of 8 x 163,840 =
#: 1,310,720, which sets it: fp16 holds 2,621,440 rows and evicts (phase 4's
#: 24 micro-batches fill ~4M rows), int8 5,242,880; at depth 0 the nominal
#: budget is 1,000,000 (the floor is 655,360)
Q_SERVE_CACHE_FRAC = 0.125
Q_SERVE_RUNS = (("fp16", DEPTH), ("fp16", 0), ("int8", DEPTH), ("int8", 0))
#: host threads submitting single requests to the front end, each the 2048
#: requests of one of the int8 trace's first micro-batches
FRONTEND_THREADS = 4
FRONTEND_RUN = "front end int8 scratchpipe-serve"


def trace_args(path: str, design: str, depth: int, cache_frac: float) -> list:
    return ["--embedding", "--trace", path, "--design", design, "--depth", str(depth),
            "--batch", str(BATCH), "--lookups", str(LOOKUPS), "--cache-frac",
            str(cache_frac), "--seed", "0", "--device", DEVICE]


def launch_threads(gr):
    """Record the id of every thread that calls a kernel wrapper of
    ``kernels/gather_reduce.py``; returns (the set of ids, restore)."""
    import threading

    ids, saved = set(), []
    for n in LAUNCHERS["gr"]:
        fn = getattr(gr, n)

        def wrapper(*a, _fn=fn):
            ids.add(threading.get_ident())
            return _fn(*a)
        saved.append((n, fn))
        setattr(gr, n, wrapper)

    def restore():
        for n, fn in saved:
            setattr(gr, n, fn)
    return ids, restore


def dequantized_host(mods, host, precision: str):
    """The reduced-precision oracle's host table: ``host``'s rows (shared,
    not copied), each gathered row quantized to ``precision`` and
    dequantized back, per row, as the serving fill quantizes it."""
    qz = mods["qz"]

    class DequantizedHost(mods["HostEmbeddingTable"]):
        def gather(self, ids):
            rows = super().gather(ids)
            return qz.dequantize_rows_np(qz.quantize_rows_np(rows, precision), precision)

    return DequantizedHost(host.rows, host.dim, data=host.data)


def capture_serve_operands(torch, gr, captured, precision: str):
    """Spy on a serving run's gather and fills of ``precision``'s form:
    copy the middle micro-batch's gather operands and the largest fill's
    (with the storage it filled) into ``captured``; returns restore()."""
    gname = "gather_reduce_q" if precision == "int8" else "gather_reduce"
    real_g, real_f, calls = getattr(gr, gname), gr.fill, [0]

    def spy_gather(*a):
        calls[0] += 1
        if calls[0] == STEPS // 2:
            captured[f"{precision} gather"] = clone_args(torch, a)
        return real_g(*a)

    def spy_fill(storage, slots, rows):
        best = captured.get(f"{precision} fill")
        if best is None or slots.numel() > best[1].numel():
            captured[f"{precision} fill"] = (storage.clone(), slots.clone(), rows.clone())
        return real_f(storage, slots, rows)

    setattr(gr, gname, spy_gather)
    gr.fill = spy_fill

    def restore():
        setattr(gr, gname, real_g)
        gr.fill = real_f
    return restore


def trace_serve_run(torch, mods, host, argv):
    """One serving run through the launcher's ``run_embedding`` on
    ``host``, the plain versions raising; returns (result, launch counts of
    the run, stage times)."""
    ops, serve, sc = mods["ops"], mods["serve"], mods["serving_cache"]
    args = serve.build_parser().parse_args(argv)
    restore_plain = plain_versions_raise(mods["ref"])
    stages, _, restore = stage_timers(
        serve_targets(sc) + [(sc.StaticCacheServer, "serve_next", "serve (whole cycle)")])
    try:
        ops.reset_launch_counts()
        res = serve.run_embedding(args, collect_bags=True, host=host)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        restore()
        restore_plain()
    return res, counts, stages


def serve_summary(name, res, counts, stages) -> dict:
    lat = res["latency"]
    return {"run": name, "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
            "lookups_per_s": res["lookups_per_s"], "hit_rate": res["hit_rate"],
            "warmup": res["warmup"], "served": res["served"], "wall_s": res["wall_s"],
            "evicted_rows": sum(st.n_evict for st in res["stats"]),
            "launches": {k: v for k, v in counts.items() if v}, "stages_s": stages}


def check_serve_counts(name, counts, gather: str, served: int, fill: str = None):
    """One ``gather`` per micro-batch, fills of ``fill``'s form, no other."""
    other = {k: v for k, v in counts.items() if v and k not in (gather, fill)}
    check(counts[gather] == served and not other
          and (fill is None or counts[fill] > 0),
          f"{name}: launches {counts}, {served} micro-batches")


def check_bags(name, got, want):
    check(len(got) == len(want) == STEPS, f"{name}: every micro-batch served")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == (BATCH, TABLES, DIM) and a.dtype == b.dtype and (a == b).all(),
              f"{name}: bags of serve {i} differ from the oracle's")


def frontend_run(torch, mods, host, group, path, oracle_bags) -> tuple:
    """EmbeddingServer over an int8 scratchpipe-serve on the card:
    FRONTEND_THREADS host threads each submit one micro-batch's requests
    one at a time; each future's bags must equal the oracle's for that
    request, and every kernel launch must come from the front end's worker
    thread. Returns (the run's summary, its launch counts)."""
    import threading

    import numpy as np

    from repro_torch.core.runtime import make_runtime
    from repro_torch.serving import EmbeddingServer
    from repro_torch.traces import TraceReader

    ops, gr, serve = mods["ops"], mods["gr"], mods["serve"]
    reader = TraceReader(path)
    reqs = [reader.batch(b)[0] for b in range(FRONTEND_THREADS)]
    reader.close()
    int8 = group.with_precision("int8")
    backend = make_runtime(
        "scratchpipe-serve", host, None, window=DEPTH, table_group=int8, device=DEVICE,
        num_slots=serve.scratchpad_slots(int8, BATCH, LOOKUPS, DEPTH, Q_SERVE_CACHE_FRAC))
    results, latencies = {}, []

    def client(t):
        futures = []
        for r in reqs[t]:
            t_sub = time.perf_counter()
            f = fe.lookup(r)
            f.add_done_callback(
                lambda _f, t_sub=t_sub: latencies.append(time.perf_counter() - t_sub))
            futures.append(f)
        results[t] = np.stack([f.result(timeout=600) for f in futures])

    threads, restore_threads = launch_threads(gr)
    restore_plain = plain_versions_raise(mods["ref"])
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with EmbeddingServer(backend, max_batch=BATCH) as fe:
            clients = [threading.Thread(target=client, args=(t,), name=f"client-{t}")
                       for t in range(FRONTEND_THREADS)]
            for th in clients:
                th.start()
            for th in clients:
                th.join(timeout=600)
            worker = fe._thread.ident
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        restore_plain()
        restore_threads()
    check(sorted(results) == list(range(FRONTEND_THREADS)), "a front-end client failed")
    for t in range(FRONTEND_THREADS):
        check(results[t].shape == (BATCH, TABLES, DIM)
              and (results[t] == oracle_bags[t]).all(),
              f"front end: bags of client {t}'s requests differ from the oracle's")
    check(threads == {worker},
          f"front end: kernels launched from threads {threads}, the worker is {worker}")
    cycles = len(backend.stats)
    check_serve_counts("front end", counts, "gather_reduce_q", cycles, "fill_i8")
    lat = sorted(latencies)
    n = len(reqs) * BATCH
    return {"run": FRONTEND_RUN, "requests": n,
            "client_threads": FRONTEND_THREADS, "cycles": cycles, "wall_s": wall,
            "requests_per_s": n / wall, "lookups_per_s": n * TABLES * LOOKUPS / wall,
            "request_p50_ms": lat[len(lat) // 2] * 1e3,
            "request_p99_ms": lat[int(len(lat) * 0.99)] * 1e3,
            "launching_threads": 1,
            "launches": {k: v for k, v in counts.items() if v}}, counts


def trace_serve_phase(torch, mods, tmp: str, phase4_bags):
    """Phase 13: phase 4's micro-batches recorded as serving traces at
    fp32, fp16 and int8, served through ``launch/serve.py --trace`` on one
    host table. Returns (summaries, launch counts per run, captured kernel
    operands)."""
    from repro_torch.core.table_group import TableGroup
    from repro_torch.traces import record_serving_trace, scenario_batches

    serve = mods["serve"]
    group = TableGroup.uniform(TABLES, ROWS, DIM)
    t0 = time.perf_counter()
    items = list(scenario_batches("inference_mix", group, STEPS, batch_size=BATCH,
                                  lookups_per_table=LOOKUPS, seed=0))
    paths = {}
    for p in ("fp32", "fp16", "int8"):
        paths[p] = os.path.join(tmp, f"serve-{p}")
        n = record_serving_trace(paths[p], group.with_precision(p), iter(items),
                                 provenance={"scenario": "inference_mix", "seed": 0})
        check(n == STEPS, f"recorded {n} micro-batches, not {STEPS}")
    del items
    mb = sum(os.path.getsize(os.path.join(paths["fp32"], f))
             for f in os.listdir(paths["fp32"])) / 1e6
    log(f"trace serve: three serving traces of {STEPS} micro-batches recorded, {mb:.1f} MB "
        f"each ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    # the launcher's host table (--seed 0 builds it from seed 1), built once
    host = mods["HostEmbeddingTable"](group.total_rows, DIM, seed=1)
    log(f"trace serve: host table {host.data.shape} fp32 built in "
        f"{time.perf_counter() - t0:.1f}s")
    summaries, counts_by_run, captured = [], {}, {}

    def record(name, res, counts, stages, **extra):
        summaries.append({**serve_summary(name, res, counts, stages), **extra})
        counts_by_run[name] = counts
        print("serve: " + json.dumps(summaries[-1]), flush=True)

    # fp32 scratchpipe-serve over the trace: phase 4's bags
    t0 = time.perf_counter()
    name = f"trace fp32 scratchpipe-serve depth {DEPTH}"
    res, counts, stages = trace_serve_run(
        torch, mods, host, trace_args(paths["fp32"], "scratchpipe-serve", DEPTH, CACHE_FRAC))
    check(res["backend"].precision == "fp32", f"{name}: not the fp32 scratchpad")
    check_bags(name, res["bags"], phase4_bags)
    check(res["hit_rate"] == 1.0, f"{name}: post-warm-up hit rate {res['hit_rate']}")
    check_serve_counts(name, counts, "gather_reduce", STEPS, "fill")
    record(name, res, counts, stages)
    del res
    log(f"trace serve: {name} bitwise equal to phase 4 ({time.perf_counter() - t0:.1f}s)")

    # fp16 and int8: the oracle is nocache-serve over dequantized host rows
    oracle = {}
    for precision in ("fp16", "int8"):
        t0 = time.perf_counter()
        o = serve.run_embedding(
            serve.build_parser().parse_args(
                trace_args(paths[precision], "nocache-serve", 0, Q_SERVE_CACHE_FRAC)),
            collect_bags=True, host=dequantized_host(mods, host, precision))
        oracle[precision] = o["bags"]
        check(any((a != b).any() for a, b in zip(o["bags"], phase4_bags)),
              f"the {precision} oracle equals the fp32 bags")
        log(f"trace serve: the {precision} oracle served ({time.perf_counter() - t0:.1f}s)")
        del o
    for precision, depth in Q_SERVE_RUNS:
        t0 = time.perf_counter()
        name = f"trace {precision} scratchpipe-serve depth {depth}"
        restore = (capture_serve_operands(torch, mods["gr"], captured, precision)
                   if depth == DEPTH else (lambda: None))
        try:
            res, counts, stages = trace_serve_run(
                torch, mods, host,
                trace_args(paths[precision], "scratchpipe-serve", depth, Q_SERVE_CACHE_FRAC))
        finally:
            restore()
        backend = res["backend"]
        nominal = serve.scratchpad_slots(group, BATCH, LOOKUPS, depth, Q_SERVE_CACHE_FRAC)
        check(backend.precision == precision and backend.nominal_slots == nominal
              and backend.num_slots == nominal * Q_MULT[precision],
              f"{name}: not the {precision} scratchpad of {nominal} nominal slots")
        check_bags(name, res["bags"], oracle[precision])
        if depth == DEPTH:
            check(res["hit_rate"] == 1.0, f"{name}: post-warm-up hit rate {res['hit_rate']}")
        evicted = sum(st.n_evict for st in res["stats"])
        if precision == "fp16":
            check(evicted > 0, f"{name}: nothing was evicted")
        gk, fk = Q_KEYS[precision][:2]
        check_serve_counts(name, counts, gk, STEPS, fk)
        record(name, res, counts, stages, precision=precision,
               scratchpad_rows=backend.num_slots, nominal_slots=nominal)
        del res, backend
        log(f"trace serve: {name} bitwise equal to the dequantized oracle, {evicted} rows "
            f"evicted ({time.perf_counter() - t0:.1f}s)")

    # static-serve: nocache-serve's bags, which phase 4's equal
    t0 = time.perf_counter()
    name = f"trace fp32 static-serve depth {DEPTH}"
    res, counts, stages = trace_serve_run(
        torch, mods, host, trace_args(paths["fp32"], "static-serve", DEPTH, CACHE_FRAC))
    check_bags(name, res["bags"], phase4_bags)
    check_serve_counts(name, counts, "gather_reduce", STEPS)
    record(name, res, counts, stages, hot_rows=int(res["backend"].hot_ids.size))
    del res
    log(f"trace serve: {name} bitwise equal to nocache-serve ({time.perf_counter() - t0:.1f}s)")

    # the front end over int8 scratchpipe-serve
    t0 = time.perf_counter()
    fe, counts_by_run[FRONTEND_RUN] = frontend_run(torch, mods, host, group, paths["int8"],
                                                   oracle["int8"])
    print("serve: " + json.dumps(fe), flush=True)
    log(f"trace serve: front end: {fe['requests']} requests from {FRONTEND_THREADS} threads "
        f"in {fe['cycles']} cycles, bitwise equal to the oracle, every launch from its "
        f"worker thread ({time.perf_counter() - t0:.1f}s)")
    return summaries + [fe], counts_by_run, captured


def time_serve_q_kernels(torch, mods, captured, dev):
    """``gather_reduce_q``, the fp16 gather and the fp16/int8 fills at the
    operands the depth-2 trace-serve runs gave them. Returns ({kernel:
    numbers}, details)."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)  # 128 MB > L2
    out, details = {}, {}
    for precision in Q_KEYS:
        gk, fk = Q_KEYS[precision][:2]
        if precision == "int8":
            data, scale, flat = captured.pop("int8 gather")
        else:
            (data, flat), scale = captured.pop("fp16 gather"), None
        out[gk], details[gk] = q_gather_times(torch, mods, precision, data, scale, flat,
                                              flush, "serving")
        del data, scale, flat
        st0, slots, rows = captured.pop(f"{precision} fill")
        out[fk], details[fk] = q_fill_times(torch, mods, precision, st0, slots, rows,
                                            flush, "serving")
        del st0, slots, rows
    return out, details


# --------------------------------------------------------------------------- #
# 14. trace train: phase 6's batches replayed from a recorded trace
# --------------------------------------------------------------------------- #
def trace_train_phase(torch, mods, tmp: str, base, losses6, digest6, ms6):
    """Record phase 6's 24 synthetic batches with ``record_trace``, replay
    them with ``train_dlrm --trace`` through scratchpipe device+overlapped
    fused: losses and the flushed host table bitwise equal to phase 6's.
    Returns (summary, {run: launch counts})."""
    from repro_torch.core.table_group import TableGroup
    from repro_torch.data.synthetic import TraceConfig, dlrm_batches
    from repro_torch.traces import record_trace

    cfg = mods["DLRMConfig"](rows_per_table=ROWS, cache_fraction=TRAIN_CACHE_FRAC)
    path = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    tc = TraceConfig(num_tables=TABLES, rows_per_table=ROWS, lookups_per_table=LOOKUPS,
                     batch_size=BATCH, locality="medium", seed=0)
    n = record_trace(path, TableGroup.from_config(cfg), dlrm_batches(tc, TRAIN_STEPS),
                     provenance={"generator": "synthetic", "locality": "medium", "seed": 0})
    check(n == TRAIN_STEPS, f"recorded {n} batches, not {TRAIN_STEPS}")
    log(f"trace train: {n} batches recorded ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    name = "scratchpipe device+overlapped fused --trace"
    res, counts, stages, ms, report = train_run(torch, mods, cfg, base, name, "scratchpipe",
                                                True, True, {}, extra_argv=["--trace", path])
    stats, pipe = res["stats"], res["pipe"]
    check(res["cfg"].name == "dlrm-trace" and res["cfg"].cache_fraction == TRAIN_CACHE_FRAC
          and res["cfg"].bottom_mlp == cfg.bottom_mlp, f"{name}: the trace's config is off")
    check(isinstance(pipe.planner, mods["plan_device"].DevicePlanner)
          and pipe.executor == "overlapped",
          f"{name}: not the device planner with the overlapped executor")
    check_train_counts(name, "scratchpipe", True, stats, counts, stages)
    losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
    check(torch.equal(losses, losses6),
          f"{name}: losses differ from phase 6's at steps "
          f"{torch.nonzero(losses != losses6).flatten().tolist()}")
    pipe.flush_to_host()
    pipe.close()
    check(table_digest(res["host"].data) == digest6,
          f"{name}: the flushed host table differs from phase 6's")
    tr = pipe.traffic()
    summary = {
        **train_summary(name, True, ms, res, stages, report),
        "phase6_ms_per_step": ms6, "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
        "launches": counts,
    }
    print("train: " + json.dumps(summary), flush=True)
    log(f"trace train: losses and the flushed host table bitwise equal to phase 6's; "
        f"{ms:.2f} ms/step against phase 6's {ms6:.2f} ({time.perf_counter() - t0:.1f}s)")
    return summary, {name: counts}

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
    from repro_torch.configs import get_config
    from repro_torch.configs.base import DLRMConfig, ShapeSpec
    from repro_torch.core import dlrm_runtime, pipeline, serving_cache, static_cache
    from repro_torch.core import plan, plan_device
    from repro_torch.core import quantize as qz
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_reduce as gr
    from repro_torch.kernels import grad_coalesce as gc
    from repro_torch.kernels import ssd_chunk as ssd
    from repro_torch.launch import serve, train
    from repro_torch.models import api, hybrid
    from repro_torch.models.dlrm import interaction_dim

    mods = {"ops": ops, "ref": ref, "gr": gr, "gc": gc, "qz": qz, "train": train,
            "pipeline": pipeline, "static_cache": static_cache,
            "dlrm_runtime": dlrm_runtime, "HostEmbeddingTable": HostEmbeddingTable,
            "DLRMConfig": DLRMConfig, "interaction_dim": interaction_dim,
            "fa": fa, "ssd": ssd, "serve": serve, "api": api, "hybrid": hybrid,
            "ShapeSpec": ShapeSpec, "get_config": get_config, "plan": plan,
            "plan_device": plan_device, "serving_cache": serving_cache}

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
    sweep_err = sweep_kernels(torch, ops, ref, gc, qz, dev)
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
    serve_bags = res["bags"]  # phase 13's fp32 and static-serve oracle
    del res, backend, captured
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    summaries, train_counts, train_captured, base, fp32_losses, fp32_digest = (
        train_main_path(torch, mods, dev))
    log(f"train: {len(TRAIN_RUNS)} runs done ({time.perf_counter() - t0:.1f}s)")

    plan_captured = {"plan_step": train_captured.pop("plan_step")}
    t0 = time.perf_counter()
    train_times, train_details = time_train_kernels(torch, ops, ref, gr, gc,
                                                    train_captured, dev)
    log(f"timing: training operands done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(train_details), flush=True)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, q_counts, q_captured = train_q_main_path(torch, mods, dev, base, fp32_losses)
    log(f"train: {len(Q_RUNS)} reduced-precision runs done ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    q_times, q_details = time_q_kernels(torch, mods, q_captured, dev)
    log(f"timing: reduced-precision operands done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(q_details), flush=True)

    del q_captured
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("lm serve: " + " ".join(LM_ARGV))
    res, after_prefill, lm_counts, lm_captured, step_ms = lm_run(torch, mods)
    lm_cfg = res["cfg"]
    check(lm_cfg == get_config(LM_ARCH) and lm_cfg.d_model == 2048
          and lm_cfg.num_layers == 38 and lm_cfg.vocab_size == 32000,
          "the LM config is not the full zamba2-1.2b")
    check(res["params"]["embed"].dtype == torch.bfloat16
          and res["params"]["embed"].device.type == dev.type, "params not bf16 on the card")
    check_lm_result(torch, res, lm_cfg, dev, "lm serve")
    check_lm_counts("lm serve", after_prefill, lm_counts)
    log(f"lm serve: prefill launched {after_prefill['ssd_chunk_scan']} ssd_chunk_scan + "
        f"{after_prefill['flash_attention']} flash_attention, decode none "
        f"({time.perf_counter() - t0:.1f}s)")
    profile, warm_ms = lm_profile(torch, mods, res)
    lm_summary = {
        "prefill_ms_cold": res["prefill_s"] * 1e3, "prefill_ms_warm": warm_ms,
        "decode_ms_per_step": res["decode_s"] / max(res["decode_steps"], 1) * 1e3,
        "decode_step_ms": step_ms,
        "decode_step_ms_median": statistics.median(step_ms) if step_ms else None,
        "prompt_tokens_per_s_warm": LM_BATCH * LM_PROMPT / (warm_ms / 1e3),
        "decode_tokens_per_s": LM_BATCH * res["decode_steps"] / res["decode_s"],
        "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
        "launches_after_prefill": {k: after_prefill[k] for k in LM_PREFILL_LAUNCHES},
        "launches_total": {k: lm_counts[k] for k in LM_PREFILL_LAUNCHES},
        "tokens": res["tokens"].tolist(), "profile": profile,
    }
    print("lm serve: " + json.dumps(lm_summary), flush=True)
    del res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm_err = lm_sweep(torch, ops, ref, dev, lm_captured)
    log(f"lm kernels: within tolerance of their plain versions {lm_err} "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    fp32_summary, lm_captured32 = lm_fp32_check(torch, mods, dev)
    log(f"lm fp32: kernels vs plain logits {fp32_summary['max_abs_logit_diff']:.3g} of "
        f"{fp32_summary['max_abs_logit']:.3g}, {LM_GEN} greedy tokens equal "
        f"({time.perf_counter() - t0:.1f}s)")
    print("lm fp32: " + json.dumps(fp32_summary), flush=True)
    t0 = time.perf_counter()
    lm_times, lm_details = time_lm_kernels(torch, mods, lm_captured, lm_captured32, lm_err,
                                           dev, lm_summary["profile"]["prefill"])
    log(f"timing: LM operands done ({time.perf_counter() - t0:.1f}s)")
    print("details: " + json.dumps(lm_details), flush=True)
    del lm_captured, lm_captured32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    plan_summary = plan_step_phase(torch, plan_device, plan_captured, dev)
    log(f"plan_step: equal to the CPU's, no host sync, {plan_summary['ms']:.4f} ms per call "
        f"(the slots' stable sort {plan_summary['slot_sort_ms']:.4f}) "
        f"({time.perf_counter() - t0:.1f}s)")
    print("plan_step: " + json.dumps(plan_summary), flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_traces_") as tmp:
        t0 = time.perf_counter()
        _, ts_counts, ts_captured = trace_serve_phase(torch, mods, tmp, serve_bags)
        del serve_bags
        log(f"trace serve: {len(ts_counts)} runs done ({time.perf_counter() - t0:.1f}s)")
        t0 = time.perf_counter()
        serve_q_times, serve_q_details = time_serve_q_kernels(torch, mods, ts_captured, dev)
        log(f"timing: serving operands done ({time.perf_counter() - t0:.1f}s)")
        print("details: " + json.dumps(serve_q_details), flush=True)
        del ts_captured
        torch.cuda.empty_cache()
        ms6 = next(r["ms_per_step"] for r in summaries
                   if r["run"] == "scratchpipe device+overlapped fused")
        _, tt_counts = trace_train_phase(torch, mods, tmp, base, fp32_losses, fp32_digest,
                                         ms6)
    del base

    by_run = {"serve": counts, **train_counts, **q_counts, **ts_counts, **tt_counts}
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
        if name == "scatter_add":
            kernels[-1]["details"] = train_details[name]
        if name in serve_q_times:  # phase 13's operands
            t = serve_q_times[name]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], t.pop("max_abs_err"))
            kernels[-1]["serve"] = t
    for name, source, replaces in (
            ("flash_attention", CU_SOURCE_FA, "src/repro/kernels/flash_attention.py:87"),
            ("ssd_chunk_scan", CU_SOURCE_SSD, "src/repro/kernels/ssd_chunk.py:81")):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": lm_counts[name], "launches_by_run": {"lm serve": lm_counts[name]},
            **lm_times[name],
        })
        if name == "flash_attention":
            kernels[-1]["details"] = {**lm_details[name],
                                      "warm_prefill_ms": lm_summary["prefill_ms_warm"],
                                      "prefill_profile": lm_summary["profile"]["prefill"]}
        else:
            kernels[-1]["details"] = lm_details[name]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
