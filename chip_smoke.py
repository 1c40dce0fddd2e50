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
               batches then go through ``nocache-serve`` over the same host
               table (``run_embedding(..., host=)``; serving never writes
               it): the bags must be bitwise equal, and the post-warm-up hit
               rate 1.000;
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
               ``nocache``, each from a copy of one host table (the first 8M
               rows of phase 15's seed-0 table, built once before this
               phase: the rows a seed-0 table of 8M rows holds). One cut:
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
  6b. observe — phase 6's device+overlapped fused run once more, from a
               copy of the same host table, with a ``repro_torch.obs``
               Tracer and MetricsRegistry installed: losses and the flushed
               table bitwise equal to phase 6's, the Chrome trace valid with
               spans on the main thread, ``scratchpipe-host_0`` and
               ``scratchpipe-d2h_0``, the ``cache.*`` counters equal to the
               StepStats sums, every launch on the main thread; prints each
               thread's span seconds and the traced ms/step beside phase 6's.
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
  8b. observe and recover — phase 8's fp16 and int8 device+overlapped
               fused runs traced and metered, each bitwise equal to its
               precision's untraced runs; then the drill: the fp16 run
               through ``launch/train.py``'s supervised path with ``--chaos
               "kill-gather@3;fail-writeback@5;kill-d2h@7;nan-loss@9;
               corrupt-row@13:5" --verify-every 4 --ckpt-every 8``
               (checkpoints in a temporary directory, removed): every event
               fired, at least two restores, the losses and flushed table
               bitwise equal to phase 8's unsupervised run, every launch on
               the main thread; and a clean ``--supervise`` twin with the
               same ``state_digest=``. Prints the save and restore
               milliseconds and the checkpoint bytes.
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
               --embedding --trace`` on phase 4's host table
               (``run_embedding(..., host=)``): fp32 ``scratchpipe-serve`` at depth 2
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
 13b. observe — the fp32 ``scratchpipe-serve`` replay of phase 13, traced
               and metered: bags bitwise equal to phase 13's, the ``serve.*``
               counters and the latency histogram equal to the replay's
               StepStats (emergency fills from ``StepStats.aux``); then the
               front end over an fp32 ``scratchpipe-serve`` fed by a
               ``TraceReplayStream`` of that trace: the first 4
               micro-batches' 8,192 requests, one at a time, each future's
               bags equal to phase 4's, every launch from the front end's
               worker, spans on the worker and on the replay's prefetch
               thread.
 14. trace train — phase 6's 24 synthetic batches recorded with
               ``record_trace`` and replayed by ``train_dlrm --trace`` through
               ``scratchpipe --planner device --executor overlapped --fused``
               with phase 6's configuration: the losses and the flushed host
               table (its SHA-256) bitwise equal to phase 6's, every launch on
               the main thread (the replay's prefetch thread launches
               nothing); ms/step beside phase 6's.
 15. multi-table train — ``train_dlrm --tables 8``: ``multi_table_config(8)``,
               the paper's DLRM at full width with heterogeneous tables, cut
               like every DLRM phase (base_rows 10M -> 1M: 8M, 4M, ... 62.5k
               rows, 15,937,500 in all, 8.16 GB of fp32), 24 steps, seed 0,
               the launcher's per-table budgets (1,662,060 slots: the §VI-D
               floor of 6 x 2048 x 20 rows for each of the six large
               tables, the two small ones whole), from copies of one host
               table: host/sync split, fused, ``nocache``, device+overlapped
               fused and fp16 device+overlapped fused. The fp32 runs' losses
               and flushed tables bitwise equal, the four largest tables
               evict (victims tallied per table), ``by_table`` hits + misses
               = ``n_unique`` every step, fp16 within 1e-2 of fp32, launch
               counts as designed, the plain versions raising, every launch
               on the main thread. Then the same batches recorded as a trace
               (tables of different rows) and replayed with ``--trace
               --adaptive-pad`` device+overlapped fused: its bucket set
               printed, losses and table bitwise equal to the runs above.
 16. sharded — ``make_runtime("sharded")`` (one ``ScratchPipe`` per table)
               over phase 15's group, ids and budgets with the counting
               [Train] of the reference's tests (+1.0 per unique touched
               slot, plain torch), host/sync and device+overlapped, from a
               zeroed table; then a single-manager ``ScratchPipe(table_group=,
               slot_budgets=)`` with the same [Train]: each flushed table
               equal to the exact count of each row's batches, one ``fill``
               per shard per cycle with misses and no other launch. Then the
               tables at int8, fp16 and fp32 in turn, on a copy of phase
               15's host table, with a [Train] that changes nothing: every
               loaded row equal to the numpy quantize-then-dequantize of its
               master, the rest unchanged; ``fill_i8``, ``fill_f16`` and
               ``fill`` each launched once per shard of its form per cycle
               with misses.
 17. serving recovery — at phase 4's configuration, on phase 13's host
               table: phase 4's first 12 micro-batches with a
               ``state_arrays`` snapshot taken after 6 (two still queued,
               mid-pipeline) and loaded into a fresh server; the same 12
               under ``ChaosInjector.attach_server`` with one fetch kill
               (retried) and one fetch whose retry fails too (the failsafe):
               bags bitwise equal to phase 4's, ``serve.fetch_failures`` and
               ``serve.failsafe`` equal to the injected events. Then
               ``launch/serve.py --warm-start`` from one save of phase 6's
               fp32 split run (taken after its flush, in a temporary
               directory), 8 micro-batches against a cold start and
               ``nocache-serve`` over the checkpoint's table, all bitwise
               equal; its ``warm start:`` line, the first four hit rates
               and p50 warm and cold. Every launch on the serving thread.
 18. transformers — bf16, batch 4 x 2048, 16 greedy tokens, random weights
               from a seeded ``torch.Generator`` on the card, each config
               built and freed in turn: chatglm3-6b, phi-3-vision-4.2b and
               hubert-xlarge (prefill only: an encoder has no decode) in
               full; qwen2.5-32b, qwen2-72b and mistral-large-123b at full
               width cut to 4 layers. One ``flash_attention`` per layer per
               prefill, none in decode; each at fp32 and 2 layers against
               the plain versions (logits within 1e-3 of the largest, the
               greedy tokens equal); flash timed at each config's operands
               beside its bound, its plain version and SDPA.
 19. mamba2 and moe — bf16, 16 greedy tokens, random weights from a seeded
               ``torch.Generator`` on the card, through ``run_lm``, each
               config built and freed in turn: mamba2-2.7b (attention-free,
               64 layers, ds 128) in full at batch 4 x 2048; mixtral-8x7b
               at full width cut to 8 of 32 layers (the whole model is
               about 93 GB), at 4 x 2048 and at 1 x 8192 (a multiple of its
               4096-key window: the kernel skips the blocks outside it and
               decode runs on a full 4096-slot ring); llama4-scout-17b-a16e
               at full width cut to 4 of 48 layers (the whole model is
               about 200 GB), at 4 x 2048. Exactly one ``ssd_chunk_scan``
               (mamba2: 64) or one ``flash_attention`` (MoE) per layer per
               prefill, none in decode, no other kernel; the SSM states or
               the KV ring of min(prompt + gen, window) slots. Each config
               also at fp32 and 2 layers against the plain versions (logits
               within 1e-3 of the largest, the tokens equal; for MoE the
               (token, choice) routings that differ between the two runs
               counted and printed). Then SSD at mamba2-2.7b's first-layer
               operands (row 8a) and flash at each MoE run's (rows 7g, 7h:
               mixtral causal at 4 x 2048, windowed at 1 x 8192, SDPA with
               the window as an explicit mask) beside their bounds, plain
               versions and library calls.
 20. lm train — LM training through ``repro_torch.launch.train``'s
               ``train_lm`` (bf16 params, AdamW with fp32 masters, remat,
               random weights from a seeded ``torch.Generator``): the main
               path, chatglm3-6b at full width cut to 8 of 28 layers, 4 x
               4096 tokens (global batch 256 -> 4), 12 steps: ms/step (the
               median of steps 3-12), tokens/s, peak GB, loss first -> last,
               a torch.profiler trace of step 11; then mixtral-8x7b at full
               width, 2 of 32 layers, 1 x 8192 (its 4096-key window cuts in
               the backward kernel), 6 steps. Counts are reset just before
               each run and read at every step: exactly 2 x L
               ``flash_attention`` (the forward and its remat recompute) and
               L ``flash_attention_bwd`` a step, no other kernel; the plain
               attention versions raise during the runs; losses and grad
               norms finite, mixtral's aux loss finite and > 0. Then (a) the
               backward kernel against ``ref.flash_attention_bwd_ref`` (one
               kv head at a time) at rows 7a, 7h and 7c's operands, bf16 and
               fp32, and its lse against the plain one; (b) the forward's
               output with lse bitwise equal to the one without; (c)
               chatglm3-6b and mixtral at fp32, full width, 2 layers, 3
               steps through the kernels and through the plain versions on
               the card (TF32 off): losses, step 1's gradients (leaf by
               leaf) and params within the stated limits; (d) a
               ``TrainSupervisor`` drill at chatglm3-6b's smoke config (a
               node failure at the 7th step call, checkpoints every 4
               steps, 12 steps): the final params and AdamW state bitwise
               equal to an uninterrupted run's. Last, at the main path's
               first backward operands (4 x 4096), the forward kernel's o
               and lse held to their plain versions, then
               ``flash_attention_bwd`` timed there and at rows 7a and 7h
               beside its bound, its plain version and SDPA's backward
               (forward + backward less forward), with the GQA split's
               parts and workspace bytes, and each of its passes' own time
               in the traced step with their TFLOP/s.

The traces go to temporary directories removed at exit. The sweep of
phase 3 covers the fp16 and int8 forms too, and for them also D in {256,
1024} (rows of several warp loads), L in {33, 64} (more than one 32-lookup
group), a payload 4 but not 16 bytes aligned, fused calls whose
fills are all sentinels, and ragged fills. The last three lines are the
``kernels`` JSON line (``scatter_add``, ``flash_attention`` — with
phase 18's shapes under ``transformer_shapes`` and phase 19's under
``moe_shapes`` — ``flash_attention_bwd`` — phase 20's shapes and parity
checks — and ``ssd_chunk_scan`` — phase 19's under ``mamba2_shapes`` — carry
their ``details``; ``gather_reduce_q`` and the fp16
gather and fp16/int8 fills their times at phase 13's operands under
``serve``), the nvidia-smi line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
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
CU_SOURCE_FA_BWD = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
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
# and the error relative to the output's size, ||got - want||_F /
# ||want||_F: a bf16 row that averages over thousands of keys is itself
# about 3e-2 in size, so the atol alone would pass a wrong scale or a
# dropped key block there (a correct bf16 kernel reads a few 1e-3)
FLASH_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
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
OBSERVE_TRAIN_RUN = "6b observe: scratchpipe device+overlapped fused"
DRILL_RUN = "8b drill: fp16 device+overlapped fused --chaos"
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
    ``Planner.plan`` raise, save while ``derive_pad_buckets`` (the
    ``--adaptive-pad`` profiling pass) runs, and capture ``plan_step``'s
    operands at the middle step into ``captured`` (when given); time the
    main thread's waits on worker futures. Returns (report, restore):
    report() -> (the off-main-thread launches, the main thread's seconds in
    Future.result); ``report.profiling`` counts the profiling passes
    (``calls``), the numpy plans they made (``plans``) and the passes that
    started after a ``ScratchPipe`` was built (``late``)."""
    import concurrent.futures
    import threading

    off_main, waited = [], [0.0]
    saved = []
    profiling = {"calls": 0, "plans": 0, "late": 0}

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
        import repro_torch.traces as traces
        import repro_torch.traces.profiling as profiling_mod

        real_plan = mods["plan"].Planner.plan
        real_derive = profiling_mod.derive_pad_buckets
        real_init = mods["pipeline"].ScratchPipe.__init__
        state = {"profiling": False, "built": False}

        def derive(*a, **k):
            # --adaptive-pad's offline profiling pass replays the trace
            # through a numpy planner of its own before the run: only it
            # may plan on the host
            profiling["calls"] += 1
            profiling["late"] += state["built"]
            state["profiling"] = True
            try:
                return real_derive(*a, **k)
            finally:
                state["profiling"] = False

        def init(self, *a, **k):
            state["built"] = True
            return real_init(self, *a, **k)

        def no_host_plan(self, *a, **k):
            if state["profiling"]:
                profiling["plans"] += 1
                return real_plan(self, *a, **k)
            raise RuntimeError("the numpy Planner.plan ran on a device-planner path")

        patch(traces, "derive_pad_buckets", derive)
        patch(profiling_mod, "derive_pad_buckets", derive)
        patch(mods["pipeline"].ScratchPipe, "__init__", init)
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

    def report():
        return list(off_main), waited[0]

    report.profiling = profiling
    return report, restore


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


# --------------------------------------------------------------------------- #
# 6b / 8b / 13b: observability and training recovery on the card
# --------------------------------------------------------------------------- #
#: phase 8b's drill: a gather worker's death, a failed write-back, the d2h
#: thread's death (all recovered inline), a NaN loss and five corrupted host
#: rows (each recovered by a checkpoint restore)
DRILL_CHAOS = "kill-gather@3;fail-writeback@5;kill-d2h@7;nan-loss@9;corrupt-row@13:5"
DRILL_ARGV = ["--verify-every", "4", "--ckpt-every", "8"]
POOL_THREADS = ("MainThread", "scratchpipe-host_0", "scratchpipe-d2h_0")


def observed(torch, run, *a, **k):
    """``run(torch, *a, **k)`` with a fresh Tracer and MetricsRegistry
    installed for every runtime it builds; returns (run's result, tracer,
    metrics). The install is cleared on the way out."""
    from repro_torch import obs

    tracer, metrics = obs.Tracer(), obs.MetricsRegistry()
    obs.install(tracer, metrics)
    try:
        return run(torch, *a, **k), tracer, metrics
    finally:
        obs.install(None, None)


def spans_by_thread(tracer) -> dict:
    """{thread: {span: seconds}} from ``Tracer.totals()``."""
    out = {}
    for (thread, span), sec in sorted(tracer.totals().items()):
        out.setdefault(thread, {})[span] = sec
    return out


def check_artifacts(name, tracer, metrics, threads, min_threads=3) -> dict:
    """Export and validate both artifacts (``repro_torch.obs.check``): the
    trace with spans on ``min_threads`` threads, ``threads`` among them.
    Returns the per-thread span seconds."""
    from repro_torch.obs.check import validate_chrome_trace, validate_metrics_jsonl

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        tpath, mpath = os.path.join(tmp, "trace.json"), os.path.join(tmp, "metrics.jsonl")
        n = tracer.export_chrome(tpath)
        metrics.write_jsonl(mpath, provenance={"run": name})
        problems = (validate_chrome_trace(tpath, min_threads=min_threads)
                    + validate_metrics_jsonl(mpath))
    check(not problems, f"{name}: invalid artifacts {problems[:3]}")
    names = set(tracer.thread_names())
    check(set(threads) <= names, f"{name}: no spans on {set(threads) - names}")
    by_thread = spans_by_thread(tracer)
    by_thread["events"] = n
    return by_thread


def check_cache_counters(name, metrics, stats) -> dict:
    """``cache.*`` counters equal the StepStats sums."""
    want = {"cycles": len(stats), "lookups": sum(st.n_lookups for st in stats),
            "unique": sum(st.n_unique for st in stats),
            "hits": sum(st.n_hits for st in stats), "misses": sum(st.n_miss for st in stats),
            "evicts": sum(st.n_evict for st in stats)}
    got = {k: metrics.counter(f"cache.{k}", runtime="scratchpipe").value for k in want}
    check(got == want, f"{name}: cache counters {got} != StepStats sums {want}")
    return got


def observe_summary(name, fast, ms, res, stages, report, by_thread, cells, untraced_ms):
    return {**train_summary(name, fast, ms, res, stages, report),
            "untraced_ms_per_step": untraced_ms, "cache_counters": cells,
            "span_s_by_thread": by_thread}


def train_main_path(torch, mods, dev, seed0, ckpt_dir=None):
    """The five training runs on copies of one host table, the first rows
    of ``seed0`` (``seed0_rows``); returns (summaries, launch counts per
    run, captured operands, the host table, the losses, the flushed table's
    SHA-256). With ``ckpt_dir``, the first run (fp32 split, host planner)
    is saved there once after its flush: phase 17's warm-start
    checkpoint."""
    cfg = mods["DLRMConfig"](rows_per_table=ROWS, cache_fraction=TRAIN_CACHE_FRAC)
    check((cfg.num_tables, cfg.embed_dim, cfg.lookups_per_table) == (TABLES, DIM, LOOKUPS)
          and cfg.bottom_mlp == (512, 256, 128)
          and cfg.top_mlp == (1024, 1024, 512, 256, 1)
          and mods["interaction_dim"](cfg) == 164, "the training config is not full width")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(seed0.shape[0] >= cfg.total_rows and seed0.shape[1] == cfg.embed_dim,
          f"the seed-0 rows {seed0.shape} do not hold the training table")
    base = seed0[:cfg.total_rows]
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
        if ckpt_dir is not None and first_losses is None:
            ckpt = save_training_checkpoint(pipe, ckpt_dir)
            print("checkpoint: " + json.dumps(ckpt), flush=True)
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

    # 6b: the device+overlapped fused run again, traced and metered
    t0 = time.perf_counter()
    name = OBSERVE_TRAIN_RUN
    (res, counts, stages, ms, report), tracer, metrics = observed(
        torch, train_run, mods, cfg, base, name, "scratchpipe", True, True, captured)
    stats, pipe = res["stats"], res["pipe"]
    check_train_counts(name, "scratchpipe", True, stats, counts, stages)
    losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
    check(torch.equal(losses, first_losses), f"{name}: losses differ from the untraced runs")
    pipe.flush_to_host()
    pipe.close()
    check((res["host"].data == first_table).all(),
          f"{name}: the flushed host table differs from the untraced runs'")
    cells = check_cache_counters(name, metrics, stats)
    by_thread = check_artifacts(name, tracer, metrics, POOL_THREADS)
    untraced = next(r["ms_per_step"] for r in summaries
                    if r["run"] == "scratchpipe device+overlapped fused")
    summaries.append(observe_summary(name, True, ms, res, stages, report, by_thread, cells,
                                     untraced))
    print("observe: " + json.dumps(summaries[-1]), flush=True)
    counts_by_run[name] = counts
    log(f"observe: {name}: bitwise equal to the untraced runs, spans on "
        f"{len(by_thread) - 1} threads, {ms:.2f} ms/step against {untraced:.2f} untraced "
        f"({time.perf_counter() - t0:.1f}s)")
    del res, pipe, tracer, metrics
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


def train_run_q(torch, mods, cfg, base_table, name, precision, fused, fast, captured,
                extra_argv=()):
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
        argv + (["--fused"] if fused else []) + (FAST_ARGV if fast else [])
        + list(extra_argv))
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
    summaries += observe_q_phase(torch, mods, cfg, base, split, summaries, counts_by_run,
                                 captured)
    del split
    log("train: per precision, split, fused and device+overlapped fused losses and flushed "
        "host tables bitwise equal; losses within " + ", ".join(f"{p} {t:g}" for p, t in Q_LOSS_RTOL.items())
        + " of fp32")
    return summaries, counts_by_run, captured


def checkpoint_bytes(root: str) -> int:
    """Bytes of the newest checkpoint under ``root``."""
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    newest = os.path.join(root, max(steps, key=lambda d: int(d.split("_")[1])))
    return sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(newest) for f in fs)


def observe_q_phase(torch, mods, cfg, base, split, summaries, counts_by_run, captured):
    """Phase 8b: the fp16 and int8 device+overlapped fused runs traced, each
    bitwise equal to its precision's untraced runs; then the fp16 drill
    (``--chaos DRILL_CHAOS``) and its clean ``--supervise`` twin. Returns
    the new summaries (their launch counts go into ``counts_by_run``)."""
    out = []
    for precision in ("fp16", "int8"):
        t0 = time.perf_counter()
        name = f"8b observe: {precision} device+overlapped fused"
        (res, counts, stages, ms, report), tracer, metrics = observed(
            torch, train_run_q, mods, cfg, base, name, precision, True, True, captured)
        stats, pipe = res["stats"], res["pipe"]
        check_q_counts(name, precision, True, stats, counts, stages)
        losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
        s_losses, s_table = split[precision]
        check(torch.equal(losses, s_losses), f"{name}: losses differ from the untraced runs")
        pipe.flush_to_host()
        pipe.close()
        check((res["host"].data == s_table).all(),
              f"{name}: the flushed host table differs from the untraced runs'")
        cells = check_cache_counters(name, metrics, stats)
        by_thread = check_artifacts(name, tracer, metrics, POOL_THREADS)
        untraced = next(r["ms_per_step"] for r in summaries
                        if r["run"] == f"{precision} device+overlapped fused")
        out.append({**observe_summary(name, True, ms, res, stages, report, by_thread,
                                      cells, untraced), "precision": precision,
                    "evicted_rows": sum(st.n_evict for st in stats)})
        print("observe: " + json.dumps(out[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"observe: {name}: bitwise equal to the untraced runs, {ms:.2f} ms/step "
            f"against {untraced:.2f} ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, tracer, metrics

    s_losses, s_table = split["fp16"]
    events = sorted(DRILL_CHAOS.split(";"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ck:
        digests = {}
        for name, argv in ((DRILL_RUN, ["--chaos", DRILL_CHAOS]),
                           ("8b clean supervised twin", ["--supervise"])):
            t0 = time.perf_counter()
            ckdir = os.path.join(ck, name.split()[1])
            res, counts, stages, ms, report = train_run_q(
                torch, mods, cfg, base, name, "fp16", True, True, captured,
                extra_argv=argv + DRILL_ARGV + ["--ckpt-dir", ckdir])
            wall = time.perf_counter() - t0
            rep, stats, pipe = res["report"], res["stats"], res["pipe"]
            losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
            check(len(stats) == TRAIN_STEPS and torch.equal(losses, s_losses),
                  f"{name}: losses differ from phase 8's unsupervised fp16 runs")
            check((res["host"].data == s_table).all(),
                  f"{name}: the flushed host table differs from phase 8's")
            if name == DRILL_RUN:
                check(sorted(res["chaos_fired"]) == events,
                      f"{name}: fired {res['chaos_fired']}, not every event of {events}")
                check(rep.restarts >= 2 and rep.nan_steps_skipped >= 1,
                      f"{name}: {rep.restarts} restores, {rep.nan_steps_skipped} NaN steps")
                check(counts["fill_gather_reduce_f16"] > 0 and counts["scatter_add"] > 0,
                      f"{name}: launches {counts}")
            else:
                check(rep.restarts == 0, f"{name}: {rep.restarts} restarts")
            digests[name] = res["state_digest"]
            out.append({**train_summary(name, True, ms, res, stages, report),
                        "precision": "fp16", "wall_with_recovery_s": wall,
                        "chaos_fired": res["chaos_fired"], "restarts": rep.restarts,
                        "nan_steps_skipped": rep.nan_steps_skipped,
                        "checkpoints": rep.checkpoints, "save_ms": rep.save_ms,
                        "restore_ms": rep.restore_ms, "restart_causes": rep.causes,
                        "checkpoint_bytes": checkpoint_bytes(ckdir),
                        "state_digest": res["state_digest"], "launches": counts})
            print("recover: " + json.dumps(out[-1]), flush=True)
            counts_by_run[name] = counts
            pipe.close()
            log(f"recover: {name}: {rep.restarts} restores "
                f"({[round(x) for x in rep.restore_ms]} ms), {rep.checkpoints} saves "
                f"({[round(x) for x in rep.save_ms]} ms, "
                f"{out[-1]['checkpoint_bytes'] / 1e9:.2f} GB each), bitwise equal to phase "
                f"8's unsupervised run ({wall:.1f}s)")
            del res, pipe, stats
            shutil.rmtree(ckdir, ignore_errors=True)
        check(len(set(digests.values())) == 1,
              f"state digests differ: {digests}")
    log(f"recover: the drill fired {len(events)} events and its state_digest equals the "
        "clean supervised twin's; every launch on the main thread")
    return out


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


def lm_run(torch, mods, cfg=None, plain=False, argv=LM_ARGV, model="hybrid"):
    """One ``run_lm`` of ``argv`` (``cfg`` overrides the arch's config;
    ``model`` names the family module whose ``decode_step`` runs). With
    ``plain=False`` the plain versions raise during the run and the first
    operands of each kernel are captured; with ``plain=True`` the launchers
    are swapped for the plain versions (run on the card). Returns (result,
    launch counts after the prefill, launch counts at the end, captured
    operands, host ms of each decode step, its token on the host)."""
    ops, ref, fa, ssd = (mods[k] for k in ("ops", "ref", "fa", "ssd"))
    model = mods[model]
    real = {"fa": fa.flash_attention, "ssd": ssd.ssd_chunk_scan,
            "decode": model.decode_step}
    real_refs = {n: getattr(ref, n) for n in LM_PLAIN_VERSIONS}
    captured, at_decode, step_ms = {}, [], []

    def spy_fa(q, k, v, causal, window, q_offset=0):
        captured.setdefault("flash", (q.clone(), k.clone(), v.clone(), causal, window))
        return real["fa"](q, k, v, causal, window, q_offset)

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
        fa.flash_attention = lambda q, k, v, causal, window, q_offset=0: real_refs[
            "flash_attention_ref"](q, k, v, causal=causal, window=window, q_offset=q_offset)
        ssd.ssd_chunk_scan = lambda x, dt, A, Bm, Cm, Q: real_refs[
            "ssd_chunk_scan_ref"](x, dt, A, Bm, Cm, Q)
    else:
        fa.flash_attention, ssd.ssd_chunk_scan = spy_fa, spy_ssd
        for n in LM_PLAIN_VERSIONS:
            setattr(ref, n, no_plain)
    model.decode_step = spy_decode
    try:
        ops.reset_launch_counts()
        res = mods["serve"].run_lm(mods["serve"].build_parser().parse_args(argv),
                                   cfg=cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        fa.flash_attention, ssd.ssd_chunk_scan = real["fa"], real["ssd"]
        model.decode_step = real["decode"]
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
def flash_close(torch, got, want, what):
    """Holds a flash output against its plain version, in max |diff| and in
    the Frobenius norm relative to the plain output's; returns (dtype name,
    max |diff|, relative error)."""
    name = str(want.dtype).split(".")[-1]
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.float())
           .clamp_min(1e-30)).item()
    check(got.dtype == want.dtype and err <= FLASH_ATOL[name] and rel <= FLASH_RTOL[name],
          f"flash_attention differs by {err} (limit {FLASH_ATOL[name]}), relative {rel} "
          f"(limit {FLASH_RTOL[name]}) at {what} {name}")
    return name, err, rel


def lm_flash_check(torch, ops, ref, q, k, v, causal, window):
    """One flash launch against its plain version; returns (dtype, err)."""
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal, window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(ops.launch_counts()["flash_attention"] == before + 1, "flash launch count")
    name, err, _ = flash_close(torch, got, want, f"q {tuple(q.shape)} k {tuple(k.shape)} "
                               f"causal={causal} window={window}")
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


def ssd_work(x, dt, A, Bm, Cm, Q) -> tuple:
    """(operations, bytes) of one SSD call: the chunk products (y_intra,
    C.h, the state update) per head, C.B^T once per head group; each input
    read once, y and the final state written once."""
    B, S, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2  # (i, j) pairs with j <= i in a full chunk
    ops = (B * nh * nc * (2 * tri * hd + 4 * Q * ds * hd)  # y_intra, C.h, state
           + B * ng * nc * 2 * tri * ds)  # C.B^T once per group
    n_bytes = (2 * x.numel() * x.element_size()  # x in, y out
               + 4 * (dt.numel() + A.numel() + Bm.numel() + Cm.numel() + B * nh * hd * ds))
    return ops, n_bytes


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
    s_ops, s_bytes = ssd_work(x, dt, A, Bm, Cm, Q)
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


def trace_serve_phase(torch, mods, tmp: str, phase4_bags, phase4_rows):
    """Phase 13: phase 4's micro-batches recorded as serving traces at
    fp32, fp16 and int8, served through ``launch/serve.py --trace`` on one
    host table: phase 4's launcher's (``phase4_rows``, never written by
    serving). Returns (summaries, launch counts per run, captured kernel
    operands, the host table: phase 17 serves from it too)."""
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
    check(phase4_rows.shape == (group.total_rows, DIM), "phase 4's host table is another shape")
    host = mods["HostEmbeddingTable"](group.total_rows, DIM, data=phase4_rows)
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
    obs13 = observe_serve_phase(torch, mods, host, group, paths["fp32"], phase4_bags,
                                counts_by_run)
    return summaries + [fe, obs13], counts_by_run, captured, host


def check_serve_counters(name, metrics, stats) -> dict:
    """``serve.*`` counters and the latency histogram against the StepStats
    of the run (emergency fills from ``StepStats.aux``)."""
    lbl = {"runtime": "scratchpipe-serve"}
    em = [st.aux["emergency"] for st in stats]
    want = {"requests": len(stats), "lookups": sum(st.n_lookups for st in stats),
            "hits": sum(st.n_hits for st in stats), "misses": sum(st.n_miss for st in stats),
            "emergency_rows": sum(em), "emergency_serves": sum(1 for e in em if e)}
    got = {k: metrics.counter(f"serve.{k}", **lbl).value for k in want}
    got["latency_count"] = metrics.histogram("serve.latency_us", **lbl).count
    want["latency_count"] = len(stats)
    check(got == want, f"{name}: serve counters {got} != {want}")
    return got


def observe_serve_phase(torch, mods, host, group, path, phase4_bags, counts_by_run) -> dict:
    """Phase 13b: the fp32 ``scratchpipe-serve --trace`` replay traced and
    metered (bags bitwise equal to phase 13's, ``serve.*`` counters equal
    the replay's); then the front end over an fp32 ``scratchpipe-serve``
    fed from a ``TraceReplayStream`` of the same trace (its prefetch thread
    decodes): the first FRONTEND_THREADS micro-batches' requests, one at a
    time, each future's bags equal to phase 4's, every launch from the
    front end's worker, spans on the worker and on the prefetch thread."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core.runtime import make_runtime
    from repro_torch.serving import EmbeddingServer
    from repro_torch.traces import TraceReplayStream

    t0 = time.perf_counter()
    ops, gr, serve = mods["ops"], mods["gr"], mods["serve"]
    name = f"13b observe: trace fp32 scratchpipe-serve depth {DEPTH}"
    tracer, m_replay, m_front = obs.Tracer(), obs.MetricsRegistry(), obs.MetricsRegistry()
    obs.install(tracer, m_replay)
    try:
        res, counts, stages = trace_serve_run(
            torch, mods, host, trace_args(path, "scratchpipe-serve", DEPTH, CACHE_FRAC))
    finally:
        obs.install(None, None)
    check_bags(name, res["bags"], phase4_bags)
    check_serve_counts(name, counts, "gather_reduce", STEPS, "fill")
    replay_cells = check_serve_counters(name, m_replay, res["stats"])
    summary = {**serve_summary(name, res, counts, stages), "serve_counters": replay_cells}
    counts_by_run[name] = counts
    del res

    fe_name = "13b observe: front end fp32 scratchpipe-serve from a replay stream"
    backend = make_runtime(
        "scratchpipe-serve", host, None, window=DEPTH, table_group=group, device=DEVICE,
        num_slots=serve.scratchpad_slots(group, BATCH, LOOKUPS, DEPTH, CACHE_FRAC),
        tracer=tracer, metrics=m_front)
    threads, restore_threads = launch_threads(gr)
    restore_plain = plain_versions_raise(mods["ref"])
    results = []
    try:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        stream = TraceReplayStream(path, stop=FRONTEND_THREADS, tracer=tracer)
        with EmbeddingServer(backend, max_batch=BATCH) as fe:
            for gids, _payload in stream:
                results.append([fe.lookup(r) for r in gids])
            results = [np.stack([f.result(timeout=600) for f in fs]) for fs in results]
            worker = fe._thread.ident
        stream.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        fe_counts = ops.launch_counts()
    finally:
        restore_plain()
        restore_threads()
    check(len(results) == FRONTEND_THREADS, f"{fe_name}: {len(results)} micro-batches")
    for b, got in enumerate(results):
        check(got.shape == (BATCH, TABLES, DIM) and (got == phase4_bags[b]).all(),
              f"{fe_name}: bags of micro-batch {b}'s requests differ from phase 4's")
    check(threads == {worker}, f"{fe_name}: kernels launched from {threads}, not the worker")
    check_serve_counts(fe_name, fe_counts, "gather_reduce", len(backend.stats), "fill")
    fe_cells = check_serve_counters(fe_name, m_front, backend.stats)
    by_thread = check_artifacts(name, tracer, m_front,
                                ("MainThread", "serving-frontend", "trace-prefetch"))
    check({"frontend.form", "frontend.complete", "serve"} <= set(by_thread["serving-frontend"])
          and "trace.decode" in by_thread["trace-prefetch"],
          f"{fe_name}: spans {by_thread}")
    counts_by_run[fe_name] = fe_counts
    n = FRONTEND_THREADS * BATCH
    summary["front_end"] = {"run": fe_name, "requests": n, "cycles": len(backend.stats),
                            "wall_s": wall, "requests_per_s": n / wall,
                            "serve_counters": fe_cells,
                            "launches": {k: v for k, v in fe_counts.items() if v}}
    summary["span_s_by_thread"] = by_thread
    print("observe: " + json.dumps(summary), flush=True)
    log(f"observe: {name} and the front end from a replay stream: bags bitwise equal, "
        f"serve counters equal the StepStats, spans on {len(by_thread) - 1} threads "
        f"({time.perf_counter() - t0:.1f}s)")
    return summary


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


# --------------------------------------------------------------------------- #
# 15. multi-table train: the heterogeneous 8-table DLRM, per-table budgets
# --------------------------------------------------------------------------- #
#: (name, runtime, fused, fast, precision) of phase 15's runs
MT_RUNS = (("multi-table split", "scratchpipe", False, False, "fp32"),
           ("multi-table fused", "scratchpipe", True, False, "fp32"),
           ("multi-table nocache", "nocache", False, False, "fp32"),
           ("multi-table device+overlapped fused", "scratchpipe", True, True, "fp32"),
           ("multi-table fp16 device+overlapped fused", "scratchpipe", True, True, "fp16"))
#: the tables that must evict at fp32 (8M, 4M, 2M and 1M rows)
MT_EVICTING = 4


def multi_table_group():
    """Phase 15's configuration, ``multi_table_config(8)`` at full width with
    the one cut of every DLRM phase (base_rows 10M -> 1M), and its group."""
    from repro_torch.configs.dlrm_scratchpipe import multi_table_config
    from repro_torch.core.table_group import TableGroup

    cfg = multi_table_config(TABLES, base_rows=ROWS)
    return cfg, TableGroup.from_config(cfg)


def seed0_rows(mods):
    """The seed-0 host table of phase 15's 15,937,500 rows, built once: its
    first 8M rows are phases 6-8 and 14's table (one numpy stream, so they
    are the rows a seed-0 table of 8M rows holds)."""
    t0 = time.perf_counter()
    rows = mods["HostEmbeddingTable"](multi_table_group()[1].total_rows, DIM, seed=0).data
    log(f"host table {rows.shape} fp32 ({rows.nbytes / 1e9:.2f} GB) built in "
        f"{time.perf_counter() - t0:.1f}s: phase 15's, and phases 6-8 and 14's first rows")
    return rows


def multi_table_setup(mods):
    """Phase 15's configuration (``multi_table_group``), the launcher's slot
    count and per-table budgets (the §VI-D floor of 6 x 2048 x 20 lookups
    per table), and the 24 batches of ``dlrm_batches_group``."""
    from repro_torch.data.synthetic import dlrm_batches_group

    cfg, group = multi_table_group()
    check(group.rows == (8_000_000, 4_000_000, 2_000_000, 1_000_000, 500_000, 250_000,
                         125_000, 62_500)
          and (cfg.embed_dim, cfg.lookups_per_table, cfg.batch_size) == (DIM, LOOKUPS, BATCH)
          and cfg.bottom_mlp == (512, 256, 128)
          and cfg.top_mlp == (1024, 1024, 512, 256, 1),
          "the multi-table config is not the paper's DLRM at full width")
    floor = group.window_floor(BATCH * LOOKUPS)
    slots = max(2048, int(group.total_rows * cfg.cache_fraction),
                sum(min(floor, r) for r in group.rows))
    budgets = group.precision_slot_budgets(slots, min_per_table=floor)
    check(slots == 1_662_060 and budgets == [floor] * 6 + [125_000, 62_500],
          f"the launcher's slot math moved: {slots} {budgets}")
    batches = [ids for ids, _ in dlrm_batches_group(
        group, TRAIN_STEPS, batch_size=BATCH, lookups_per_table=LOOKUPS,
        locality="medium", seed=0)]
    return cfg, group, slots, budgets, batches


def evictions_by_table(pipeline):
    """Keep each cycle's victim slots (a spy on ``ScratchPipe._stage_collect``
    that only holds a reference, so no work of its own lands in the timed
    stages). Returns (tally, restore): tally(), after the run, counts the
    victims by the table whose slot range holds them."""
    import numpy as np

    cls, kept = pipeline.ScratchPipe, []
    real = cls._stage_collect

    def spy(self, entry):
        out = real(self, entry)
        kept.append((self.planner.slot_ranges, entry.plan.evict_slots))
        return out

    def tally():
        out = {}
        for ranges, ev in kept:
            if ev.size:
                bounds = [hi for _, hi in ranges]
                per = np.bincount(np.searchsorted(bounds, ev, side="right"),
                                  minlength=len(bounds))
                for t, n in enumerate(per.tolist()):
                    out[t] = out.get(t, 0) + n
        return out

    cls._stage_collect = spy

    def restore():
        cls._stage_collect = real
    return tally, restore


def multi_table_phase(torch, mods, tmp: str, dev, base):
    """Phase 15: ``train_dlrm --tables 8`` through host/sync split and fused,
    ``nocache``, device+overlapped fused and fp16 device+overlapped fused,
    each from a copy of one host table (``base``, ``seed0_rows``); then
    the same batches recorded as a trace and replayed with ``--trace
    --adaptive-pad``. Returns (summaries, {run: launch counts}, the setup,
    the host table, run 1's losses)."""
    from repro_torch.data.synthetic import dlrm_batches_group
    from repro_torch.traces import record_trace

    cfg, group, slots, budgets, batches = multi_table_setup(mods)
    check(base.shape == (group.total_rows, DIM), f"the host table {base.shape} is not phase 15's")
    log(f"multi-table: host table {base.shape} fp32; {slots:,} slots, budgets {budgets}")
    summaries, counts_by_run = [], {}
    first_losses = first_table = fast_losses = None

    def one_run(name, runtime, fused, fast, precision, extra):
        tally, untally = evictions_by_table(mods["pipeline"])
        try:
            if precision == "fp32":
                out = train_run(torch, mods, cfg, base, name, runtime, fused, fast, {},
                                extra_argv=extra)
            else:
                out = train_run_q(torch, mods, cfg, base, name, precision, fused, fast, {},
                                  extra_argv=extra)
        finally:
            untally()
        return out, tally()

    runs = [(r, ["--tables", str(TABLES)]) for r in MT_RUNS]
    path = os.path.join(tmp, "multi_table")
    runs.append((("multi-table --trace --adaptive-pad device+overlapped fused", "scratchpipe",
                  True, True, "fp32"), ["--trace", path, "--adaptive-pad"]))
    for (name, runtime, fused, fast, precision), extra in runs:
        t0 = time.perf_counter()
        if "--trace" in extra:  # the same batches, payloads included
            n = record_trace(path, group, dlrm_batches_group(
                group, TRAIN_STEPS, batch_size=BATCH, lookups_per_table=LOOKUPS,
                locality="medium", seed=0), provenance={
                    "generator": "synthetic", "locality": "medium", "seed": 0})
            check(n == TRAIN_STEPS, f"recorded {n} batches, not {TRAIN_STEPS}")
        (res, counts, stages, ms, report), tally = one_run(name, runtime, fused, fast,
                                                           precision, extra)
        stats, pipe = res["stats"], res["pipe"]
        check(pipe.device.type == dev.type, f"{name}: the runtime is not on the card")
        if runtime == "scratchpipe":
            mult = Q_MULT.get(precision, 1)
            check(pipe.table_group is not None and pipe.num_slots == slots * mult
                  and pipe.planner.slot_ranges == group.slot_ranges(
                      [b * mult for b in budgets]),
                  f"{name}: not the launcher's per-table budgets")
            for st in stats:
                bt = st.by_table
                check(bt is not None and sum(int(x) for x in bt["hits"])
                      + sum(int(x) for x in bt["misses"]) == st.n_unique,
                      f"{name}: by_table hits + misses != n_unique at step {st.step}")
        if fast:
            check(isinstance(pipe.planner, mods["plan_device"].DevicePlanner)
                  and pipe.executor == "overlapped",
                  f"{name}: not the device planner with the overlapped executor")
            # the numpy planner ran only inside --adaptive-pad's profiling
            # pass, once per profiled batch, before the runtime was built
            prof = report.profiling
            want = ({"calls": 1, "plans": min(TRAIN_STEPS, 512), "late": 0}
                    if "--adaptive-pad" in extra else {"calls": 0, "plans": 0, "late": 0})
            check(prof == want, f"{name}: the profiling pass ran as {prof}, not {want}")
        if precision == "fp32":
            check_train_counts(name, runtime, fused, stats, counts, stages)
        else:
            check_q_counts(name, precision, fused, stats, counts, stages)
        losses = torch.stack([st.aux["loss"] for st in stats]).cpu()
        check(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
        pipe.flush_to_host()
        if runtime == "scratchpipe":
            pipe.close()
        table = res["host"].data
        extra_fields = {}
        if precision != "fp32":
            rel = ((losses - first_losses).abs() / first_losses.abs()).max().item()
            check(rel <= Q_LOSS_RTOL[precision],
                  f"{name}: loss {rel:.3g} relative from fp32 > {Q_LOSS_RTOL[precision]}")
            extra_fields["max_rel_loss_vs_fp32"] = rel
        elif first_losses is None:
            first_losses, first_table = losses, table
            evicting = [tally.get(t, 0) for t in range(MT_EVICTING)]
            check(min(evicting) > 0, f"{name}: the large tables evicted {evicting}")
        else:
            want = fast_losses if "--trace" in extra else first_losses
            check(torch.equal(losses, want),
                  f"{name}: losses differ at steps "
                  f"{torch.nonzero(losses != want).flatten().tolist()}")
            check((first_table == table).all(),
                  f"{name}: flushed host table differs from {MT_RUNS[0][0]}")
            if fast:
                fast_losses = losses
        if "--trace" in extra:
            check(bool(pipe.pad_buckets), f"{name}: no adaptive pad buckets")
            extra_fields["pad_buckets"] = list(pipe.pad_buckets)
        tr = pipe.traffic()
        summaries.append({
            **train_summary(name, fast, ms, res, stages, report),
            "precision": precision, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]),
            "evicted_by_table": [tally.get(t, 0) for t in range(group.num_tables)],
            "evicted_rows": sum(st.n_evict for st in stats) if runtime == "scratchpipe" else 0,
            "traffic_MB": {k: tr[k].total / 1e6 for k in ("host", "pcie", "hbm")},
            "launches": counts, **extra_fields,
        })
        print("train: " + json.dumps(summaries[-1]), flush=True)
        counts_by_run[name] = counts
        log(f"multi-table: {name} done ({time.perf_counter() - t0:.1f}s)")
        del res, pipe, table
    log("multi-table: the fp32 runs' losses and flushed host tables bitwise equal (the "
        "--adaptive-pad replay to device+overlapped fused), the large tables evict, fp16 "
        f"within {Q_LOSS_RTOL['fp16']:g}; every kernel launched on the main thread")
    del first_table
    return summaries, counts_by_run, (cfg, group, slots, budgets, batches), base


# --------------------------------------------------------------------------- #
# 16. sharded: one ScratchPipe manager per table (paper §VI-G)
# --------------------------------------------------------------------------- #
MIXED = ("int8", "fp16", "fp32")  # table t's replica precision: MIXED[t % 3]


def count_rows_train(torch):
    """The reference tests' counting [Train] (plain torch on the card, test
    scaffolding, not a kernel port): +1.0 on each unique touched slot. Returns
    (the sharded form, the single-manager form)."""
    def bump(storage, slots):
        s = slots if isinstance(slots, torch.Tensor) else torch.from_numpy(slots)
        s = s.to(storage.device).reshape(-1).long()
        if s.numel():
            storage[torch.unique(s)] += 1.0

    def sharded(storages, slots_all, batch):
        for storage, slots in zip(storages, slots_all):
            bump(storage, slots)
        return storages, None

    def single(storage, slots, batch):
        bump(storage, slots)
        return storage, None

    return sharded, single


def sharded_run(torch, mods, name, host, train_fn, batches, fast=False, single=False,
                **kw):
    """One ``sharded`` run (``single``: a single-manager ``scratchpipe``; with
    ``fast`` on the device planner and the overlapped executor) over
    ``batches``, the plain versions raising and every launch held to the
    main thread. Returns (runtime, launch counts, seconds)."""
    from repro_torch.core.runtime import make_runtime
    from repro_torch.data.lookahead import LookaheadStream

    ops = mods["ops"]
    report, unguard = run_guards(mods, fast)
    restore_plain = plain_versions_raise(mods["ref"])
    t0 = time.perf_counter()
    try:
        ops.reset_launch_counts()
        rt = make_runtime("scratchpipe" if single else "sharded", host, train_fn,
                          device=DEVICE, planner="device" if fast else "host",
                          executor="overlapped" if fast else "sync", **kw)
        stream = LookaheadStream(iter([(ids, {}) for ids in batches]))
        stats = rt.run(stream, lookahead_fn=stream.peek_ids)
        rt.flush_to_host()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        rt.close()
    finally:
        restore_plain()
        unguard()
    off_main, _ = report()
    check(not off_main, f"{name}: kernel launches off the main thread: {off_main[:5]}")
    check(len(stats) == TRAIN_STEPS, f"{name}: {len(stats)} steps")
    return rt, counts, time.perf_counter() - t0


def fills_by_form(rt):
    """Per fill form, the cycles with misses summed over the run's managers."""
    form = {"fp32": "fill", "fp16": "fill_f16", "int8": "fill_i8"}
    out = {}
    for p in getattr(rt, "pipes", [rt]):
        k = form[p.precision]
        out[k] = out.get(k, 0) + sum(1 for st in p.stats if st.n_miss > 0)
    return out


def sharded_phase(torch, mods, setup, base):
    """Phase 16: ``make_runtime("sharded")`` over phase 15's group, budgets and
    ids. fp32 with the counting [Train], host/sync and device+overlapped,
    from a zeroed table: the flushed table equals the exact count of each
    row's batches, as does a single-manager ``ScratchPipe(table_group=,
    slot_budgets=)`` run; ``fill`` once per shard per cycle with misses, no
    other kernel. Then the group at int8/fp16/fp32 in turn on a copy of
    ``base`` with a [Train] that changes nothing: each loaded row comes back
    as the numpy quantize-then-dequantize of its master, the others as they
    were; ``fill_i8``, ``fill_f16`` and ``fill`` each launched. Returns
    (summary, {run: launch counts})."""
    import numpy as np

    from repro_torch.core.table_group import TableGroup, TableSpec

    cfg, group, slots, budgets, batches = setup
    qz = mods["qz"]
    t0 = time.perf_counter()
    counts_want = np.zeros(group.total_rows, np.float32)
    for ids in batches:
        counts_want[np.unique(ids)] += 1.0
    log(f"sharded: exact counts of {int((counts_want > 0).sum()):,} rows "
        f"({time.perf_counter() - t0:.1f}s)")
    sharded_train, single_train = count_rows_train(torch)
    summary, counts_by_run = {}, {}
    for name, fast, single in (("sharded host/sync", False, False),
                               ("sharded device+overlapped", True, False),
                               ("single manager host/sync", False, True)):
        host = mods["HostEmbeddingTable"](group.total_rows, DIM,
                                          data=np.zeros((group.total_rows, DIM), np.float32))
        rt, counts, secs = sharded_run(torch, mods, name, host,
                                       single_train if single else sharded_train, batches,
                                       fast, single, num_slots=slots, table_group=group,
                                       slot_budgets=budgets)
        check(bool((host.data == counts_want[:, None]).all()),
              f"{name}: the flushed table is not the exact row counts")
        want = fills_by_form(rt)
        check(counts["fill"] == want["fill"] > 0
              and sum(counts.values()) == counts["fill"],
              f"{name}: launches {counts}, cycles with misses {want}")
        if not single:
            check(rt.num_shards == group.num_tables
                  and [p.num_slots for p in rt.pipes] == budgets,
                  f"{name}: not one manager per table with the launcher's budgets")
        evicted = sum(st.n_evict for p in getattr(rt, "pipes", [rt]) for st in p.stats)
        summary[name] = {"s": secs, "launches": {k: v for k, v in counts.items() if v},
                         "evicted_rows": evicted}
        counts_by_run[name] = counts
        log(f"sharded: {name} equals the exact counts; {counts['fill']} fills, "
            f"{evicted:,} rows evicted ({secs:.1f}s)")
        del host, rt
    mixed = TableGroup([TableSpec(t.name, t.rows, t.dim, precision=MIXED[i % 3])
                        for i, t in enumerate(group.tables)])
    host = mods["HostEmbeddingTable"](group.total_rows, DIM, data=base.copy())
    name = "sharded mixed int8/fp16/fp32"
    rt, counts, secs = sharded_run(torch, mods, name, host, lambda s, sl, b: (s, None),
                                   batches, fast=True, num_slots=slots, table_group=mixed,
                                   slot_budgets=budgets)
    check(rt.precisions == tuple(MIXED[i % 3] for i in range(group.num_tables))
          and [p.num_slots for p in rt.pipes]
          == [b * Q_MULT.get(p, 1) for b, p in zip(budgets, rt.precisions)],
          f"{name}: the managers' forms or budgets are off")
    want = fills_by_form(rt)
    check(all(counts[k] == v > 0 for k, v in want.items()) and len(want) == 3
          and sum(counts.values()) == sum(want.values()),
          f"{name}: launches {counts}, cycles with misses {want}")
    loaded = counts_want > 0
    for t, prec in enumerate(rt.precisions):
        sl = group.row_slice(t)
        got, master, hit = host.data[sl], base[sl], loaded[sl]
        oracle = qz.dequantize_rows_np(qz.quantize_rows_np(master[hit], prec), prec)
        check(np.array_equal(got[hit], oracle),
              f"{name}: table {t} ({prec}): loaded rows are not the quantize/dequantize "
              "of their masters")
        check(np.array_equal(got[~hit], master[~hit]),
              f"{name}: table {t} ({prec}): rows never loaded changed")
    evicted = [sum(st.n_evict for st in p.stats) for p in rt.pipes]
    summary[name] = {"s": secs, "launches": {k: v for k, v in counts.items() if v},
                     "evicted_by_table": evicted,
                     "precisions": list(rt.precisions)}
    counts_by_run[name] = counts
    log(f"sharded: {name}: every loaded row its quantize/dequantize, the rest unchanged; "
        f"fills {want}, evicted {evicted} ({secs:.1f}s)")
    del host, rt
    print("sharded: " + json.dumps(summary), flush=True)
    return summary, counts_by_run


# --------------------------------------------------------------------------- #
# 17. serving recovery
# --------------------------------------------------------------------------- #
#: phase 17's (a) and (c) serve phase 4's first RECOVERY_SERVES micro-batches;
#: the mid-queue snapshot is taken after RECOVERY_SPLIT are admitted
RECOVERY_SERVES, RECOVERY_SPLIT = 12, 6
#: one kill (retried: fetch_retries=1), then two failures in a row of one
#: fetch, its retry included (exhausted: the entry goes to the failsafe)
RECOVERY_CHAOS = "kill-fetch@3;fail-fetch@6;fail-fetch@7"
RECOVERY_FAULTS, RECOVERY_FAILSAFES = 3, 1
WARM_SERVES = 8  # micro-batches served warm, cold and by nocache-serve


def save_training_checkpoint(pipe, root: str) -> dict:
    """Phase 17's warm-start source: one blocking save of phase 6's fp32
    split run after its flush (so every resident scratchpad row equals its
    host row in the checkpoint)."""
    from repro_torch.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    # not durable: the directory is temporary (no fsync of its 6 GB)
    CheckpointManager(root, keep=1, durable=False).save(
        TRAIN_STEPS, {}, host_arrays=pipe.state_arrays(), blocking=True)
    return {"run": TRAIN_RUNS[0][0], "dir_bytes": checkpoint_bytes(root),
            "save_ms": (time.perf_counter() - t0) * 1e3, "step": TRAIN_STEPS}


def serve_all(srv, batches, drain: bool = True) -> list:
    """Serve ``batches`` at the server's queue depth, then (``drain``) the
    rest of the queue; returns (bags, stats, host ms of the serve) per
    micro-batch (the bags come back to the host, which synchronizes).
    Without ``drain`` the last ``queue_depth`` stay queued, mid-pipeline."""
    out = []

    def one():
        t0 = time.perf_counter()
        bags, st, _ = srv.serve_next()
        out.append((bags, st, (time.perf_counter() - t0) * 1e3))

    for ids in batches:
        srv.enqueue(ids)
        if srv.pending > srv.queue_depth:
            one()
    while drain and srv.pending:
        one()
    return out


def recovery_phase(torch, mods, phase4_bags, ckpt_dir: str, host):
    """Phase 17 at phase 4's configuration, on ``host`` (the launcher's
    table of seed 1, phase 13's): a mid-queue snapshot restored into a
    fresh server; fetch faults, one retried and one into the failsafe; then
    ``launch/serve.py --warm-start`` from phase 6's checkpoint against a
    cold start and ``nocache-serve`` over the checkpoint's table (which the
    warm start loads into ``host``). Returns (summary, launch counts per
    run)."""
    import contextlib
    import io
    import threading

    from repro_torch.chaos import ChaosInjector, ChaosPlan
    from repro_torch.core.table_group import TableGroup
    from repro_torch.obs import MetricsRegistry
    from repro_torch.traces import scenario_batches

    ops, sc, serve = mods["ops"], mods["serving_cache"], mods["serve"]
    group = TableGroup.uniform(TABLES, ROWS, DIM)
    slots = serve.scratchpad_slots(group, BATCH, LOOKUPS, DEPTH, CACHE_FRAC)
    batches = [g for g, _ in scenario_batches("inference_mix", group, STEPS,
                                              batch_size=BATCH, lookups_per_table=LOOKUPS,
                                              seed=0)][:RECOVERY_SERVES]  # phase 4's first
    want = phase4_bags[:RECOVERY_SERVES]

    def server(**kw):
        return sc.ReadOnlyCacheServer(host, slots, window=DEPTH, table_group=group,
                                      device=DEVICE, **kw)

    def bags_equal(name, got, oracle):
        check(len(got) == len(oracle), f"{name}: served {len(got)} of {len(oracle)}")
        for i, (a, b) in enumerate(zip(got, oracle)):
            check(a.shape == (BATCH, TABLES, DIM) and (a == b).all(),
                  f"{name}: bags of serve {i} differ from the oracle's")

    def launcher(extra, design="scratchpipe-serve"):
        args = serve.build_parser().parse_args(
            serve_args(design) + ["--steps", str(WARM_SERVES)] + extra)
        out = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(out):
            res = serve.run_embedding(args, collect_bags=True, host=host)
        torch.cuda.synchronize()
        return res, out.getvalue(), ops.launch_counts()

    summary, counts_by_run = {"scratchpad_slots": slots}, {}
    threads, restore_threads = launch_threads(mods["gr"])
    restore_plain = plain_versions_raise(mods["ref"])
    stages, _, restore_timers = stage_timers(
        [(serve, "warm_start", "read the checkpoint + preload"),
         (sc.ReadOnlyCacheServer, "warm_start_from_arrays", "preload")])
    try:
        # (a) mid-queue snapshot -> a fresh server
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        b = server()
        head = [bags for bags, _, _ in serve_all(b, batches[:RECOVERY_SPLIT], drain=False)]
        t1 = time.perf_counter()
        snap = b.state_arrays()
        snap_ms = (time.perf_counter() - t1) * 1e3
        queued = sorted({e.stage for e in b._queue})
        check("queue" in snap and b.pending == DEPTH,
              f"recovery: the snapshot is not mid-queue (stages {queued})")
        del b
        torch.cuda.empty_cache()
        c = server()
        t1 = time.perf_counter()
        c.load_state_arrays(snap)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t1) * 1e3
        del snap
        tail = [bags for bags, _, _ in serve_all(c, batches[RECOVERY_SPLIT:])]
        torch.cuda.synchronize()
        counts_by_run["recovery mid-queue"] = counts = ops.launch_counts()
        bags_equal("recovery mid-queue", head + tail, want)
        check_serve_counts("recovery mid-queue", counts, "gather_reduce", RECOVERY_SERVES,
                           "fill")
        del c, head, tail
        torch.cuda.empty_cache()
        summary["midqueue"] = {"served": RECOVERY_SERVES, "snapshot_after": RECOVERY_SPLIT,
                               "queued_at_snapshot": DEPTH, "queued_stages": queued,
                               "state_arrays_ms": snap_ms, "load_state_arrays_ms": load_ms,
                               "wall_s": time.perf_counter() - t0}
        log(f"recovery: mid-queue snapshot (stages {queued}) restored into a fresh server, "
            f"{RECOVERY_SERVES} bags bitwise equal to phase 4's "
            f"({time.perf_counter() - t0:.1f}s)")

        # (c) fetch faults: one retried, one exhausted into the failsafe
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        f = server(fetch_retries=1, metrics=MetricsRegistry())
        inj = ChaosInjector(ChaosPlan.parse(RECOVERY_CHAOS), seed=0).attach_server(f)
        got = serve_all(f, batches)
        torch.cuda.synchronize()
        counts_by_run["recovery failsafe"] = counts = ops.launch_counts()
        bags_equal("recovery failsafe", [g for g, _, _ in got], want)
        check_serve_counts("recovery failsafe", counts, "gather_reduce", RECOVERY_SERVES,
                           "fill")
        fails, safes = (f._mc[k].value for k in ("fetch_failures", "failsafe"))
        check(len(inj.fired) == RECOVERY_FAULTS and fails == RECOVERY_FAULTS
              and safes == RECOVERY_FAILSAFES,
              f"recovery failsafe: fired {len(inj.fired)}, fetch_failures {fails}, "
              f"failsafe {safes}")
        emergency = [st.aux["emergency"] for _, st, _ in got]
        check(sum(emergency[DEPTH:]) > 0, "recovery failsafe: the failsafe filled nothing")
        summary["failsafe"] = {"chaos": RECOVERY_CHAOS, "fetch_failures": fails,
                               "failsafe": safes, "emergency_rows_by_serve": emergency,
                               "ms_by_serve": [ms for _, _, ms in got],
                               "wall_s": time.perf_counter() - t0}
        del f, got
        torch.cuda.empty_cache()
        log(f"recovery: {fails} fetch faults, {safes} to the failsafe; {RECOVERY_SERVES} bags "
            f"bitwise equal to phase 4's ({time.perf_counter() - t0:.1f}s)")

        # (b) the launcher's --warm-start from phase 6's checkpoint, then a
        # cold start and nocache-serve over the checkpoint's table
        t0 = time.perf_counter()
        warm, out, counts_by_run["recovery warm start"] = launcher(["--warm-start", ckpt_dir])
        line = next((ln for ln in out.splitlines() if ln.startswith("warm start:")), "")
        n = int(line.split()[2]) if line else 0
        check(n > 0 and line == f"warm start: {n} rows preloaded from {ckpt_dir} "
              f"(training step {TRAIN_STEPS})", f"--warm-start printed {line!r}")
        check_serve_counts("recovery warm start", counts_by_run["recovery warm start"],
                           "gather_reduce", WARM_SERVES, "fill")
        print(line, flush=True)
        cold, _, counts_by_run["recovery cold start"] = launcher([])
        oracle, _, counts_by_run["recovery nocache"] = launcher([], "nocache-serve")
        for name, run in (("recovery warm start", warm), ("recovery cold start", cold)):
            bags_equal(name, run["bags"], oracle["bags"])

        def head4(run):
            return {"hit_rate": [st.n_hits / st.n_unique for st in run["stats"][:4]],
                    "ms": [x * 1e3 for x in run["latencies_s"][:4]],
                    "p50_ms": statistics.median(run["latencies_s"][:4]) * 1e3}

        summary["warm_start"] = {
            "line": line, "rows_preloaded": n, "stages_s": stages,
            "warm": head4(warm), "cold": head4(cold), "wall_s": time.perf_counter() - t0}
        log(f"recovery: {line}; first four hit rates warm "
            f"{summary['warm_start']['warm']['hit_rate']} cold "
            f"{summary['warm_start']['cold']['hit_rate']}; bags bitwise equal to "
            f"nocache-serve over the checkpoint's table ({time.perf_counter() - t0:.1f}s)")
        del warm, cold, oracle
    finally:
        restore_timers()
        restore_plain()
        restore_threads()
    check(threads == {threading.get_ident()},
          f"recovery: kernels launched from {len(threads)} threads, not the serving one")
    return summary, counts_by_run


# --------------------------------------------------------------------------- #
# 18. the dense, encoder and vlm transformers; 19. mamba2 and the MoE family
# --------------------------------------------------------------------------- #
#: phase 18's (arch, layers kept, batch, prompt): None runs the config in
#: full; the three wider dense configs keep their full width at 4 layers
#: (full depth is about 65, 144 and 246 GB of bf16 weights, over the card's
#: 80 GB)
TRANSFORMERS = (("chatglm3-6b", None, LM_BATCH, LM_PROMPT),
                ("phi-3-vision-4.2b", None, LM_BATCH, LM_PROMPT),
                ("hubert-xlarge", None, LM_BATCH, LM_PROMPT),
                ("qwen2.5-32b", 4, LM_BATCH, LM_PROMPT), ("qwen2-72b", 4, LM_BATCH, LM_PROMPT),
                ("mistral-large-123b", 4, LM_BATCH, LM_PROMPT))
#: phase 19's: mamba2-2.7b in full; the MoE configs at full width,
#: mixtral-8x7b at 8 of 32 layers (about 23.8 GB of bf16 with embed and
#: head; the whole model is about 93 GB), at 4 x 2048 and at 1 x 8192 (a
#: multiple of its 4096-key window: the kernel skips the blocks outside it
#: and decode runs on a full ring); llama4-scout at 4 of 48 layers (about
#: 21 GB; the whole ~200 GB)
FAMILY_RUNS = (("mamba2-2.7b", None, LM_BATCH, LM_PROMPT),
               ("mixtral-8x7b", 8, LM_BATCH, LM_PROMPT), ("mixtral-8x7b", 8, 1, 8192),
               ("llama4-scout-17b-a16e", 4, LM_BATCH, LM_PROMPT))
FP32_LAYERS = 2


def encoder_run(torch, mods, cfg, batch, prompt, plain=False):
    """The encoder's prefill forward (the launcher has no encoder decode):
    params from ``torch.Generator(device="cuda")`` seeded 0, the
    reference's synthetic frames, through ``models/api.py``. ``plain`` as
    in lm_run. Returns (result, counts, captured)."""
    api, ops, ref, fa = mods["api"], mods["ops"], mods["ref"], mods["fa"]
    real, real_ref = fa.flash_attention, ref.flash_attention_ref
    captured = {}

    def spy_fa(q, k, v, causal, window, q_offset=0):
        captured.setdefault("flash", (q.clone(), k.clone(), v.clone(), causal, window))
        return real(q, k, v, causal, window, q_offset)

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    if plain:
        fa.flash_attention = lambda q, k, v, causal, window, q_offset=0: real_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset)
    else:
        fa.flash_attention, ref.flash_attention_ref = spy_fa, no_plain
    try:
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = api.init(cfg, gen, device=DEVICE)
        inputs = api.synth_batch(cfg, mods["ShapeSpec"]("serve", prompt, batch, "prefill"),
                                 seed=0, device=DEVICE)
        ops.reset_launch_counts()
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = api.make_prefill_fn(cfg)(params, inputs)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        fa.flash_attention, ref.flash_attention_ref = real, real_ref
    return ({"cfg": cfg, "params": params, "batch": inputs, "logits": logits, "cache": cache,
             "tokens": None, "prefill_s": prefill_s}, counts, captured)


def serve_run(torch, mods, arch, cfg, batch, prompt, plain=False):
    """One config's serving run through ``run_lm`` (an encoder's prefill
    through encoder_run): (result, launches after the prefill, launches at
    the end, captured operands, decode step ms)."""
    if cfg.family == "encoder":
        res, counts, captured = encoder_run(torch, mods, cfg, batch, prompt, plain)
        return res, counts, counts, captured, []
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
            "--gen", str(LM_GEN), "--seed", "0", "--device", DEVICE]
    return lm_run(torch, mods, cfg=cfg, plain=plain, argv=argv,
                  model="ssm_lm" if cfg.family == "ssm" else "transformer")


def warm_prefill_ms(torch, mods, res, batch_size, prompt) -> list:
    api, cfg = mods["api"], res["cfg"]
    batch = res.get("batch") or api.synth_batch(
        cfg, mods["ShapeSpec"]("serve", prompt, batch_size, "prefill"), seed=0,
        device=DEVICE)
    prefill, walls = api.make_prefill_fn(cfg), []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(res["params"], batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def check_serve(torch, res, cfg, batch, prompt, after_prefill, counts, what):
    """One kernel launch per layer per prefill (the SSD scan for the ssm
    family, flash for the others), none in decode, no other kernel; finite
    logits, tokens in the vocab; the SSM states, or the KV cache of
    min(prompt + gen, window) slots (the prompt's for an encoder)."""
    L = cfg.num_layers
    kernel = "ssd_chunk_scan" if cfg.family == "ssm" else "flash_attention"
    want = {"ssd_chunk_scan": 0, "flash_attention": 0, kernel: L}
    check({k: after_prefill[k] for k in want} == want,
          f"{what}: prefill launched {after_prefill}, expected {L} {kernel}")
    check({k: counts[k] for k in want} == want, f"{what}: decode launched kernels {counts}")
    other = {k: v for k, v in counts.items() if k not in want and v}
    check(not other, f"{what}: other kernels launched: {other}")
    logits, tokens, cache = res["logits"], res["tokens"], res["cache"]
    check(tuple(logits.shape) == (batch, cfg.vocab_size) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"{what}: logits {tuple(logits.shape)}")
    if tokens is not None:
        check(tokens.shape == (batch, LM_GEN) and tokens.min() >= 0
              and tokens.max() < cfg.vocab_size, f"{what}: tokens {tokens.shape}")
    if cfg.family == "ssm":
        ssm = (batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
        check(len(cache["layers"]) == L and all(
            tuple(st["ssm"].shape) == ssm and bool(torch.isfinite(st["ssm"]).all())
            for st in cache["layers"]), f"{what}: SSM states")
        return
    S = prompt if tokens is None else prompt + LM_GEN
    kv = (L, batch, min(S, cfg.sliding_window or S), cfg.num_kv_heads, cfg.head_dim)
    check(tuple(cache["k"].shape) == kv and bool(torch.isfinite(cache["k"][-1]).all()),
          f"{what}: KV cache {tuple(cache['k'].shape)} != {kv}")


def n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(n_params(v) for v in tree)
    return tree.numel()


def fp32_check(torch, mods, arch, full, batch, prompt):
    """The config at fp32 and FP32_LAYERS layers through the kernels, then
    the plain versions (TF32 off): logits within LM_LOGIT_RTOL of the plain
    run's largest, the greedy tokens equal; for the MoE family the (token,
    choice) expert assignments that differ between the two runs (a router
    near-tie can flip one), counted over every routing call."""
    cfg32 = dataclasses.replace(full, num_layers=FP32_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    moe, routes = mods["moe"], []
    real_route = moe.route

    def spy_route(*a, **k):
        r = real_route(*a, **k)
        routes[-1].append(r["idx"].sort(dim=-1).values)
        return r

    moe.route = spy_route
    try:
        routes.append([])
        res_k, after_prefill, counts, _, _ = serve_run(torch, mods, arch, cfg32, batch, prompt)
        check_serve(torch, res_k, cfg32, batch, prompt, after_prefill, counts,
                    f"{arch} fp32 kernels")
        logits_k, tokens_k = res_k["logits"].clone(), res_k["tokens"]
        del res_k
        torch.cuda.empty_cache()
        routes.append([])
        res_p, _, counts_p, _, _ = serve_run(torch, mods, arch, cfg32, batch, prompt,
                                             plain=True)
    finally:
        moe.route = real_route
    check(not any(counts_p.values()), f"{arch}: the plain run launched kernels: {counts_p}")
    check(len(routes[0]) == len(routes[1]), f"{arch}: routing calls differ")
    flips = sum(int((a != b).sum()) for a, b in zip(*routes))
    diff = (logits_k - res_p["logits"]).abs().max().item()
    scale = res_p["logits"].abs().max().item()
    check(diff <= LM_LOGIT_RTOL * scale,
          f"{arch} fp32 logits: kernels vs plain differ by {diff} > {LM_LOGIT_RTOL} x {scale}")
    if tokens_k is not None:
        check((tokens_k == res_p["tokens"]).all(),
              f"{arch} fp32 greedy tokens differ:\n{tokens_k}\n{res_p['tokens']}")
    del res_p
    torch.cuda.empty_cache()
    summary = {"layers": FP32_LAYERS, "max_abs_logit_diff": diff, "max_abs_logit": scale,
               "tokens_equal": None if tokens_k is None else True}
    if cfg32.family == "moe":
        summary.update(routing_flips=flips,
                       routing_assignments=sum(a.numel() for a in routes[0]))
    return summary


def lm_serve_phase(torch, mods, dev, runs):
    """Phases 18 and 19: each (arch, layers, batch, prompt) of ``runs`` in
    bf16 through the launcher's ``run_lm`` (an encoder's prefill through
    ``models/api.py``), built and freed in turn, each config at its first
    shape once more at fp32 and FP32_LAYERS layers against the plain
    versions. Returns (summaries, launch counts per run, the first flash
    operands and the first SSD operands of each run, by run label)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summaries, counts_by_run, operands, checked = [], {}, {"flash": {}, "ssd": {}}, set()
    for arch, layers, batch, prompt in runs:
        t0 = time.perf_counter()
        full = mods["get_config"](arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        label = f"{arch} {batch}x{prompt}"
        what = f"lm serve {label}"
        torch.cuda.reset_peak_memory_stats()
        res, after_prefill, counts, captured, step_ms = serve_run(
            torch, mods, arch, cfg, batch, prompt)
        check(res["cfg"] == cfg and res["params"]["embed"].dtype == torch.bfloat16
              and res["params"]["embed"].device.type == dev.type,
              f"{what}: not the bf16 config on the card")
        check_serve(torch, res, cfg, batch, prompt, after_prefill, counts, what)
        walls = warm_prefill_ms(torch, mods, res, batch, prompt)
        kernel = "ssd_chunk_scan" if cfg.family == "ssm" else "flash_attention"
        decode_steps = LM_GEN - 1 if res["tokens"] is not None else 0
        summaries.append({
            "arch": arch, "family": cfg.family, "batch": batch, "prompt": prompt,
            "layers": cfg.num_layers, "full_layers": full.num_layers,
            "reduced": None if layers is None else f"depth {full.num_layers} -> {layers}",
            "window": cfg.sliding_window,
            "kv_slots": res["cache"]["k"].shape[2] if "k" in res["cache"] else None,
            "params_GB": n_params(res["params"]) * 2 / 1e9,
            "prefill_ms_cold": res["prefill_s"] * 1e3, "prefill_ms_warm": min(walls),
            "prefill_ms_warm_runs": walls,
            "prompt_tokens_per_s_warm": batch * prompt / (min(walls) / 1e3),
            "decode_ms_per_step": (res["decode_s"] / decode_steps * 1e3
                                   if decode_steps else None),
            "decode_step_ms_median": statistics.median(step_ms) if step_ms else None,
            f"{kernel}_per_prefill": after_prefill[kernel],
            f"{kernel}_in_decode": counts[kernel] - after_prefill[kernel],
            "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
            "tokens": None if res["tokens"] is None else res["tokens"].tolist()})
        counts_by_run[what] = counts
        for k in ("flash", "ssd"):
            if k in captured:
                operands[k][label] = captured[k]
        del res, captured
        torch.cuda.empty_cache()
        if arch not in checked:  # fp32 at each config's first shape
            checked.add(arch)
            summaries[-1]["fp32"] = fp32_check(torch, mods, arch, full, batch, prompt)
        summaries[-1]["wall_s"] = time.perf_counter() - t0
        print("lm serve: " + json.dumps(summaries[-1]), flush=True)
        log(f"{what}: {cfg.num_layers} layers, {after_prefill[kernel]} {kernel} per "
            f"prefill, none in decode; fp32 at {FP32_LAYERS} layers within {LM_LOGIT_RTOL} "
            f"of the plain run ({time.perf_counter() - t0:.1f}s)")
    return summaries, counts_by_run, operands["flash"], operands["ssd"]


def time_flash_shapes(torch, mods, operands, dev) -> list:
    """flash_attention at each config's first prefill operands (bf16): median
    ms (CUDA events, L2 flushed) beside the bound (flops at the bf16 tensor
    cores' rate, or bytes), the plain version and SDPA (grouped keys through
    ``enable_gqa``), each held against its plain version."""
    import torch.nn.functional as F

    fa, ref = mods["fa"], mods["ref"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = []
    for arch, (q, k, v, causal, window) in operands.items():
        B, Sq, H, hd = q.shape
        Skv, K = k.shape[1], k.shape[2]
        got = fa.flash_attention(q, k, v, causal, window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        _, err, rel = flash_close(torch, got, want, f"{arch}'s operands")
        del got, want
        pairs = valid_pairs(Sq, Skv, causal, window)
        f_ops = 4 * B * H * hd * pairs
        f_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        t_ops, t_bytes = f_ops / BF16_OPS_PER_S, f_bytes / HBM_BYTES_PER_S
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        library = "F.scaled_dot_product_attention(is_causal, enable_gqa), (B, H, S, hd)"
        try:
            F.scaled_dot_product_attention(qh[:1, :, :8], kh[:1, :, :8], vh[:1, :, :8],
                                           enable_gqa=H != K)
        except TypeError:  # an older torch: the keys expanded to H heads beforehand
            kh, vh = (t.repeat_interleave(H // K, dim=1) for t in (kh, vh))
            library = ("F.scaled_dot_product_attention(is_causal), (B, H, S, hd), keys "
                       "expanded to H heads outside the timed call")
        if window is not None and window < max(Sq, Skv):  # a window that cuts: a mask
            i = torch.arange(Sq, device=dev)[:, None]
            j = torch.arange(Skv, device=dev)[None]
            keep = (i - j < window) & ((j <= i) if causal else True)
            mask = torch.zeros((Sq, Skv), dtype=q.dtype, device=dev).masked_fill(
                ~keep, float("-inf"))
            if kh.shape[1] != H:
                kh, vh = (t.repeat_interleave(H // K, dim=1) for t in (kh, vh))
            library = ("F.scaled_dot_product_attention(attn_mask=the causal window as "
                       "an additive (Sq, Skv) mask), keys expanded to H heads outside "
                       "the timed call")
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        else:
            sdpa = (lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=H != K)
                if library.endswith("hd)")
                else F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
        ms = median_ms(torch, lambda: fa.flash_attention(q, k, v, causal, window), 20, flush)
        out.append({
            "arch": arch, "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "hd": hd},
            "gqa": H // K, "causal": causal, "hd_padded_to": 32 if hd <= 32 else
            64 if hd <= 64 else 128, "ms": ms,
            "plain_ms": median_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window), 3, flush),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": median_ms(torch, sdpa, 20, flush),
            "library": library, "window": window, "tflops_per_s": f_ops / ms / 1e9,
            "max_abs_err": err, "rel_err": rel})
        del qh, kh, vh, sdpa
        log(f"flash at {arch}'s operands: {ms:.4f} ms, bound {out[-1]['bound_ms']:.4f}, "
            f"SDPA {out[-1]['library_ms']}")
    return out


def time_ssd_shapes(torch, mods, operands, dev) -> list:
    """ssd_chunk_scan at each run's first prefill operands (bf16): held
    against its plain version, median ms (CUDA events, L2 flushed) beside
    its bound (operations at the TF32 rate, as row 8, or bytes) and the
    plain version's time; no single PyTorch call computes the scan."""
    ssd, ops, ref = mods["ssd"], mods["ops"], mods["ref"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = []
    for label, (x, dt, A, Bm, Cm, Q) in operands.items():
        _, err = lm_ssd_check(torch, ops, ref, (x, dt, A, Bm, Cm), Q)
        s_ops, s_bytes = ssd_work(x, dt, A, Bm, Cm, Q)
        t_ops, t_bytes = s_ops / TF32_OPS_PER_S, s_bytes / HBM_BYTES_PER_S
        ms = median_ms(torch, lambda: ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, Q), 20, flush)
        B, S, nh, hd = x.shape
        out.append({
            "arch": label, "shape": {"B": B, "S": S, "nh": nh, "hd": hd, "ng": Bm.shape[2],
                                     "ds": Bm.shape[3], "Q": Q},
            "ms": ms, "plain_ms": median_ms(torch, lambda: ref.ssd_chunk_scan_ref(
                x, dt, A, Bm, Cm, Q), 3, flush),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms_tf32": t_ops * 1e3, "ops_ms_bf16": s_ops / BF16_OPS_PER_S * 1e3,
            "bytes_ms": t_bytes * 1e3, "flops": s_ops, "bytes": s_bytes,
            "library_ms": None,
            "library": "no single PyTorch call computes the chunked SSD scan",
            "tflops_per_s": s_ops / ms / 1e9, "gb_per_s": s_bytes / ms / 1e6,
            "max_abs_err": err})
        log(f"ssd at {label}'s operands: {ms:.4f} ms, bound {out[-1]['bound_ms']:.4f} "
            f"({out[-1]['bound_by']}), plain {out[-1]['plain_ms']:.4f}")
    return out


# --------------------------------------------------------------------------- #
# 20. LM training of the transformer families
# --------------------------------------------------------------------------- #
#: phase 20's runs through ``train_lm``: (arch, layers kept, batch, tokens,
#: steps). The main path: chatglm3-6b at full width cut to 8 of 28 layers
#: (bf16 params and grads, fp32 m, v and master, 16 bytes a parameter:
#: 2.16B parameters, ~35 GB; ~100 GB at full depth), remat, 4 x 4096 tokens
#: (the reference's global batch 256 cut to 4). Then mixtral-8x7b at full
#: width, 2 of 32 layers (~51 GB), at 1 x 8192, so that its 4096-key window
#: cuts in the backward kernel
LM_TRAIN_RUNS = (("chatglm3-6b", 8, 4, 4096, 12), ("mixtral-8x7b", 2, 1, 8192, 6))
LM_TRAIN_LR = 3e-4
LM_TRAIN_TIMED_FROM = 2  # ms/step: the median over steps 3 .. N
LM_TRAIN_TRACED = 10  # the main path's step traced with torch.profiler (the 11th)
#: the flash kernels a traced step names: the forward and the bf16
#: backward's four passes (``fa_bwd_delta_kernel``, ``fa_bwd_dkv_wgmma``, its
#: sum over the GQA splits ``fa_bwd_dkv_reduce``, ``fa_bwd_dq_wgmma``)
BWD_KERNELS = ("flash_fwd", "fa_bwd_delta", "fa_bwd_dkv_wgmma", "fa_bwd_dkv_reduce",
               "fa_bwd_dq_wgmma")
#: the passes of one bf16 backward call, read from the main path's traced
#: step: (pass, kernel name, how many of the products it computes, each a
#: fifth of ``bwd_work``'s operations)
BWD_PASSES = (("D", "fa_bwd_delta", 0), ("dK/dV", "fa_bwd_dkv_wgmma", 4),
              ("dK/dV sum", "fa_bwd_dkv_reduce", 0), ("dQ", "fa_bwd_dq_wgmma", 3))
#: the backward kernel against its plain version (``kernels/ref.py:
#: flash_attention_bwd_ref``) on the same lse: (row, B, S, H, K, hd, causal,
#: window), rows 7a, 7h and 7c of PERF.md's kernel table
BWD_SHAPES = (("7a chatglm3-6b", 4, 2048, 32, 2, 128, True, None),
              ("7h mixtral-8x7b", 1, 8192, 32, 8, 128, True, 4096),
              ("7c hubert-xlarge", 4, 2048, 16, 16, 80, False, None))
#: limits of dq, dk and dv: max |kernel - plain| over the largest |plain|,
#: and ||kernel - plain||_F / ||plain||_F (fp32: sums in another order;
#: bf16: the results rounded once to bf16, 2^-9 relative); lse within
#: BWD_LSE_ATOL (the tensor-core forward's ex2.approx)
BWD_MAX = {"float32": 1e-4, "bfloat16": 2e-2}
BWD_REL = {"float32": 1e-5, "bfloat16": 1e-2}
BWD_LSE_ATOL = {"float32": 1e-5, "bfloat16": 1e-3}
#: (c): fp32 (TF32 off), 2 layers at full width, short sequences, 3 steps
#: through the kernels and through the plain versions: every loss within
#: LM_TRAIN_LOSS_RTOL; step 1's raw gradients (before the clip) leaf by
#: leaf, ||kernel - plain||_F <= LM_TRAIN_GRAD_RTOL x ||plain leaf||_F +
#: LM_TRAIN_GRAD_FLOOR x ||all plain gradients||_F (Adam is blind to a
#: leaf's scale, so only the gradients show a scale error; the floor is
#: for the key bias, whose exact gradient is 0: a constant added to every
#: key of a query's softmax); and at most LM_TRAIN_FLIP_SHARE of all
#: params after step 3 more than 1e-3 x lr (+ 1e-6 of its size) apart. An
#: Adam step is about lr x sign(g) at first, so an entry whose gradient is
#: within its rounding of zero steps either way in the two runs (the key
#: bias's are all such). The params' largest gap is recorded, not held: at
#: most lr a step each way, it could not exceed a bound of 2 x 3 x lr
LM_TRAIN_FP32 = (("chatglm3-6b", 2, 2, 256), ("mixtral-8x7b", 2, 1, 256))
LM_TRAIN_FP32_STEPS = 3
LM_TRAIN_LOSS_RTOL, LM_TRAIN_FLIP_SHARE = 1e-4, 1e-3
LM_TRAIN_GRAD_RTOL, LM_TRAIN_GRAD_FLOOR = 1e-4, 1e-5
#: (d): the supervisor drill at chatglm3-6b's smoke config
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL_AT = 12, 4, 7
FLASH_PLAIN = ("flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref")


def lm_train_run(torch, mods, cfg, arch, batch, seq, steps, ckpt_dir, plain=False,
                 step_hook=None, capture=None, ckpt_every=1000, smoke=False, trace=None):
    """One ``train_lm`` run on the card (``cfg`` the config it trains).
    Counts are reset just before; the launch counts are read at the start
    of every step and at the end. Without ``plain`` the plain attention
    versions raise during the run, and ``capture`` (a dict) receives the
    operands of the first ``flash_attention_bwd`` call; with ``plain``,
    ``ops.flash_attention`` is the plain version, differentiated by torch's
    autograd. ``trace`` (a dict) receives a torch.profiler summary of step
    LM_TRAIN_TRACED (``device_summary``). Returns (result, launch counts at
    each step start and at the end)."""
    train, ops, ref, fa = mods["train"], mods["ops"], mods["ref"], mods["fa"]
    argv = ["--arch", arch, "--batch", str(batch), "--seq-len", str(seq), "--steps",
            str(steps), "--seed", "0", "--lr", str(LM_TRAIN_LR), "--device", DEVICE,
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every)] + (["--smoke"] * smoke)
    args = train.build_parser().parse_args(argv)
    snaps, prof = [], []

    def hook():
        snaps.append(ops.launch_counts())
        if trace is not None and len(snaps) in (LM_TRAIN_TRACED + 1, LM_TRAIN_TRACED + 2):
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            if not prof:  # the traced step starts
                prof.append(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                prof[0].__enter__()
                prof.append(time.perf_counter())
            else:  # ... and ends
                wall = (time.perf_counter() - prof[1]) * 1e3
                prof[0].__exit__(None, None, None)
                trace.update(device_summary(torch, prof[0], wall, named=BWD_KERNELS))
                # where the host's time goes: the ops with the most self CPU time
                host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                               for e in prof[0].key_averages()), key=lambda r: -r[1])
                trace["host_top"] = [{"name": k[:90], "ms": ms, "calls": n}
                                     for k, ms, n in host[:12]]
        if step_hook is not None:
            step_hook()

    saved = {n: getattr(ref, n) for n in FLASH_PLAIN}
    real_bwd, real_ops_fa = fa.flash_attention_bwd, ops.flash_attention

    def no_plain(*_a, **_k):
        raise RuntimeError("a plain PyTorch version ran on the main path")

    def spy_bwd(*a):
        if "bwd" not in capture:
            capture["bwd"] = tuple(t.clone() if torch.is_tensor(t) else t for t in a)
        return real_bwd(*a)

    if plain:
        ops.flash_attention = lambda q, k, v, causal=True, window=None, q_offset=0: (
            saved["flash_attention_ref"](q, k, v, causal=causal, window=window,
                                         q_offset=q_offset))
    else:
        for n in saved:
            setattr(ref, n, no_plain)
        if capture is not None:
            fa.flash_attention_bwd = spy_bwd
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train.train_lm(args, cfg=cfg, step_hook=hook)
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
        fa.flash_attention_bwd, ops.flash_attention = real_bwd, real_ops_fa
    snaps.append(ops.launch_counts())
    res["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
    return res, snaps


def step_launches(snaps, name) -> list:
    return [b[name] - a[name] for a, b in zip(snaps, snaps[1:])]


def lm_train_main(torch, mods, dev, tmp):
    """Phase 20's two bf16 runs (LM_TRAIN_RUNS): every step exactly 2 x L
    ``flash_attention`` launches (the forward and its remat recompute) and
    L ``flash_attention_bwd``, no other kernel; losses and grad norms
    finite; mixtral's aux loss finite and > 0 in every MoE call. Returns
    (summaries, launches by run, the main path's first backward operands)."""
    moe = mods["moe"]
    summaries, counts_by_run, captured = [], {}, {}
    for arch, layers, batch, seq, steps in LM_TRAIN_RUNS:
        t0 = time.perf_counter()
        full = mods["get_config"](arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        label = f"lm train {arch} {batch}x{seq}"
        aux, real_moe = [], moe.moe_ffn

        def spy_moe(*a, **k):
            out, a_loss = real_moe(*a, **k)
            aux.append(a_loss.detach())
            return out, a_loss

        moe.moe_ffn = spy_moe
        trace = {} if not captured else None  # the main path's
        try:
            res, snaps = lm_train_run(torch, mods, cfg, arch, batch, seq, steps,
                                      os.path.join(tmp, label.replace(" ", "_")),
                                      capture=captured if not captured else None, trace=trace)
        finally:
            moe.moe_ffn = real_moe
        rep = res["report"]
        check(res["cfg"] == cfg and res["params"]["embed"].dtype == torch.bfloat16
              and res["params"]["embed"].device.type == dev.type,
              f"{label}: not the bf16 config on the card")
        check(rep.steps_run == steps and rep.restarts == 0 and len(res["losses"]) == steps,
              f"{label}: {rep}")
        check(all(map(math.isfinite, res["losses"] + res["grad_norms"])),
              f"{label}: non-finite losses {res['losses']} or grad norms {res['grad_norms']}")
        fwd, bwd = step_launches(snaps, "flash_attention"), step_launches(
            snaps, "flash_attention_bwd")
        check(fwd == [2 * layers] * steps and bwd == [layers] * steps,
              f"{label}: flash launches per step {fwd}, backward {bwd}; expected "
              f"{2 * layers} and {layers}")
        other = {k: v for k, v in snaps[-1].items()
                 if k not in ("flash_attention", "flash_attention_bwd") and v}
        check(not other, f"{label}: other kernels launched: {other}")
        if cfg.family == "moe":
            # one aux loss per layer per step, plus any from a remat
            # recompute that ran to the layer's end (non-reentrant checkpoint
            # stops a recompute once it has every saved tensor)
            a = torch.stack(aux)
            check(layers * steps <= len(aux) <= 2 * layers * steps
                  and bool(torch.isfinite(a).all()) and bool((a > 0).all()),
                  f"{label}: aux losses {a.tolist()}")
        starts = res["step_starts"]
        step_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
        ms = statistics.median(step_ms[LM_TRAIN_TIMED_FROM:])
        summaries.append({
            "run": label, "arch": arch, "family": cfg.family, "layers": layers,
            "reduced": [f"depth {full.num_layers} -> {layers}",
                        f"global batch 256 -> {batch}"],
            "batch": batch, "seq": seq, "steps": steps, "window": cfg.sliding_window,
            "params": n_params(res["params"]), "ms_per_step": ms, "step_ms": step_ms,
            "tokens_per_s": batch * seq / (ms / 1e3), "peak_memory_GB": res["peak_memory_GB"],
            "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
            "losses": res["losses"], "grad_norms": res["grad_norms"],
            "flash_attention_per_step": fwd[0], "flash_attention_bwd_per_step": bwd[0],
            "aux_loss_min": min(float(x) for x in aux) if aux else None,
            "aux_loss_max": max(float(x) for x in aux) if aux else None,
            "profile": trace, "wall_s": time.perf_counter() - t0})
        counts_by_run[label] = snaps[-1]
        del res, aux
        torch.cuda.empty_cache()
        print("lm train: " + json.dumps(summaries[-1]), flush=True)
        log(f"{label}: {ms:.1f} ms/step, {summaries[-1]['tokens_per_s']:.0f} tokens/s, peak "
            f"{summaries[-1]['peak_memory_GB']:.1f} GB, loss {summaries[-1]['loss_first']:.4f} "
            f"-> {summaries[-1]['loss_last']:.4f}, {fwd[0]} + {bwd[0]} flash launches a step "
            f"({time.perf_counter() - t0:.1f}s)")
    return summaries, counts_by_run, captured["bwd"]


def bwd_plain(torch, ref, q, k, v, o, lse, do, causal, window):
    """ref.flash_attention_bwd_ref one kv head at a time (the whole (B, H,
    Sq, Skv) fp32 matrix at 7h would be 8.6 GB a copy)."""
    K, G = k.shape[2], q.shape[2] // k.shape[2]
    dq, dk, dv = [], [], []
    for kh in range(K):
        hs, ks = slice(kh * G, (kh + 1) * G), slice(kh, kh + 1)
        a, b, c = ref.flash_attention_bwd_ref(q[:, :, hs], k[:, :, ks], v[:, :, ks],
                                              o[:, :, hs], lse[:, hs].contiguous(),
                                              do[:, :, hs], causal, window)
        dq.append(a)
        dk.append(b)
        dv.append(c)
    return torch.cat(dq, dim=2), torch.cat(dk, dim=2), torch.cat(dv, dim=2)


def lse_plain(torch, ref, q, k, causal, window, q_offset=0):
    K, G = k.shape[2], q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_lse_ref(q[:, :, kh * G:(kh + 1) * G],
                                                  k[:, :, kh:kh + 1], causal, window, q_offset)
                      for kh in range(K)], dim=1)


def fwd_plain(torch, ref, q, k, v, causal, window, q_offset=0):
    """ref.flash_attention_ref one kv head at a time, as ``bwd_plain``."""
    K, G = k.shape[2], q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_ref(q[:, :, kh * G:(kh + 1) * G], k[:, :, kh:kh + 1],
                                              v[:, :, kh:kh + 1], causal=causal, window=window,
                                              q_offset=q_offset)
                      for kh in range(K)], dim=2)


def main_forward_close(torch, ref, q, k, v, o, lse, causal, window, q_offset, what) -> dict:
    """The forward kernel's o and lse that the main path saved for its
    backward, held to their plain versions on the same q, k, v: o in
    FLASH_ATOL and FLASH_RTOL (``flash_close``), lse within BWD_LSE_ATOL."""
    name, o_err, o_rel = flash_close(torch, o, fwd_plain(torch, ref, q, k, v, causal, window,
                                                         q_offset), what)
    torch.cuda.empty_cache()
    lse_err = (lse - lse_plain(torch, ref, q, k, causal, window, q_offset)).abs().max().item()
    check(lse_err <= BWD_LSE_ATOL[name], f"{what} {name}: lse differs by {lse_err} "
                                         f"(limit {BWD_LSE_ATOL[name]})")
    torch.cuda.empty_cache()
    return {"o_max_abs_err": o_err, "o_rel_err": o_rel, "lse_max_abs_err": lse_err}


def bwd_operands(torch, dev, B, S, H, K, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    return draw(B, S, H, hd), draw(B, S, K, hd), draw(B, S, K, hd), draw(B, S, H, hd)


def bwd_close(torch, got, want, name, what) -> dict:
    out = {}
    for n, gt, w in zip(("dq", "dk", "dv"), got, want):
        diff = gt.float() - w.float()
        scale = w.float().abs().max().item()
        err = diff.abs().max().item()
        rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w.float())
               .clamp_min(1e-30)).item()
        check(gt.dtype == w.dtype and gt.shape == w.shape and err <= BWD_MAX[name] * scale
              and rel <= BWD_REL[name],
              f"flash_attention_bwd {n} differs by {err} (limit {BWD_MAX[name]} x {scale}), "
              f"relative {rel} (limit {BWD_REL[name]}) at {what} {name}")
        out[n] = {"max_abs_err": err, "max_abs_plain": scale, "rel_err": rel}
    return out


def bwd_parity(torch, mods, dev) -> list:
    """(a) the backward kernel against its plain version at BWD_SHAPES, bf16
    and fp32 operands, on the forward kernel's lse (itself held to the plain
    lse); (b) the forward's output with ``lse`` bitwise equal to the one
    without."""
    fa, ref = mods["fa"], mods["ref"]
    out = []
    for label, B, S, H, K, hd, causal, window in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = bwd_operands(torch, dev, B, S, H, K, hd, dtype)
            lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
            o = fa.flash_attention(q, k, v, causal, window, 0, lse=lse)
            o_serve = fa.flash_attention(q, k, v, causal, window, 0)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
            torch.cuda.synchronize()
            check(torch.equal(o, o_serve), f"{label} {name}: the forward's output changes "
                                           "when it writes lse")
            lse_err = (lse - lse_plain(torch, ref, q, k, causal, window)).abs().max().item()
            check(lse_err <= BWD_LSE_ATOL[name], f"{label} {name}: lse differs by {lse_err}")
            want = bwd_plain(torch, ref, q, k, v, o, lse, do, causal, window)
            errs = bwd_close(torch, got, want, name, label)
            out.append({"row": label, "dtype": name, "shape": {
                "B": B, "S": S, "H": H, "K": K, "hd": hd}, "causal": causal,
                "window": window, "lse_max_abs_err": lse_err, "forward_bitwise_with_lse": True,
                **errs})
            del q, k, v, do, lse, o, o_serve, got, want
            torch.cuda.empty_cache()
            log(f"flash_attention_bwd at {label} {name}: dq/dk/dv relative "
                f"{errs['dq']['rel_err']:.2e}/{errs['dk']['rel_err']:.2e}/"
                f"{errs['dv']['rel_err']:.2e}, lse {lse_err:.2e}; the forward bitwise equal "
                "with lse")
    return out


def first_grads(mods, use):
    """Runs ``use(grads)`` on the raw gradients of a run's first step (a spy
    on ``launch/steps.py``'s ``clip_by_global_norm``, which takes them in
    ``tree_leaves`` order). Returns restore()."""
    steps, real_clip, seen = mods["steps"], mods["steps"].clip_by_global_norm, []

    def spy(grads, max_norm):
        if not seen:
            seen.append(True)
            use(grads)
        return real_clip(grads, max_norm)

    steps.clip_by_global_norm = spy
    return lambda: setattr(steps, "clip_by_global_norm", real_clip)


def grad_gaps(torch, kept, grads) -> dict:
    """Step 1's gradients of the kernel run (``kept``, on the host) against
    the plain run's, leaf by leaf: ||kernel - plain||_F and the plain
    leaf's norm, and the plain gradients' whole norm. Only measures (it
    runs inside the supervised step, which would take a raise for a node
    failure): ``grads_close`` holds them."""
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    return {"total": total.item(), "leaves": [
        (tuple(b.shape), a.shape == b.shape and torch.linalg.vector_norm(a.to(b.device) - b)
         .item(), torch.linalg.vector_norm(b).item()) for a, b in zip(kept, grads)]}


def grads_close(gaps, what) -> dict:
    """Holds ``grad_gaps``' record as the comment on LM_TRAIN_FP32 says."""
    check(bool(gaps), f"{what}: the plain run's gradients were not compared")
    total, worst_rel, worst = gaps["total"], 0.0, (-1.0, None)
    for i, (shape, diff, norm) in enumerate(gaps["leaves"]):
        limit = LM_TRAIN_GRAD_RTOL * norm + LM_TRAIN_GRAD_FLOOR * total
        check(diff is not False and diff <= limit,
              f"{what}: step 1's gradient leaf {i} {shape} differs by {diff} in the Frobenius "
              f"norm (limit {limit}; the leaf's {norm}, all {total})")
        worst_rel = max(worst_rel, diff / norm if norm else 0.0)
        worst = max(worst, (diff / limit, (i, shape, diff, norm)))
    return {"grad_max_rel_err": worst_rel, "grad_worst_share_of_limit": worst[0],
            "grad_worst_leaf": worst[1], "grad_norm_plain": total}


def lm_train_fp32_check(torch, mods, dev, tmp) -> list:
    """(c) LM_TRAIN_FP32: three steps through the kernels, then the same
    three through the plain versions on the card (TF32 off), held as the
    comment on LM_TRAIN_FP32 says. The kernel run's step-1 gradients and
    final params wait in host memory while the plain run runs."""
    tree_leaves, out = mods["tree_leaves"], []
    for arch, layers, batch, seq in LM_TRAIN_FP32:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(mods["get_config"](arch), num_layers=layers,
                                  param_dtype="float32", compute_dtype="float32")
        grads_k, gaps = [], {}
        restore = first_grads(mods, lambda g: grads_k.extend(
            t.to("cpu", copy=True) for t in g))
        try:
            res, snaps = lm_train_run(torch, mods, cfg, arch, batch, seq, LM_TRAIN_FP32_STEPS,
                                      os.path.join(tmp, f"fp32_{arch}_k"))
        finally:
            restore()
        check(step_launches(snaps, "flash_attention_bwd") == [layers] * LM_TRAIN_FP32_STEPS
              and res["report"].restarts == 0, f"{arch} fp32: backward launches {snaps}, "
              f"{res['report']}")
        losses_k, peak_k = res["losses"], res["peak_memory_GB"]
        kept = [t.cpu() for t in tree_leaves(res["params"])]
        del res
        torch.cuda.empty_cache()
        restore = first_grads(mods, lambda g: gaps.update(grad_gaps(torch, grads_k, g)))
        try:
            res, snaps = lm_train_run(torch, mods, cfg, arch, batch, seq, LM_TRAIN_FP32_STEPS,
                                      os.path.join(tmp, f"fp32_{arch}_p"), plain=True)
        finally:
            restore()
        del grads_k
        check(not any(snaps[-1].values()), f"{arch} fp32 plain run launched {snaps[-1]}")
        check(res["report"].restarts == 0, f"{arch} fp32 plain run: {res['report']}")
        grad_errs = grads_close(gaps, f"{arch} fp32")
        losses_p = res["losses"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
        check(loss_rel <= LM_TRAIN_LOSS_RTOL,
              f"{arch} fp32: losses {losses_k} (kernels) vs {losses_p} (plain)")
        worst_abs, flips, total = 0.0, 0, 0
        for a, b in zip(kept, tree_leaves(res["params"])):
            diff = (a.to(b.device) - b).abs()
            worst_abs = max(worst_abs, diff.max().item())
            flips += int((diff > 1e-3 * LM_TRAIN_LR + 1e-6 * b.abs()).sum())
            total += b.numel()
        check(flips <= LM_TRAIN_FLIP_SHARE * total,
              f"{arch} fp32: {flips} of {total} params after step {LM_TRAIN_FP32_STEPS} more "
              f"than 1e-3 x lr apart (the largest gap {worst_abs})")
        out.append({"arch": arch, "layers": layers, "batch": batch, "seq": seq,
                    "steps": LM_TRAIN_FP32_STEPS, "losses_kernels": losses_k,
                    "losses_plain": losses_p, "max_loss_rel_diff": loss_rel, **grad_errs,
                    "max_param_abs_diff": worst_abs, "params_apart": flips,
                    "params": total,
                    "peak_memory_GB": max(peak_k, res["peak_memory_GB"]),
                    "wall_s": time.perf_counter() - t0})
        del res, kept
        torch.cuda.empty_cache()
        log(f"lm train fp32 {arch} ({layers} layers, {batch}x{seq}): losses within "
            f"{loss_rel:.2e} of the plain run's, step 1's gradients within "
            f"{grad_errs['grad_max_rel_err']:.2e} a leaf (the worst at "
            f"{grad_errs['grad_worst_share_of_limit']:.2f} of its limit), {flips} of {total} "
            f"params more than 1e-3 x lr apart, none more than {worst_abs:.2e} "
            f"({time.perf_counter() - t0:.1f}s)")
    return out


def lm_train_drill(torch, mods, tmp) -> dict:
    """(d) chatglm3-6b's smoke config through ``train_lm`` on the card:
    DRILL_STEPS steps, checkpoints every DRILL_EVERY, a node failure at the
    DRILL_FAIL_AT-th step call (``FailureInjector``): one restore, and the
    final params and AdamW state bitwise equal to an uninterrupted run's."""
    t0 = time.perf_counter()
    from repro_torch.configs import get_smoke_config
    from repro_torch.runtime import FailureInjector

    tree_leaves = mods["tree_leaves"]
    cfg = get_smoke_config("chatglm3-6b")
    runs = {}
    for name, hook in (("clean", None),
                       ("drill", FailureInjector(fail_at=[DRILL_FAIL_AT]).maybe_fail)):
        res, _ = lm_train_run(torch, mods, cfg, "chatglm3-6b", 8, 128, DRILL_STEPS,
                              os.path.join(tmp, f"drill_{name}"), step_hook=hook,
                              ckpt_every=DRILL_EVERY, smoke=True)
        runs[name] = res
    clean, drill = runs["clean"], runs["drill"]
    check(clean["report"].restarts == 0 and drill["report"].restarts == 1
          and drill["report"].causes == [(DRILL_FAIL_AT - 1, "RuntimeError")],
          f"drill: {drill['report']}")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((clean["params"], clean["opt_state"])),
        tree_leaves((drill["params"], drill["opt_state"]))))
    check(same, "drill: the final params and AdamW state differ from the uninterrupted run's")
    out = {"config": cfg.name, "steps": DRILL_STEPS, "ckpt_every": DRILL_EVERY,
           "fail_at_call": DRILL_FAIL_AT, "restarts": drill["report"].restarts,
           "restore_ms": drill["report"].restore_ms, "save_ms": drill["report"].save_ms,
           "bitwise_equal": same, "wall_s": time.perf_counter() - t0}
    log(f"lm train drill: one restore, params and AdamW state bitwise equal to the "
        f"uninterrupted run's ({out['wall_s']:.1f}s)")
    return out


def bwd_work(B, Sq, Skv, H, K, hd, causal, window) -> tuple:
    """(flops, bytes) of one backward: 2.5 x the forward's QK^T and PV
    products over the unmasked pairs; q, k, v, o, dO and lse read once,
    dq, dk and dv written once (bf16)."""
    pairs = valid_pairs(Sq, Skv, causal, window)
    flops = 2.5 * 4 * B * H * hd * pairs
    n_bytes = 2 * (4 * B * Sq * H * hd + 4 * B * Skv * K * hd) + 4 * B * H * Sq
    return flops, n_bytes


def sdpa_bwd_ms(torch, q, k, v, do, causal, window, flush):
    """The library yardstick: F.scaled_dot_product_attention's forward plus
    backward, less its forward (CUDA events, median), on (B, H, S, hd)
    copies; grouped keys through ``enable_gqa``, a window as an additive
    mask over keys expanded to H heads. Returns (ms, what it timed)."""
    import torch.nn.functional as F

    H, K = q.shape[2], k.shape[2]
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kw, what = {"is_causal": causal, "enable_gqa": H != K}, \
        "F.scaled_dot_product_attention(is_causal, enable_gqa) fwd + bwd - fwd"
    if window is not None and window < q.shape[1]:
        S = q.shape[1]
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None]
        keep = (i - j < window) & ((j <= i) if causal else True)
        kw = {"attn_mask": torch.zeros((S, S), dtype=q.dtype, device=q.device).masked_fill(
            ~keep, float("-inf"))}
        kh, vh = (t.repeat_interleave(H // K, dim=1) for t in (kh, vh))
        what = ("F.scaled_dot_product_attention(attn_mask = the causal window, additive) "
                "fwd + bwd - fwd, keys expanded to H heads outside the timed call")
    qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, **kw)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
        torch.autograd.grad(out, (qh, kh, vh), doh)

    return median_ms(torch, fwd_bwd, 10, flush) - median_ms(torch, fwd, 10, flush), what


def time_bwd_shapes(torch, mods, main_operands, dev) -> list:
    """flash_attention_bwd at the main path's first backward operands (the
    kernels line's numbers) and at rows 7a and 7h (bf16): median ms (CUDA
    events, L2 flushed) beside its bound (operations at the bf16 tensor
    cores' 989 TFLOP/s, or bytes), its plain version's time (whole, not per
    kv head) and SDPA's backward. At the main path's operands the forward
    kernel's o and lse are held to their plain versions first
    (``main_forward_close``): the backward's own check takes them as
    given."""
    fa, ref = mods["fa"], mods["ref"]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    shapes = [("main path chatglm3-6b (8 layers, 4 x 4096)",) + tuple(main_operands)]
    q, k, v, o, lse, _, causal, window, q_offset = main_operands
    forward = main_forward_close(torch, ref, q, k, v, o, lse, causal, window, q_offset,
                                 shapes[0][0])
    log(f"flash_attention at {shapes[0][0]}: o relative {forward['o_rel_err']:.2e} "
        f"(max {forward['o_max_abs_err']:.2e}), lse {forward['lse_max_abs_err']:.2e} from "
        "their plain versions")
    for label, B, S, H, K, hd, causal, window in BWD_SHAPES[:2]:
        q, k, v, do = bwd_operands(torch, dev, B, S, H, K, hd, torch.bfloat16, seed=1)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        o = fa.flash_attention(q, k, v, causal, window, 0, lse=lse)
        shapes.append((label, q, k, v, o, lse, do, causal, window, 0))
    out = []
    for label, q, k, v, o, lse, do, causal, window, q_offset in shapes:
        B, Sq, H, hd = q.shape
        Skv, K = k.shape[1], k.shape[2]
        flops, n_bytes = bwd_work(B, Sq, Skv, H, K, hd, causal, window)
        t_ops, t_bytes = flops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, window, q_offset)
        want = bwd_plain(torch, ref, q, k, v, o, lse, do, causal, window)
        errs = bwd_close(torch, got, want, "bfloat16", label)
        del got, want
        ms = median_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                                             window, q_offset), 10, flush)
        ws_shape = fa.bwd_workspace_shape(B, Skv, H, K, hd)
        plain_ms = median_ms(torch, lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal, window, q_offset), 3, flush)
        torch.cuda.empty_cache()
        try:
            library_ms, library = sdpa_bwd_ms(torch, q, k, v, do, causal, window, flush)
        except RuntimeError as e:  # no SDPA backward for these operands: no yardstick
            library_ms, library = None, f"F.scaled_dot_product_attention backward: {e}"[:300]
        torch.cuda.empty_cache()
        out.append({
            "row": label, "shape": {"B": B, "Sq": Sq, "Skv": Skv, "H": H, "K": K, "hd": hd},
            "causal": causal, "window": window, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "library": library, "flops": flops, "bytes": n_bytes,
            "tflops_per_s": flops / ms / 1e9,
            "splits": fa.bwd_splits(B, Skv, H, K),
            "workspace_bytes": 0 if ws_shape is None else 4 * math.prod(ws_shape),
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "errors": errs,
            **({"forward": forward} if not out else {})})
        log(f"flash_attention_bwd at {label}: {ms:.3f} ms, bound {out[-1]['bound_ms']:.3f} "
            f"({out[-1]['bound_by']}), plain {plain_ms:.2f}, SDPA backward {library_ms}; "
            f"{out[-1]['splits']} splits, workspace {out[-1]['workspace_bytes'] / 1e6:.1f} MB")
    return out


def lm_train_phase(torch, mods, dev):
    """Phase 20: the main path and the windowed run, (a) + (b), (c), (d) and
    the backward's timing rows. Returns (summary, launches by run, the
    kernels-line entry of flash_attention_bwd)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_train_") as tmp:
        runs, counts_by_run, main_ops = lm_train_main(torch, mods, dev, tmp)
        parity = bwd_parity(torch, mods, dev)
        fp32 = lm_train_fp32_check(torch, mods, dev, tmp)
        drill = lm_train_drill(torch, mods, tmp)
    print("lm train checks: " + json.dumps({"bwd_parity": parity, "fp32": fp32,
                                            "drill": drill}), flush=True)
    times = time_bwd_shapes(torch, mods, main_ops, dev)
    del main_ops
    torch.cuda.empty_cache()
    main = times[0]
    # each pass's own time: its kernel's mean a launch in the traced step
    named = runs[0]["profile"]["named"]
    pass_ms = {name: sum(r["mean_ms"] for r in named if kernel in r["name"])
               for name, kernel, _ in BWD_PASSES}
    check(pass_ms["dK/dV"] > 0 and pass_ms["dQ"] > 0,
          f"the traced step names no backward kernel: {named}")
    passes = {"what": "mean device ms a launch in the main path's traced step "
                      "(torch.profiler), and TFLOP/s of the products each pass computes at "
                      "the main path's operands",
              "ms": pass_ms,
              "tflops_per_s": {name: n * main["flops"] / 5 / pass_ms[name] / 1e9
                               for name, _, n in BWD_PASSES if n},
              "splits": main["splits"], "workspace_bytes": main["workspace_bytes"]}
    log("flash_attention_bwd passes in the traced step: "
        + ", ".join(f"{n} {t:.3f}" for n, t in pass_ms.items()) + " ms a launch")
    entry = {
        "name": "flash_attention_bwd", "route": "cuda", "source": CU_SOURCE_FA_BWD,
        "replaces": "src/repro/kernels/ops.py:370",
        "launches": sum(c["flash_attention_bwd"] for c in counts_by_run.values()),
        "launches_by_run": {r: c["flash_attention_bwd"] for r, c in counts_by_run.items()},
        "max_abs_err": max([t["max_abs_err"] for t in times]
                           + [p[n]["max_abs_err"] for p in parity for n in ("dq", "dk", "dv")
                              if p["dtype"] == "bfloat16"]),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "details": {"shapes": times, "passes": passes, "parity": parity}}
    log(f"lm train: done ({time.perf_counter() - t0:.1f}s)")
    return {"runs": runs, "fp32": fp32, "drill": drill}, counts_by_run, entry


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
    from repro_torch.launch import serve, steps, train
    from repro_torch.models import api, hybrid, moe, ssm_lm, transformer
    from repro_torch.models.dlrm import interaction_dim
    from repro_torch.optim.optimizers import tree_leaves

    mods = {"ops": ops, "ref": ref, "gr": gr, "gc": gc, "qz": qz, "train": train,
            "pipeline": pipeline, "static_cache": static_cache,
            "dlrm_runtime": dlrm_runtime, "HostEmbeddingTable": HostEmbeddingTable,
            "DLRMConfig": DLRMConfig, "interaction_dim": interaction_dim,
            "fa": fa, "ssd": ssd, "serve": serve, "api": api, "hybrid": hybrid,
            "transformer": transformer, "ssm_lm": ssm_lm, "moe": moe,
            "ShapeSpec": ShapeSpec, "get_config": get_config, "plan": plan,
            "tree_leaves": tree_leaves, "steps": steps,
            "plan_device": plan_device, "serving_cache": serving_cache}

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    dev = torch.device(DEVICE, 0)

    t0 = time.perf_counter()
    built = _build.build_all()
    for b in built.values():
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln or "Function properties" in ln]
        log(f"build: {b.name} in {b.seconds:.2f}s -> {b.path.relative_to(ROOT)}")
        for ln in regs:
            print(f"    {ln}")
    log(f"build: {time.perf_counter() - t0:.2f}s in all")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        return run_all(torch, mods, dev, ckpt_dir, t_start)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def run_all(torch, mods, dev, ckpt_dir, t_start) -> int:
    """Phases 3-20, the kernels line, the card line and the last line."""
    ops, ref, gr, gc, qz = (mods[k] for k in ("ops", "ref", "gr", "gc", "qz"))
    serve, serving_cache, plan_device = mods["serve"], mods["serving_cache"], mods["plan_device"]
    get_config = mods["get_config"]
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
    # the launcher's host table (--seed 0 builds it from seed 1), which
    # serving never writes: the oracle's, and phase 13's
    serve_rows = backend.host.data
    oracle = serve.run_embedding(oracle_args, collect_bags=True, host=mods[
        "HostEmbeddingTable"](*serve_rows.shape, data=serve_rows))
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

    seed0 = seed0_rows(mods)
    t0 = time.perf_counter()
    summaries, train_counts, train_captured, base, fp32_losses, fp32_digest = (
        train_main_path(torch, mods, dev, seed0, ckpt_dir))
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
        _, ts_counts, ts_captured, serve_host = trace_serve_phase(torch, mods, tmp, serve_bags,
                                                                    serve_rows)
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
    del base, serve_rows  # serve_host holds phase 4's table on
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_traces_") as tmp:
        t0 = time.perf_counter()
        _, mt_counts, mt_setup, mt_base = multi_table_phase(torch, mods, tmp, dev, seed0)
        log(f"multi-table: {len(mt_counts)} runs done ({time.perf_counter() - t0:.1f}s)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, sh_counts = sharded_phase(torch, mods, mt_setup, mt_base)
    log(f"sharded: {len(sh_counts)} runs done ({time.perf_counter() - t0:.1f}s)")
    del mt_base, mt_setup, seed0

    t0 = time.perf_counter()
    rec_summary, rec_counts = recovery_phase(torch, mods, serve_bags, ckpt_dir, serve_host)
    print("recovery: " + json.dumps(rec_summary), flush=True)
    log(f"recovery: done ({time.perf_counter() - t0:.1f}s)")
    del serve_bags, serve_host
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, tf_counts, tf_operands, _ = lm_serve_phase(torch, mods, dev, TRANSFORMERS)
    flash_shapes = time_flash_shapes(torch, mods, tf_operands, dev)
    del tf_operands
    log(f"transformers: done ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    _, fam_counts, fam_flash, fam_ssd = lm_serve_phase(torch, mods, dev, FAMILY_RUNS)
    moe_shapes = time_flash_shapes(torch, mods, fam_flash, dev)
    mamba2_shapes = time_ssd_shapes(torch, mods, fam_ssd, dev)
    del fam_flash, fam_ssd
    torch.cuda.empty_cache()
    log(f"mamba2 and moe: done ({time.perf_counter() - t0:.1f}s)")
    _, lt_counts, bwd_entry = lm_train_phase(torch, mods, dev)

    by_run = {"serve": counts, **train_counts, **q_counts, **ts_counts, **tt_counts,
              **mt_counts, **sh_counts, **rec_counts}
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
        kernels[-1]["launches_by_run"].update(
            {run: c[name] for run, c in {**tf_counts, **fam_counts, **lt_counts}.items()
             if c[name]})
        kernels[-1]["launches"] = sum(kernels[-1]["launches_by_run"].values())
        if name == "flash_attention":
            train_fwd = bwd_entry["details"]["shapes"][0]["forward"]
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             *(f["max_abs_err"] for f in flash_shapes),
                                             *(f["max_abs_err"] for f in moe_shapes),
                                             train_fwd["o_max_abs_err"])
            kernels[-1]["details"] = {**lm_details[name],
                                      "warm_prefill_ms": lm_summary["prefill_ms_warm"],
                                      "prefill_profile": lm_summary["profile"]["prefill"],
                                      "transformer_shapes": flash_shapes,
                                      "moe_shapes": moe_shapes,
                                      "lm_train_main_path": train_fwd}
            kernels.append(bwd_entry)
        else:
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"],
                                             *(f["max_abs_err"] for f in mamba2_shapes))
            kernels[-1]["details"] = {**lm_details[name], "mamba2_shapes": mamba2_shapes}
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
