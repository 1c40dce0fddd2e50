#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold its kernels to their
plain PyTorch versions.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card    — the card's name and power limit, as nvidia-smi gives them;
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc;
  3. kernels — each CUDA kernel against its plain version on the card,
               bitwise (torch.equal), over duplicates within and across
               bags, drop sentinels, empty operands (which must launch
               nothing), D in {8, 40, 128, 192}, L in {1, 3, 20} and the
               serving slice's own shapes;
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

The last three lines are the ``kernels`` JSON line, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/gather_reduce.cu"
DEVICE = "cuda"
# the serving slice at the full width of dlrm-scratchpipe
# (src/repro/configs/base.py: DLRMConfig), cut to 1M rows per table
TABLES, ROWS, DIM, LOOKUPS, BATCH = 8, 1_000_000, 128, 20, 2048
STEPS, DEPTH, CACHE_FRAC = 24, 2, 0.25


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
def sweep_kernels(torch, ops, ref, dev) -> dict:
    """Bitwise sweep; returns the largest |kernel - plain| per kernel."""
    g = torch.Generator(device="cpu").manual_seed(0)
    err = {"gather_reduce": 0.0, "fill": 0.0}

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
        fill_case(4096, D, 1000, 1024)
        fill_case(4096, D, 4096, 4096)  # every slot, no sentinel
    st = torch.randn(64, 40, generator=g).to(dev)
    dup = torch.tensor([[3, 3, 3, 5], [5, 3, 5, 3], [0, 0, 0, 0]], dtype=torch.int32)
    check(torch.equal(ops.gather_reduce(st, dup.to(dev)),
                      ref.gather_reduce_ref(st, dup.to(dev))), "explicit duplicates")
    # the slice's shapes: the serving scratchpad (2M slots), BATCH x TABLES
    # bags of LOOKUPS, and a pow-2 padded fill of an eighth of the slots
    slots = max(int(TABLES * ROWS * CACHE_FRAC),
                TABLES * min(ROWS, BATCH * LOOKUPS * (DEPTH + 2)))
    gather_case(slots, DIM, BATCH * TABLES, LOOKUPS, slots)
    fill_case(slots, DIM, slots // 10, 1 << (slots // 8 - 1).bit_length())

    before = ops.launch_counts()
    for shape in ((0, 5), (3, 0), (0, 0)):
        out = ops.gather_reduce(st, torch.zeros(shape, dtype=torch.int32, device=dev))
        check(out.shape == shape[:-1] + (40,) and not out.any(), "empty gather result")
    ops.fill(st, torch.zeros(0, dtype=torch.int32, device=dev), torch.zeros(0, 40, device=dev))
    torch.cuda.synchronize()
    check(ops.launch_counts() == before, "an empty operand launched a kernel")
    return err


# --------------------------------------------------------------------------- #
# 4. the main path
# --------------------------------------------------------------------------- #
def stage_timers(serving_cache):
    """Wrap the serving runtime's stage methods with host-clock timers
    (seconds and calls per stage). They add two clock reads per call and
    no synchronization, so a stage's queued device work is charged to the
    stage that next waits for the device: the lookup's copy of the bags
    back to the host. Returns (stages, restore)."""
    stages = {}
    cls = serving_cache.ReadOnlyCacheServer
    targets = [(cls, "serve_next", "serve (whole cycle)"),
               (cls, "_plan_entry", "plan"), (cls, "_fetch", "exchange (host gather)"),
               (cls, "_insert", "insert (h2d + fill)"),
               (cls, "_emergency_fill", "emergency fill"),
               (serving_cache, "_lookup_bags", "lookup (h2d ids + gather + d2h bags)")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]

    def timed(fn, label):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                st = stages.setdefault(label, {"s": 0.0, "calls": 0})
                st["s"] += time.perf_counter() - t0
                st["calls"] += 1
        return wrapper

    for (obj, name, label), (_, _, fn) in zip(targets, saved):
        setattr(obj, name, timed(fn, label))

    def restore():
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return stages, restore


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
    stages, restore = stage_timers(serving_cache)
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
    from repro_torch.core import serving_cache
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import gather_reduce as gr
    from repro_torch.launch import serve

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
    sweep_err = sweep_kernels(torch, ops, ref, dev)
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
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
