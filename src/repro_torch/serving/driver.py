"""Synchronous serving replay: drive a serving id stream through a
read-only runtime at a controlled queue depth.

Port of ``repro/serving/driver.py``. Benchmarks need the queue depth pinned
(it IS the look-ahead window), so this driver paces admission directly:
before every serve, the backlog is topped up to ``depth`` micro-batches
behind the head. Per-request latency is stamped host-side around each
serve, after the bags are materialized on the host — the runtimes return
numpy bags, whose device-to-host copy synchronizes the device, so the
stamp covers the device work. The first ``warmup`` serves are excluded
from the hit aggregates: a cold scratchpad misses by construction.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np


def summarize_latencies(lat_s: List[float]) -> Dict[str, float]:
    """p50/p99/mean in milliseconds from per-serve second stamps."""
    if not lat_s:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
    a = np.asarray(lat_s) * 1e3
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
    }


def replay_serving(
    backend,
    batches,
    *,
    depth: int = 0,
    warmup: Optional[int] = None,
    collect_bags: bool = False,
) -> Dict[str, Any]:
    """Serve every (R, T, L) id micro-batch in ``batches`` with the backend
    queue held at ``depth`` entries behind the head.

    Returns a result dict: per-serve ``latencies_s`` (serve critical path
    only — queue wait is a load property, not a runtime property),
    ``hit_rate`` / ``hit_lookup_rate`` / ``emergency_rate`` over the
    post-warmup serves, ``lookups_per_s``, ``stats`` (all StepStats), and
    optionally the served ``bags`` for parity checks.
    """
    batches = list(batches)
    if warmup is None:
        warmup = min(max(depth, 2), max(len(batches) - 1, 0))
    it = iter(batches)
    backlog = 0
    for ids in it:
        backend.enqueue(np.asarray(ids))
        backlog += 1
        if backlog > depth:
            break

    latencies: List[float] = []
    stats = []
    bags_out = []
    t_run0 = time.perf_counter()
    while backend.pending:
        t0 = time.perf_counter()
        bags, st, _tag = backend.serve_next()
        bags = np.asarray(bags)  # materialized on host before stamping
        latencies.append(time.perf_counter() - t0)
        stats.append(st)
        if collect_bags:
            bags_out.append(bags)
        for ids in it:  # top the backlog back up to ``depth``
            backend.enqueue(np.asarray(ids))
            break
    wall_s = time.perf_counter() - t_run0

    warm = stats[warmup:] if len(stats) > warmup else stats
    n_unique = sum(s.n_unique for s in warm)
    n_lookups = sum(s.n_lookups for s in warm)
    total_lookups = sum(s.n_lookups for s in stats)
    out: Dict[str, Any] = {
        "depth": int(depth),
        "served": len(stats),
        "warmup": int(min(warmup, len(stats))),
        "latencies_s": latencies,
        "latency": summarize_latencies(latencies[warmup:] or latencies),
        "hit_rate": sum(s.n_hits for s in warm) / max(n_unique, 1),
        "hit_lookup_rate": sum(s.hit_lookups for s in warm) / max(n_lookups, 1),
        "emergency_rate": sum(s.n_miss for s in warm) / max(n_unique, 1),
        "lookups_per_s": total_lookups / max(wall_s, 1e-9),
        "wall_s": wall_s,
        "stats": stats,
    }
    if collect_bags:
        out["bags"] = bags_out
    return out
