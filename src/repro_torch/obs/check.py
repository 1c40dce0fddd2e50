"""Schema validators for the telemetry artifacts (+ a tiny CLI).

Port of ``repro/obs/check.py``, copied unchanged (pure Python); it accepts
and rejects the same files as the reference's validators:

    python -m repro_torch.obs.check --trace t.json --metrics m.jsonl --min-threads 3

Exit status 0 iff every named artifact validates.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.obs.metrics import SCHEMA as METRICS_SCHEMA

_KINDS = {"counter", "gauge", "histogram"}


def validate_chrome_trace(path: str, min_threads: int = 1) -> List[str]:
    """Return a list of problems (empty == valid).

    Checks: well-formed JSON with a ``traceEvents`` list; every event has
    ph/pid/tid/ts fields as appropriate; per-tid timestamps are monotone
    non-decreasing; B/E events are balanced per tid; at least
    ``min_threads`` distinct tids carry at least one B event.
    """
    problems: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except Exception as e:
        return [f"unreadable JSON: {type(e).__name__}: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    last_ts = {}
    depth = {}
    threads_with_spans = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("B", "E", "I", "M"):
            problems.append(f"event {i}: unknown ph {ph!r}")
            continue
        tid = ev.get("tid")
        if tid is None:
            problems.append(f"event {i}: missing tid")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: missing/invalid ts")
            continue
        if ts < last_ts.get(tid, 0.0):
            problems.append(
                f"event {i}: tid {tid} ts {ts} < previous {last_ts[tid]}"
            )
        last_ts[tid] = ts
        if ph == "B":
            if "name" not in ev:
                problems.append(f"event {i}: B without name")
            depth[tid] = depth.get(tid, 0) + 1
            threads_with_spans.add(tid)
        elif ph == "E":
            depth[tid] = depth.get(tid, 0) - 1
            if depth[tid] < 0:
                problems.append(f"event {i}: tid {tid} E without matching B")
    for tid, d in depth.items():
        if d > 0:
            problems.append(f"tid {tid}: {d} unbalanced B event(s)")
    if len(threads_with_spans) < min_threads:
        problems.append(
            f"only {len(threads_with_spans)} thread(s) carry spans, "
            f"need >= {min_threads}"
        )
    return problems


def validate_metrics_jsonl(path: str) -> List[str]:
    """Return a list of problems (empty == valid) for an obs_metrics/v1
    JSONL snapshot: meta header first, then one record per instrument with
    kind/name/labels and kind-appropriate value fields."""
    problems: List[str] = []
    try:
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    except Exception as e:
        return [f"unreadable file: {type(e).__name__}: {e}"]
    if not lines:
        return ["empty file"]
    records = []
    for i, ln in enumerate(lines):
        try:
            records.append(json.loads(ln))
        except Exception as e:
            problems.append(f"line {i}: invalid JSON: {e}")
    if problems:
        return problems
    head = records[0]
    if head.get("schema") != METRICS_SCHEMA or head.get("kind") != "meta":
        problems.append(
            f"line 0: expected meta header with schema {METRICS_SCHEMA!r}"
        )
    elif head.get("num_metrics") != len(records) - 1:
        problems.append(
            f"header num_metrics {head.get('num_metrics')} != "
            f"{len(records) - 1} records"
        )
    for i, r in enumerate(records[1:], start=1):
        kind = r.get("kind")
        if kind not in _KINDS:
            problems.append(f"line {i}: unknown kind {kind!r}")
            continue
        if not isinstance(r.get("name"), str):
            problems.append(f"line {i}: missing name")
        if not isinstance(r.get("labels"), dict):
            problems.append(f"line {i}: missing labels")
        if kind == "counter":
            if not isinstance(r.get("value"), int):
                problems.append(f"line {i}: counter value must be int")
        elif kind == "histogram":
            if not isinstance(r.get("count"), int) or not isinstance(
                r.get("buckets"), list
            ):
                problems.append(f"line {i}: histogram needs count + buckets")
        elif kind == "gauge":
            v = r.get("value")
            if v is not None and not isinstance(v, (int, float)):
                problems.append(f"line {i}: gauge value must be numeric/null")
    return problems


def _report(label: str, problems: List[str]) -> bool:
    if problems:
        print(f"FAIL {label}:")
        for p in problems:
            print(f"  - {p}")
        return False
    print(f"OK   {label}")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Validate telemetry artifacts")
    ap.add_argument("--trace", help="Chrome trace-event JSON file")
    ap.add_argument("--metrics", help="obs_metrics/v1 JSONL file")
    ap.add_argument(
        "--min-threads",
        type=int,
        default=1,
        help="minimum distinct threads that must carry spans in --trace",
    )
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("nothing to check: pass --trace and/or --metrics")
    ok = True
    if args.trace:
        ok &= _report(
            f"trace {args.trace}",
            validate_chrome_trace(args.trace, min_threads=args.min_threads),
        )
    if args.metrics:
        ok &= _report(
            f"metrics {args.metrics}", validate_metrics_jsonl(args.metrics)
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
