"""Metrics registry: counters, gauges, histograms + JSONL snapshot export.

Port of ``repro/obs/metrics.py``, copied unchanged (pure Python): the
JSONL snapshots of the two packages have one schema, and each package's
validator reads the other's.

Design constraints (the telemetry tentpole's contract):

  * **Zero hot-path cost when off.** Instruments are plain objects a
    runtime holds only when a registry was passed in; the off path never
    touches this module after import.
  * **Cheap when on.** ``Counter.inc`` is one lock + one int add (~100 ns);
    ``Histogram.observe`` is a log2 bucket index. Byte counters are NOT
    duplicated here — the runtimes already keep unconditional
    ``HostTraffic`` totals, which a :class:`Gauge` reads lazily through its
    ``fn`` callback at snapshot time, so traffic metrics cost nothing per
    cycle even when metrics are on.
  * **Thread-correct.** Counters/histograms take a lock (the overlapped
    executor's workers and the serving front-end increment from their own
    threads); gauges are read-only probes evaluated at snapshot time.

Snapshot format (``write_jsonl``): one JSON object per line. The first
line is a meta header ``{"schema": "obs_metrics/v1", "kind": "meta", ...}``
carrying caller provenance; every following line is one instrument with
``kind`` / ``name`` / ``labels`` and its values. Validated by
``repro_torch.obs.check.validate_metrics_jsonl``.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

SCHEMA = "obs_metrics/v1"

# Histogram buckets: value v lands in bucket floor(log2(v)) + 1 (bucket 0
# holds v < 1). 64 buckets cover the full int64 range — enough for
# microsecond latencies from sub-µs to weeks.
_NUM_BUCKETS = 64


class Counter:
    """Monotone counter (thread-safe)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> dict:
        return {
            "kind": "counter",
            "name": self.name,
            "labels": self.labels,
            "value": self._value,
        }


class Gauge:
    """Point-in-time value: either ``set()`` explicitly or backed by a
    zero-argument ``fn`` probe evaluated lazily at snapshot time (the
    mechanism that turns the runtimes' existing unconditional byte counters
    into metrics with no per-cycle cost)."""

    __slots__ = ("name", "labels", "fn", "_value")

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        fn: Optional[Callable[[], Any]] = None,
    ):
        self.name = name
        self.labels = labels
        self.fn = fn
        self._value: Any = None

    def set(self, value: Any) -> None:
        self._value = value

    @property
    def value(self) -> Any:
        if self.fn is not None:
            return self.fn()
        return self._value

    def snapshot(self) -> dict:
        try:
            v = self.value
        except Exception as e:  # a probe must never kill the snapshot
            return {
                "kind": "gauge",
                "name": self.name,
                "labels": self.labels,
                "value": None,
                "error": f"{type(e).__name__}: {e}",
            }
        if v is not None:
            v = float(v) if isinstance(v, float) else int(v)
        return {
            "kind": "gauge",
            "name": self.name,
            "labels": self.labels,
            "value": v,
        }


class Histogram:
    """Log2-bucketed histogram with count/sum/min/max and estimated
    percentiles. ``unit`` is descriptive only (the serve-latency histogram
    observes microseconds). Preallocated buckets — ``observe`` allocates
    nothing."""

    __slots__ = ("name", "labels", "unit", "_buckets", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: Dict[str, str], unit: str = "us"):
        self.name = name
        self.labels = labels
        self.unit = unit
        self._buckets = [0] * _NUM_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    @staticmethod
    def _bucket_of(v: float) -> int:
        iv = int(v)
        if iv < 1:
            return 0
        return min(_NUM_BUCKETS - 1, iv.bit_length())

    def observe(self, v: float) -> None:
        b = self._bucket_of(v)
        with self._lock:
            self._buckets[b] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, p: float) -> Optional[float]:
        """Upper bucket-edge estimate of the p-th percentile (0..100)."""
        if self._count == 0:
            return None
        target = max(1, int(round(self._count * p / 100.0)))
        seen = 0
        for b, n in enumerate(self._buckets):
            seen += n
            if seen >= target:
                return float(1 << b)  # upper edge of bucket b
        return float(self._max)

    def snapshot(self) -> dict:
        return {
            "kind": "histogram",
            "name": self.name,
            "labels": self.labels,
            "unit": self.unit,
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "buckets": list(self._buckets),
        }


def _label_key(name: str, labels: Dict[str, str]) -> Tuple:
    return (name,) + tuple(sorted(labels.items()))


class MetricsRegistry:
    """Get-or-create registry keyed on (name, sorted labels). Repeated
    ``counter(...)`` calls with the same identity return the SAME cell, so
    instruments can be created eagerly at construction and incremented
    without lookups on the hot path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, Any] = {}

    def _get_or_create(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (cls.__name__,) + _label_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(
        self, name: str, fn: Optional[Callable[[], Any]] = None, **labels: str
    ) -> Gauge:
        g = self._get_or_create(Gauge, name, labels)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, unit: str = "us", **labels: str) -> Histogram:
        return self._get_or_create(Histogram, name, labels, unit=unit)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> List[dict]:
        with self._lock:
            metrics = list(self._metrics.values())
        return [m.snapshot() for m in metrics]

    def write_jsonl(
        self, path: str, provenance: Optional[dict] = None
    ) -> List[dict]:
        """Export one meta header line + one line per instrument. Returns
        the snapshot records (header excluded) for callers that also want
        the values in-process."""
        records = self.snapshot()
        header = {
            "schema": SCHEMA,
            "kind": "meta",
            "created_unix": time.time(),
            "num_metrics": len(records),
            "provenance": provenance or {},
        }
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for r in records:
                f.write(json.dumps(r) + "\n")
        return records
