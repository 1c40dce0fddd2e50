"""Telemetry of the port (zero-dependency, strictly opt-in).

Port of ``repro/obs``. Two primitives, one install point:

  * :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters / gauges /
    histograms with a structured JSONL snapshot export
    (``schema obs_metrics/v1``, the reference's);
  * :class:`~repro_torch.obs.tracing.Tracer` — span-based stage tracing
    across every thread that does pipeline work (main, overlapped host
    worker, d2h thread, serving front end, replay prefetcher), exported as
    Chrome trace-event JSON loadable in Perfetto / ``chrome://tracing``.

The OFF path is the default everywhere: runtimes take ``tracer=None,
metrics=None`` and fall back to the process-global install below, which is
also ``None`` unless a launcher opted in (``--metrics-out`` /
``--trace-out``). With both unset the hot loop touches a shared null span
and a couple of ``is None`` branches. Telemetry reads pipeline state and
never writes it, so a traced run is bitwise equal to an untraced one.
``python -m repro_torch.obs.check`` validates the two artifacts.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracing import NULL_SPAN, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "Tracer",
    "install",
    "get_tracer",
    "get_metrics",
    "resolve",
]

# Process-global opt-in point. Threaded components that are not built
# through a runtime constructor (the trace-replay prefetcher, the serving
# front end) pick their tracer up from here, so one install() call at the
# launcher covers every thread in the process.
_tracer: Optional[Tracer] = None
_metrics: Optional[MetricsRegistry] = None


def install(
    tracer: Optional[Tracer] = None, metrics: Optional[MetricsRegistry] = None
) -> None:
    """Set (or clear, with Nones) the process-global tracer/metrics pair."""
    global _tracer, _metrics
    _tracer = tracer
    _metrics = metrics


def get_tracer() -> Optional[Tracer]:
    return _tracer


def get_metrics() -> Optional[MetricsRegistry]:
    return _metrics


def resolve(
    tracer: Optional[Tracer], metrics: Optional[MetricsRegistry]
) -> Tuple[Optional[Tracer], Optional[MetricsRegistry]]:
    """Constructor-side resolution: an explicit argument wins; ``None``
    falls back to the global install (still ``None`` when nothing opted
    in). Resolution happens ONCE at construction — never per cycle."""
    return (
        tracer if tracer is not None else _tracer,
        metrics if metrics is not None else _metrics,
    )
