"""Workload trace subsystem: recorded traces, non-stationary scenario
generators, and a streaming prefetched lookahead source.

Port of ``repro/traces`` (numpy only; traces are byte-compatible with the
reference's in both directions). The always-hit guarantee (paper §IV-A)
rests on the dataset recording future sparse ids — this package makes
workloads first-class artifacts:

    format      sharded, mmap-able binary trace format (+ manifest header)
    recorder    TraceRecorder: snapshot any (ids, batch) generator
    replay      TraceReplayStream: lookahead replay w/ background prefetch
    scenarios   drift / flash_crowd / diurnal / cold_start generators
    profiling   static-cache provisioning from a trace prefix
    criteo      Criteo-TSV ingestion into the trace format
"""
from repro_torch.traces.format import TraceMeta, TraceReader, TraceWriter
from repro_torch.traces.profiling import (
    derive_pad_buckets,
    hot_ids_from_trace,
    profile_hot_ids,
)
from repro_torch.traces.recorder import (
    TraceRecorder,
    record_serving_trace,
    record_trace,
)
from repro_torch.traces.replay import TraceReplayStream
from repro_torch.traces.scenarios import (
    SCENARIOS,
    available_scenarios,
    scenario_batches,
)

__all__ = [
    "TraceMeta",
    "TraceReader",
    "TraceWriter",
    "TraceRecorder",
    "TraceReplayStream",
    "record_trace",
    "record_serving_trace",
    "scenario_batches",
    "available_scenarios",
    "SCENARIOS",
    "profile_hot_ids",
    "hot_ids_from_trace",
    "derive_pad_buckets",
]
