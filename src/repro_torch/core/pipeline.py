"""Per-cycle statistics shared by the cache runtimes.

Port of ``StepStats`` and ``_PLAN_FIELDS`` from ``repro/core/pipeline.py``:
the serving runtimes import them. The training pipeline (``ScratchPipe``)
comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class StepStats:
    step: int
    n_lookups: int
    n_unique: int
    n_hits: int
    n_miss: int
    n_evict: int
    hit_lookups: int = 0  # lookup-level (non-unique) hit count
    by_table: Any = None  # per-table {hits, misses} (multi-table runs only)
    # main-thread seconds per stage (kept for field parity with the
    # reference; the serving runtimes leave it None)
    stage_times: Optional[Dict[str, float]] = None
    aux: Any = None

    @property
    def hit_rate(self) -> float:
        return self.n_hits / max(self.n_unique, 1)


#: PlanResult fields that describe one planned micro-batch (the reference
#: serializes these per in-flight entry in its checkpoints).
_PLAN_FIELDS = (
    "step", "slots", "miss_ids", "fill_slots", "evict_slots", "evict_ids",
    "n_unique", "n_hits", "hits_by_table", "misses_by_table",
)
