"""Offline workload profiling: provision a static top-N cache from a trace
prefix — exactly how a deployed static cache is built, and exactly why it
decays under the non-stationary scenarios (the profile freezes a moment of
a moving distribution) — and derive the pipeline's adaptive pad-bucket set
from a trace's measured miss-count distribution.

Port of ``repro/traces/profiling.py`` (numpy only): the same trace gives
the same hot ids and the same pad buckets in both packages
(``derive_pad_buckets`` runs the port's numpy :class:`Planner`). Its
caller, ``--adaptive-pad``, is not ported yet (ROADMAP.md Queue 1 item 10):
the port's runtimes take no ``pad_buckets`` for training.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.table_group import TableGroup
from repro_torch.traces.format import TraceReader


def profile_hot_ids(
    id_batches: Iterable[np.ndarray],
    group: TableGroup,
    fraction: float,
) -> np.ndarray:
    """Per-table top-N hottest GLOBAL row ids measured over ``id_batches``
    (an iterable of global-id arrays or ``(ids, payload)`` items). Each
    table gets its own pinned budget (``rows * fraction``); only rows
    actually observed are pinned."""
    counts = [np.zeros(spec.rows, dtype=np.int64) for spec in group.tables]
    for item in id_batches:
        ids = item[0] if isinstance(item, tuple) else item
        for t, local in enumerate(group.split(np.asarray(ids))):
            np.add.at(counts[t], local, 1)
    out = []
    for t, spec in enumerate(group.tables):
        budget = max(1, int(spec.rows * fraction))
        observed = int(np.count_nonzero(counts[t]))
        n_pin = min(budget, observed)
        if n_pin == 0:
            continue
        top = np.argpartition(counts[t], -n_pin)[-n_pin:]
        out.append(group.to_global(t, top))
    if not out:
        raise ValueError("profiling window observed no lookups")
    return np.concatenate(out)


def hot_ids_from_trace(
    trace: Union[str, TraceReader],
    fraction: float,
    *,
    profile_batches: int,
) -> np.ndarray:
    """Provision static-cache hot ids from the first ``profile_batches``
    batches of a recorded trace (the offline profiling pass)."""
    reader = trace if isinstance(trace, TraceReader) else TraceReader(trace)
    n = min(profile_batches, reader.num_batches)
    if n <= 0:
        raise ValueError("trace has no batches to profile")
    return profile_hot_ids(
        (reader.global_ids(i) for i in range(n)), reader.group, fraction
    )


def derive_pad_buckets(
    trace: Union[str, TraceReader],
    num_slots: int,
    *,
    past_window: int = 3,
    future_window: int = 2,
    profile_batches: Optional[int] = None,
    quantiles: Sequence[float] = (0.5, 0.9, 0.99),
    align: int = 8,
    max_buckets: int = 5,
) -> Tuple[int, ...]:
    """Adaptive fill/evict pad-bucket set from a recorded trace's measured
    miss-count distribution (ROADMAP "adaptive pad buckets").

    The pipeline's default pow-2/256-floor padding trades wasted lanes for a
    bounded executable set without knowing the workload; a recorded trace
    gives the EXACT per-cycle miss/evict counts, so the bucket set can hug
    the distribution instead: one bucket per requested quantile (rounded up
    to ``align``) plus one at the observed maximum. Pass the result as
    ``ScratchPipe(pad_buckets=...)`` — operands beyond the largest bucket
    (a workload shift the profile never saw) fall back to pow-2 padding, so
    the override is never a correctness cliff.

    The distribution is measured by replaying the trace's id stream through
    a host ``Planner`` with a single all-covering slot range — per-table
    budget splits shift a few victims between tables but not the aggregate
    operand sizes this estimates."""
    from repro_torch.core.plan import Planner

    reader = trace if isinstance(trace, TraceReader) else TraceReader(trace)
    n = reader.num_batches if profile_batches is None else min(
        int(profile_batches), reader.num_batches
    )
    if n <= 0:
        raise ValueError("trace has no batches to profile")
    planner = Planner(
        reader.group.total_rows,
        int(num_slots),
        past_window=past_window,
        future_window=future_window,
    )
    # sliding window over the trace: only future_window+1 batches resident
    # at once (a multi-GB trace must not materialize up front)
    import collections

    window: "collections.deque" = collections.deque()
    next_idx = 0
    while len(window) < future_window + 1 and next_idx < n:
        window.append(reader.global_ids(next_idx))
        next_idx += 1
    counts = []
    for _ in range(n):
        ids = window.popleft()
        if next_idx < n:
            window.append(reader.global_ids(next_idx))
            next_idx += 1
        r = planner.plan(ids, list(window)[:future_window])
        counts.append(int(r.miss_ids.size))
        counts.append(int(r.evict_slots.size))
    nz = np.asarray([c for c in counts if c > 0], dtype=np.int64)
    if nz.size == 0:
        return ()  # never misses: every dispatch is skipped anyway
    marks = [float(np.quantile(nz, q)) for q in quantiles] + [float(nz.max())]
    buckets = sorted(
        {int(-(-m // align) * align) for m in marks if m > 0}
    )
    return tuple(buckets[-max_buckets:])
