"""Non-stationary workload scenarios: the drifting-hot-set regimes where a
statically provisioned cache collapses but ScratchPipe's look-ahead cache
must not (cf. the frequency-aware cache literature, arXiv:2208.05321).

Port of ``repro/traces/scenarios.py``, copied unchanged (numpy only): the
same seed gives the same ids in both packages (tests/test_torch_plan.py).

Every generator yields ``(global_ids (B, T, L), payload)`` items —
per-table id streams over a
:class:`~repro_torch.core.table_group.TableGroup` — so they drop into any
cache runtime.

Scenario catalog (select by name via :func:`scenario_batches`):

    drift        gradual hot-set rotation: the Zipf rank window slides
                 through the id space at ``drift_rate`` rows/step (as a
                 fraction of the table), so popularity leaks smoothly from
                 yesterday's hot items to tomorrow's.
    flash_crowd  periodic bursts: every ``period`` steps a small random
                 "crowd" set of previously cold items absorbs
                 ``burst_share`` of all lookups for ``burst_len`` steps
                 (breaking-news / flash-sale traffic).
    diurnal      locality oscillation: the Zipf exponent swings
                 sinusoidally between ``s_lo`` and ``s_hi`` with period
                 ``period`` — daytime concentration, nighttime long tail.
    cold_start   new-item injection: the active id frontier grows every
                 step and ``new_share`` of lookups target freshly launched
                 items that no profiling pass has ever seen.
    inference_mix
                 serving traffic: label-free request micro-batches blending
                 a stationary personalized head, a drifting trending
                 middle, and a uniform exploration tail — the id stream an
                 online recommender's lookup tier actually sees.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.core.table_group import TableGroup
from repro_torch.data.synthetic import (
    LOCALITY_S,
    sample_ids_s,
    scatter_ranks,
    zipf_ranks,
)


def _emit(
    rng: np.random.Generator,
    group: TableGroup,
    local: np.ndarray,
    num_dense_features: int,
) -> Tuple[np.ndarray, dict]:
    """(B, T, L) local ids -> the standard (gids, payload) item."""
    b = local.shape[0]
    gids = group.globalize(local)
    dense = rng.standard_normal((b, num_dense_features)).astype(np.float32)
    if num_dense_features >= 2:
        logits = dense[:, 0] - 0.5 * dense[:, 1]
    else:
        logits = np.zeros(b, dtype=np.float32)
    label = (rng.random(b) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return gids, {"dense": dense, "label": label, "sparse_ids": local}


def drift_batches(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",
    num_dense_features: int = 13,
    seed: int = 0,
    drift_rate: float = 0.002,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Gradual hot-set rotation. Each step the Zipf rank window shifts by
    ``drift_rate * rows`` positions before the rank->id scatter, so the hot
    head continuously sheds its coldest members and recruits new ones —
    after ``hot_width / drift_rate`` steps the original hot set is fully
    displaced. A static top-N cache provisioned from a profiling prefix
    decays at exactly that rate; a look-ahead cache tracks it for free."""
    s = LOCALITY_S[locality]
    rng = np.random.default_rng(seed)
    size = (batch_size, lookups_per_table)
    for t in range(steps):
        cols = []
        for spec in group.tables:
            shift = int(round(t * drift_rate * spec.rows))
            ranks = zipf_ranks(rng, spec.rows, size, s)
            cols.append(scatter_ranks((ranks + shift) % spec.rows, spec.rows))
        yield _emit(rng, group, np.stack(cols, axis=1), num_dense_features)


def flash_crowd_batches(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",
    num_dense_features: int = 13,
    seed: int = 0,
    period: int = 40,
    burst_len: int = 8,
    burst_share: float = 0.5,
    crowd_fraction: float = 0.002,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Flash-crowd bursts. Outside bursts the stream is the stationary Zipf;
    every ``period`` steps a fresh crowd of ``crowd_fraction * rows`` random
    (typically cold) rows soaks up ``burst_share`` of lookups for
    ``burst_len`` consecutive steps, then vanishes."""
    s = LOCALITY_S[locality]
    rng = np.random.default_rng(seed)
    size = (batch_size, lookups_per_table)
    crowds: List[np.ndarray] = [np.zeros(0, np.int64)] * group.num_tables
    for t in range(steps):
        in_burst = (t % period) < burst_len
        if in_burst and t % period == 0:
            crowds = [
                rng.integers(
                    0,
                    spec.rows,
                    size=max(1, int(spec.rows * crowd_fraction)),
                    dtype=np.int64,
                )
                for spec in group.tables
            ]
        cols = []
        for i, spec in enumerate(group.tables):
            base = sample_ids_s(rng, spec.rows, size, s)
            if in_burst:
                mask = rng.random(size) < burst_share
                pick = crowds[i][rng.integers(0, crowds[i].size, size=size)]
                base = np.where(mask, pick, base)
            cols.append(base)
        yield _emit(rng, group, np.stack(cols, axis=1), num_dense_features)


def diurnal_batches(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",  # unused: s oscillates between s_lo and s_hi
    num_dense_features: int = 13,
    seed: int = 0,
    period: int = 48,
    s_lo: float = LOCALITY_S["low"],
    s_hi: float = LOCALITY_S["high"],
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Diurnal locality oscillation: the Zipf exponent follows a sinusoid
    between ``s_lo`` (long-tail night traffic) and ``s_hi`` (concentrated
    peak-hour traffic) with period ``period`` steps. The working set
    breathes — any fixed cache size is wrong half the day."""
    del locality
    rng = np.random.default_rng(seed)
    size = (batch_size, lookups_per_table)
    for t in range(steps):
        phase = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / period))
        s_t = s_lo + (s_hi - s_lo) * phase
        cols = [
            sample_ids_s(rng, spec.rows, size, s_t) for spec in group.tables
        ]
        yield _emit(rng, group, np.stack(cols, axis=1), num_dense_features)


def cold_start_batches(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",
    num_dense_features: int = 13,
    seed: int = 0,
    active_fraction: float = 0.5,
    growth_per_step: float = 0.004,
    new_share: float = 0.25,
    recent_steps: int = 5,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Cold-start new-item injection. Only ``active_fraction`` of each
    table is live at t=0; every step another ``growth_per_step * rows``
    items launch, and ``new_share`` of lookups go to items launched within
    the last ``recent_steps`` steps — ids no offline profile has seen
    (the canonical new-content / new-user regime)."""
    s = LOCALITY_S[locality]
    rng = np.random.default_rng(seed)
    size = (batch_size, lookups_per_table)

    def frontier(spec_rows: int, t: int) -> int:
        f = active_fraction + growth_per_step * t
        return max(1, min(spec_rows, int(spec_rows * f)))

    for t in range(steps):
        cols = []
        for spec in group.tables:
            act = frontier(spec.rows, t)
            prev = frontier(spec.rows, max(0, t - recent_steps))
            ranks = zipf_ranks(rng, act, size, s)
            if act > prev and new_share > 0.0:
                mask = rng.random(size) < new_share
                fresh = rng.integers(prev, act, size=size, dtype=np.int64)
                ranks = np.where(mask, fresh, ranks)
            cols.append(scatter_ranks(ranks, spec.rows))
        yield _emit(rng, group, np.stack(cols, axis=1), num_dense_features)


def inference_mix_batches(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",
    num_dense_features: int = 0,  # serving requests carry no dense features
    seed: int = 0,
    trend_share: float = 0.3,
    explore_share: float = 0.05,
    trend_drift_rate: float = 0.01,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Online inference traffic: each lookup is drawn from a three-way mix —
    a stationary Zipf head (returning users' personalized rows), a
    ``trend_share`` slice from a FAST-drifting Zipf window (trending items,
    rotating ``trend_drift_rate * rows`` per step — an order of magnitude
    faster than the training ``drift`` scenario), and an ``explore_share``
    uniform tail (exploration / cold candidates). Payloads are label-free
    (no gradient will ever exist for a serving lookup); dense features
    default to none and the recorder's serving mode strips the payload to
    ids regardless."""
    s = LOCALITY_S[locality]
    rng = np.random.default_rng(seed)
    size = (batch_size, lookups_per_table)
    for t in range(steps):
        cols = []
        for spec in group.tables:
            head = sample_ids_s(rng, spec.rows, size, s)
            shift = int(round(t * trend_drift_rate * spec.rows))
            trend_ranks = zipf_ranks(rng, spec.rows, size, s)
            trend = scatter_ranks((trend_ranks + shift) % spec.rows, spec.rows)
            explore = rng.integers(0, spec.rows, size=size, dtype=np.int64)
            u = rng.random(size)
            ids = np.where(u < explore_share, explore, head)
            ids = np.where(
                (u >= explore_share) & (u < explore_share + trend_share),
                trend,
                ids,
            )
            cols.append(ids)
        yield _emit(rng, group, np.stack(cols, axis=1), num_dense_features)


SCENARIOS: Dict[str, Callable[..., Iterator]] = {
    "drift": drift_batches,
    "flash_crowd": flash_crowd_batches,
    "diurnal": diurnal_batches,
    "cold_start": cold_start_batches,
    "inference_mix": inference_mix_batches,
}


def available_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def scenario_batches(
    name: str, group: TableGroup, steps: int, **kw
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Instantiate a scenario generator by name (the ``--scenario`` path in
    launchers and benchmarks)."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; available: {available_scenarios()}"
        )
    return SCENARIOS[name](group, steps, **kw)
