"""Synthetic embedding-access trace generator (paper §V Benchmarks).

Port of ``repro/data/synthetic.py``, copied unchanged: numpy only, so the
same seed draws the same ids, dense features and labels in both packages
(tests/test_torch_train.py, and tests/test_torch_table_group.py for the
heterogeneous tables of ``dlrm_batches_group``).

Ranks come from a Zipf(s) distribution via the continuous inverse-CDF
(rank = N * u^(1/(1-s))), with s calibrated so the top-2% of rows capture
the paper's reported traffic shares:

    locality   top-2% traffic share     s
    random     2.0% (uniform)           0.0
    low        ~8.5%  (Alibaba)         0.37
    medium     ~40%                     0.77
    high       ~80%+  (Criteo)          0.95

Ranks are scattered over the id space with a bijective multiplicative hash
so "hot" rows are not contiguous.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.table_group import TableGroup

LOCALITY_S: Dict[str, float] = {
    "random": 0.0,
    "low": 0.37,
    "medium": 0.77,
    "high": 0.95,
}

_SCATTER_PRIME = 2_654_435_761  # Knuth multiplicative hash


def _coprime_scatter(ranks: np.ndarray, n: int) -> np.ndarray:
    """Bijective rank->id map when gcd(prime, n) == 1 (adjust if needed)."""
    p = _SCATTER_PRIME
    while math.gcd(p, n) != 1:
        p += 2
    return (ranks.astype(np.int64) * p) % n


# public alias: the non-stationary scenario generators manipulate ranks
# directly (rotation, frontier growth) before scattering
scatter_ranks = _coprime_scatter


def zipf_ranks(
    rng: np.random.Generator, n_rows: int, size, s: float
) -> np.ndarray:
    """Zipf(s) popularity ranks via the continuous inverse-CDF (rank 0 is
    the hottest). ``s <= 0`` degenerates to uniform."""
    if s <= 0.0:
        return rng.integers(0, n_rows, size=size, dtype=np.int64)
    u = rng.random(size=size)
    return np.minimum(
        (n_rows * u ** (1.0 / (1.0 - s))).astype(np.int64), n_rows - 1
    )


def sample_ids_s(
    rng: np.random.Generator, n_rows: int, size, s: float
) -> np.ndarray:
    """Zipf ids parameterized by the raw exponent ``s`` — the continuous
    knob the diurnal-oscillation scenario sweeps."""
    ranks = zipf_ranks(rng, n_rows, size, s)
    if s <= 0.0:
        return ranks  # uniform ranks are already ids
    return _coprime_scatter(ranks, n_rows)


def sample_ids(
    rng: np.random.Generator, n_rows: int, size, locality: str
) -> np.ndarray:
    return sample_ids_s(rng, n_rows, size, LOCALITY_S[locality])


@dataclasses.dataclass
class TraceConfig:
    num_tables: int = 8
    rows_per_table: int = 10_000_000
    lookups_per_table: int = 20
    batch_size: int = 2048
    locality: str = "medium"
    num_dense_features: int = 13
    seed: int = 0


def dlrm_batches(tc: TraceConfig, steps: int) -> Iterator[Tuple[np.ndarray, dict]]:
    """Yields (global_row_ids (B, T, L), batch payload). Row ids are already
    offset into the flattened (T * rows) global space used by the cache
    controller and the full-table model."""
    rng = np.random.default_rng(tc.seed)
    offs = (np.arange(tc.num_tables, dtype=np.int64) * tc.rows_per_table)[
        None, :, None
    ]
    for _ in range(steps):
        ids = sample_ids(
            rng,
            tc.rows_per_table,
            (tc.batch_size, tc.num_tables, tc.lookups_per_table),
            tc.locality,
        )
        gids = ids + offs
        dense = rng.standard_normal(
            (tc.batch_size, tc.num_dense_features)
        ).astype(np.float32)
        # CTR label correlated with the dense features (learnable signal)
        logits = dense[:, 0] - 0.5 * dense[:, 1]
        label = (rng.random(tc.batch_size) < 1.0 / (1.0 + np.exp(-logits))).astype(
            np.float32
        )
        yield gids, {"dense": dense, "label": label, "sparse_ids": ids}


def dlrm_batches_group(
    group: TableGroup,
    steps: int,
    *,
    batch_size: int = 2048,
    lookups_per_table: int = 20,
    locality: str = "medium",
    num_dense_features: int = 13,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, dict]]:
    """Multi-table trace over a TableGroup with HETEROGENEOUS row counts:
    each table's lookup stream is sampled from its own Zipf over its own row
    space (the per-table access streams BagPipe/Fang et al. cache against).
    Yields (global_row_ids (B, T, L), payload); ``payload["sparse_ids"]``
    keeps the per-table LOCAL ids (what the full-table model consumes)."""
    rng = np.random.default_rng(seed)
    T = group.num_tables
    for _ in range(steps):
        local = np.stack(
            [
                sample_ids(
                    rng,
                    group.tables[t].rows,
                    (batch_size, lookups_per_table),
                    locality,
                )
                for t in range(T)
            ],
            axis=1,
        )  # (B, T, L)
        gids = group.globalize(local)
        dense = rng.standard_normal(
            (batch_size, num_dense_features)
        ).astype(np.float32)
        logits = dense[:, 0] - 0.5 * dense[:, 1]
        label = (rng.random(batch_size) < 1.0 / (1.0 + np.exp(-logits))).astype(
            np.float32
        )
        yield gids, {"dense": dense, "label": label, "sparse_ids": local}


def hot_ids_for_group(
    group: TableGroup, fraction: float, *, locality: str = "medium",
    draws_per_table: int = 200_000, seed: int = 99,
) -> np.ndarray:
    """Per-table top-N hottest GLOBAL row ids for the static-cache baseline:
    every table gets its own pinned budget (``rows * fraction``), estimated
    from an offline profiling pass over its own lookup stream. The profile
    scales with the budget, and only rows actually observed are pinned
    (never-accessed zero-count ties would waste cache capacity)."""
    rng = np.random.default_rng(seed)
    out = []
    for t, spec in enumerate(group.tables):
        per_table = max(1, int(spec.rows * fraction))
        draws = max(draws_per_table, 4 * per_table)
        counts = np.zeros(spec.rows, dtype=np.int64)
        ids = sample_ids(rng, spec.rows, draws, locality)
        np.add.at(counts, ids, 1)
        observed = int(np.count_nonzero(counts))
        n_pin = min(per_table, observed)
        top = np.argpartition(counts, -n_pin)[-n_pin:]
        out.append(group.to_global(t, top))
    return np.concatenate(out)


def access_counts(tc: TraceConfig, steps: int) -> np.ndarray:
    """Sorted per-row access histogram (reproduces Fig. 3 curves)."""
    rng = np.random.default_rng(tc.seed)
    counts = np.zeros(tc.rows_per_table, dtype=np.int64)
    for _ in range(steps):
        ids = sample_ids(
            rng,
            tc.rows_per_table,
            tc.batch_size * tc.num_tables * tc.lookups_per_table,
            tc.locality,
        )
        np.add.at(counts, ids, 1)
    return np.sort(counts)[::-1]


def hot_ids_global(tc: TraceConfig, fraction: float, steps: int = 50) -> np.ndarray:
    """Top-N hottest *global* row ids (for the static-cache baseline),
    estimated from a profiling prefix — exactly how a deployed static cache
    would be provisioned."""
    rng = np.random.default_rng(tc.seed + 99)
    per_table = max(1, int(tc.rows_per_table * fraction))
    out = []
    for t in range(tc.num_tables):
        counts = np.zeros(tc.rows_per_table, dtype=np.int64)
        ids = sample_ids(
            rng,
            tc.rows_per_table,
            steps * tc.batch_size * tc.lookups_per_table,
            tc.locality,
        )
        np.add.at(counts, ids, 1)
        top = np.argpartition(counts, -per_table)[-per_table:]
        out.append(top.astype(np.int64) + t * tc.rows_per_table)
    return np.concatenate(out)
