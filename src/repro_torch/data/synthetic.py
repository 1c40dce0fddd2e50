"""Zipf id sampling for the synthetic traffic scenarios (paper §V Benchmarks).

Port of the part of ``repro/data/synthetic.py`` that the scenarios import
(``LOCALITY_S``, ``zipf_ranks``, ``sample_ids_s``, ``scatter_ranks``),
copied unchanged: numpy only, so the same generator state draws the same
ids in both packages.

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

import math
from typing import Dict

import numpy as np

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
