"""Straggler detection & mitigation.

Port of ``repro/runtime/straggler.py`` (pure numpy, copied). In a
synchronous SPMD job one slow host stalls every collective, so the
mitigations are (a) detect persistent stragglers from per-host step times,
(b) rebalance input shards away from them (data-parallel work is the only
freely movable quantity), and (c) at extreme scale, drop-and-replace the
host (the elastic restart path, ``runtime/elastic.py``).

The detection/rebalancing logic is pure and unit-tested; the wall-clock
feed would come from per-host heartbeats in a real deployment (one card
has one host: nothing feeds it here).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    ema_alpha: float = 0.1
    slow_factor: float = 1.3  # flagged when EMA > factor * median
    min_samples: int = 8


class StepTimeMonitor:
    """Tracks per-host step-time EMAs and flags persistent stragglers."""

    def __init__(self, num_hosts: int, policy: StragglerPolicy = StragglerPolicy()):
        self.policy = policy
        self.ema = np.zeros(num_hosts)
        self.count = np.zeros(num_hosts, dtype=np.int64)

    def observe(self, host_times: np.ndarray):
        a = self.policy.ema_alpha
        fresh = self.count == 0
        self.ema = np.where(fresh, host_times, (1 - a) * self.ema + a * host_times)
        self.count += 1

    def stragglers(self) -> List[int]:
        if self.count.size == 0 or int(self.count.min()) < self.policy.min_samples:
            return []
        med = float(np.median(self.ema))
        return [
            i for i, t in enumerate(self.ema) if t > self.policy.slow_factor * med
        ]


def plan_rebalance(
    ema_times: np.ndarray, shards_per_host: np.ndarray
) -> np.ndarray:
    """Re-assign data shards so per-host (time-per-shard * shards) equalizes.

    Returns the new integer shard allocation with the same total. Hosts whose
    throughput (1/time) is higher receive proportionally more shards."""
    total = int(shards_per_host.sum())
    speed = 1.0 / np.maximum(ema_times, 1e-9)
    ideal = speed / speed.sum() * total
    alloc = np.floor(ideal).astype(np.int64)
    # distribute the remainder to the largest fractional parts
    rem = total - int(alloc.sum())
    order = np.argsort(-(ideal - alloc))
    alloc[order[:rem]] += 1
    return alloc
