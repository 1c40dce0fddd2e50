"""EmbeddingCacheRuntime: the protocol all cache runtimes satisfy, plus a
name -> factory registry so launchers select designs uniformly.

Port of ``repro/core/runtime.py``. The port registers, so far, the
paper's training designs and the read-only serving designs:

    nocache      — hybrid CPU-GPU, no caching (Fig. 4(a))
    static       — Yin et al. pinned top-N cache (Fig. 4(b))
    scratchpipe  — the paper's pipelined always-hit cache (§IV)
    strawman     — dynamic cache, no pipelining (§IV-B)
    nocache-serve      — the serving oracle (host gather every lookup)
    static-serve       — pinned profiled hot rows, misses in a transient tail
    scratchpipe-serve  — the plan-ahead cache with the queue as look-ahead
                         (fp32, fp16 or int8 replicas)

Every factory takes ``(host_table, train_fn, **kwargs)``; serving
factories require ``train_fn=None`` — they never write back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Protocol, Tuple

import numpy as np

from repro_torch.core.host_table import HostTraffic


class EmbeddingCacheRuntime(Protocol):
    """What benchmarks and launchers program against."""

    def run(self, stream: Iterator[Tuple[np.ndarray, Any]], lookahead_fn=None) -> List:
        """Drive the runtime over a (ids, batch) stream; per-step stats."""
        ...

    def run_one_cycle(self, ids, batch, lookahead_fn=None):
        """Admit one mini-batch and advance one pipeline cycle.
        Unpipelined designs complete the step immediately."""
        ...

    def flush_to_host(self) -> None:
        """Write all device-resident (dirty) rows back to the host tier."""
        ...

    @property
    def stats(self) -> List:
        """Per-step StepStats in completion order."""
        ...

    def traffic(self) -> Dict[str, HostTraffic]:
        """Byte counters per memory tier/link: host, pcie, hbm."""
        ...


_REGISTRY: Dict[str, Callable[..., EmbeddingCacheRuntime]] = {}


def register_runtime(name: str):
    """Class/factory decorator adding a runtime design to the registry."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"runtime {name!r} registered twice")
        _REGISTRY[name] = factory
        return factory

    return deco


def _ensure_registered() -> None:
    # importing the modules runs their @register_runtime decorators
    from repro_torch.core import (  # noqa: F401
        pipeline,
        serving_cache,
        static_cache,
    )


def available_runtimes() -> List[str]:
    _ensure_registered()
    return sorted(_REGISTRY)


def make_runtime(name: str, host_table, train_fn, **kwargs) -> EmbeddingCacheRuntime:
    """Instantiate a registered cache runtime by name."""
    _ensure_registered()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown cache runtime {name!r}; available: {available_runtimes()}"
        )
    return _REGISTRY[name](host_table, train_fn, **kwargs)
