"""Dispatch/traffic accounting of the port's steps.

Port of ``repro/launch/hlo_stats.py``. Three tools live here:

  * collective accounting — :func:`collective_stats` returns the
    reference's dict shape (``{kind: {"count", "bytes_in", "bytes_out"},
    "total": {...}}``, bytes per rank) from the records that
    ``parallel/collectives.py`` keeps of every collective a rank ran.
    Torch compiles no SPMD module, so there is no HLO text to parse: the
    reference's HLO parser (``_shape_bytes``, the op and symbol regexes)
    is not ported;
  * op accounting — :func:`op_counts` runs a function under a
    ``TorchDispatchMode`` and counts the aten ops it dispatches by name
    (the counterpart of ``jaxpr_primitive_counts``, which walks a traced
    jaxpr);
  * launch accounting — :func:`kernel_launch_count` counts the launches of
    the port's hand-written kernels one call makes, from ``kernels/ops.py:
    launch_counts`` (the counterpart of ``pallas_launch_count``). A launch
    is counted where the CUDA kernel runs, so on the CPU (the plain
    versions) it reads 0.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict


def collective_stats(records: Dict[str, Dict[str, int]] = None) -> Dict[str, Dict[str, float]]:
    """Returns {op_kind: {"count": n, "bytes_in": b, "bytes_out": b}} plus a
    "total" entry, from ``records`` (by default this rank's records since
    ``collectives.reset_collective_records()``)."""
    from repro_torch.parallel import collectives

    out = dict(collectives.collective_records() if records is None else records)
    out["total"] = {k: sum(r[k] for r in out.values())
                    for k in ("count", "bytes_in", "bytes_out")}
    return out


def collective_bytes(records: Dict[str, Dict[str, int]] = None) -> int:
    """The roofline's collective numerator: the bytes into this rank's
    collectives."""
    return int(collective_stats(records)["total"]["bytes_in"])


def op_counts(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and count the aten ops it dispatches by
    name ("aten.mm", ...), the backward's included when ``fn`` runs one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts: Dict[str, int] = defaultdict(int)

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        fn(*args, **kwargs)
    return dict(counts)


def kernel_launch_counts(fn, *args, **kwargs) -> Dict[str, int]:
    """The launches of each hand-written kernel during one call of ``fn``
    (the counters are read before and after, not reset)."""
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    fn(*args, **kwargs)
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def kernel_launch_count(fn, *args, **kwargs) -> int:
    """Number of hand-written kernel launches one call of ``fn`` makes."""
    return sum(kernel_launch_counts(fn, *args, **kwargs).values())
