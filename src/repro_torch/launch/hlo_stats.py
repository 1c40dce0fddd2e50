"""Dispatch/traffic accounting of the port's steps.

Port of ``repro/launch/hlo_stats.py``. Four tools live here:

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
    versions) it reads 0;
  * memory accounting — :class:`LiveBytes` follows the bytes of the
    storages a call allocates on one device type while they live, and
    their peak (the counterpart of the compiled program's
    ``memory_analysis()``, which the reference reads from XLA): over a
    step on ``meta`` tensors it is the dry run's peak, temp, output and
    alias bytes (``launch/dryrun.py``).
"""
from __future__ import annotations

import weakref
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


class LiveBytes:
    """The live bytes of the storages on ``device_type`` ("meta" for the
    dry run, "cpu" or "cuda"), and their peak, while ``with tracker:`` is
    open: each storage that an aten op returns and that none of its inputs
    holds (an allocation: not a view, not an in-place or ``out=`` write)
    counts from that op on until its last tensor dies (a weak-reference
    finalizer). :meth:`hold` counts storages that already live (a step's
    arguments) before the call starts. Counts the storages the dispatcher
    sees, not an allocator's rounding or a library's own workspace."""

    def __init__(self, device_type: str = "meta"):
        self.device_type = device_type
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}

    def _count(self, t) -> None:
        import torch

        if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        if id(st) in self._sizes:
            return
        self._sizes[id(st)] = st.nbytes()
        weakref.finalize(st, self._free, id(st))
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def hold(self, tensors) -> int:
        """Count ``tensors``' storages as live now; -> the bytes they add."""
        before = self.live
        for t in tensors:
            self._count(t)
        return self.live - before

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        tracker = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                ins = {id(t.untyped_storage()) for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)}
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in ins:
                        tracker._count(t)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False


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
