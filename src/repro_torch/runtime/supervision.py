"""Supervised execution primitives for the overlapped executor.

Port of ``repro/runtime/supervision.py``, copied unchanged (pure Python).
In the port the host ops are numpy (gather, write-back) and the d2h ops
wait on a copy the main thread already enqueued (``device.HostCopy``), so
an inline recompute on any thread launches nothing on the card.

The overlapped ScratchPipe executor runs host work (gathers, write-backs)
on one ordered worker thread and d2h materializations on another. Today a
thread death or hang in either pool stalls the pipeline or silently drops
a write-back. This module adds the watchdog layer:

* :class:`SupervisedOp` — a submitted unit of work (fn + args + future).
  The function and its arguments are retained so the op can be REcomputed
  inline on the submitting thread if the worker dies or times out. Every
  pipeline host op is a pure read (host gather) or an idempotent write
  (host scatter of evicted rows / d2h device read), so an inline replay
  produces byte-identical results and preserves the sync-order
  interleaving on the host table — recovery never breaks bit-parity.
* :class:`SupervisePolicy` — per-op timeout, bounded retries with
  backoff, and the degradation threshold.
* :class:`OpSupervisor` — counts faults, performs the bounded inline
  retries, and decides when to give up on the pools entirely
  (``should_degrade`` → the pipe falls back to ``executor="sync"``).

Fault taxonomy: anything raised by a worker (or a timeout waiting on one)
is wrapped in :class:`TransientOpError` subclasses so supervisors up the
stack (``runtime.fault_tolerance.EmbeddingTrainSupervisor``) can distinguish recoverable pipeline
faults from programming errors.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Optional, Tuple


class TransientOpError(RuntimeError):
    """A pipeline op failed in a way that is expected to be recoverable
    (worker death, timeout, injected fault)."""


class OpTimeoutError(TransientOpError):
    """An op exceeded the supervised per-op timeout."""


@dataclasses.dataclass
class SupervisePolicy:
    """Watchdog knobs for the overlapped executor.

    op_timeout:    seconds to wait on any single worker/d2h op before
                   treating it as stalled.
    max_retries:   inline recompute attempts per op after the first
                   failure (bounded retry).
    backoff:       sleep before retry k is ``backoff * 2**k`` seconds.
    degrade_after: after this many recovery incidents the pools are shut
                   down and the pipe degrades to the sync executor for the
                   rest of the run (graceful degradation — correctness
                   over speed).
    """

    op_timeout: float = 30.0
    max_retries: int = 2
    backoff: float = 0.05
    degrade_after: int = 3


_MISSING = object()


class SupervisedOp:
    """One submitted host/d2h op: future + enough to recompute it inline."""

    __slots__ = ("fn", "args", "future", "_value", "label")

    def __init__(self, fn: Callable, args: Tuple, label: str = ""):
        self.fn = fn
        self.args = args
        self.future: Optional[Future] = None
        self._value: Any = _MISSING
        self.label = label or getattr(fn, "__name__", "op")

    @classmethod
    def completed(cls, fn: Callable, args: Tuple, value: Any) -> "SupervisedOp":
        op = cls(fn, args)
        op._value = value
        return op

    @property
    def settled(self) -> bool:
        return self._value is not _MISSING

    @property
    def value(self) -> Any:
        assert self._value is not _MISSING, f"op {self.label} not settled"
        return self._value

    def probe_done(self) -> bool:
        """True if the op has a cached value or its future has completed
        (successfully or not) — never blocks."""
        return self.settled or (self.future is not None and self.future.done())

    def result_now(self) -> Any:
        """Unsupervised semantics: plain blocking wait, raise on failure."""
        if not self.settled:
            self._value = self.future.result()
        return self._value

    def wait(self, timeout: Optional[float]) -> Any:
        """Wait up to ``timeout``; cache + return the value. Raises
        :class:`OpTimeoutError` on timeout, :class:`TransientOpError`
        wrapping whatever the worker raised on failure."""
        if self.settled:
            return self._value
        try:
            self._value = self.future.result(timeout=timeout)
        except FutureTimeoutError as e:
            raise OpTimeoutError(
                f"op {self.label} exceeded {timeout}s"
            ) from e
        except TransientOpError:
            raise
        except (CancelledError, BaseException) as e:
            raise TransientOpError(f"op {self.label} failed: {e!r}") from e
        return self._value

    def settle(self, value: Any) -> None:
        self._value = value


class OpSupervisor:
    """Fault accounting + bounded inline recovery for supervised ops."""

    def __init__(self, policy: SupervisePolicy, metrics=None, tracer=None):
        self.policy = policy
        self.incidents = 0
        self.retries = 0
        self.timeouts = 0
        self.failures = 0
        self.degraded = False
        self._lock = threading.Lock()
        self._c_fail = self._c_timeout = self._c_retry = None
        self._c_recover = self._c_degraded = None
        self.tracer = tracer
        if metrics is not None:
            # ops that raised/died, ops past op_timeout, inline recompute
            # attempts, ops recovered inline, degradations to sync
            self._c_fail = metrics.counter("ft.op_failures")
            self._c_timeout = metrics.counter("ft.op_timeouts")
            self._c_retry = metrics.counter("ft.retries")
            self._c_recover = metrics.counter("ft.inline_recoveries")
            self._c_degraded = metrics.counter("ft.degraded")

    def note_failure(self, err: BaseException) -> None:
        with self._lock:
            self.failures += 1
            if isinstance(err, OpTimeoutError):
                self.timeouts += 1
        if self._c_fail is not None:
            self._c_fail.inc()
        if isinstance(err, OpTimeoutError) and self._c_timeout is not None:
            self._c_timeout.inc()

    def note_incident(self) -> bool:
        """Record one recovery incident; True if the pipe should degrade."""
        with self._lock:
            self.incidents += 1
            hit = self.incidents >= self.policy.degrade_after
        return hit

    def note_degraded(self) -> None:
        self.degraded = True
        if self._c_degraded is not None:
            self._c_degraded.inc()

    def run_inline(self, op: SupervisedOp) -> Any:
        """Recompute ``op`` on the calling thread with bounded retries +
        exponential backoff. Settles the op with the recomputed value."""
        last: Optional[BaseException] = None
        for attempt in range(self.policy.max_retries + 1):
            if attempt:
                time.sleep(self.policy.backoff * (2 ** (attempt - 1)))
            if self._c_retry is not None:
                self._c_retry.inc()
            with self._lock:
                self.retries += 1
            try:
                value = op.fn(*op.args)
            except Exception as e:  # noqa: BLE001 — bounded, then re-raised
                last = e
                continue
            op.settle(value)
            if self._c_recover is not None:
                self._c_recover.inc()
            return value
        raise TransientOpError(
            f"op {op.label} failed after {self.policy.max_retries + 1} "
            f"inline attempts"
        ) from last

    def value_or_inline(self, op: SupervisedOp) -> Any:
        """Wait for ``op`` under the policy timeout; on timeout/failure fall
        straight to the bounded inline recompute. Safe from ANY thread (no
        queue walking) — used by the host worker to resolve d2h ops."""
        try:
            return op.wait(self.policy.op_timeout)
        except TransientOpError as e:
            self.note_failure(e)
            return self.run_inline(op)
