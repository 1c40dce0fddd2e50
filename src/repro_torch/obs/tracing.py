"""Span-based tracer with thread-correct wall-clock attribution.

Port of ``repro/obs/tracing.py`` (pure Python). The paper's claims are
per-stage overlap claims, so the tracer must answer "which *thread* spent
how long in which *stage*" — exactly what ``StepStats.stage_times``
(main-thread seconds only) cannot. Spans are recorded on whichever thread
opens them: the overlapped executor's host worker, the d2h thread, the
serving front end and the replay prefetcher each get their own event
buffer, so a pool-submitted gather shows up on ``scratchpipe-host``, not on
the main thread that enqueued it.

Cost model:

  * OFF: runtimes hold :data:`NULL_SPAN`, whose ``__enter__``/``__exit__``
    are empty — no allocation, no clock read.
  * ON: a span is one buffer-registration check, two
    ``perf_counter_ns`` reads, and two tuple appends to a thread-local
    list. No locks on the hot path (the registry lock is taken once per
    thread at first use); buffers are merged only at export.

Spans are host wall-clock: a span around a kernel launch covers the
launch, not the kernel (the card runs it later, asynchronously); a span
around a wait (a d2h event, ``.cpu()``) covers the card's time up to it.

Export is Chrome trace-event JSON (``B``/``E`` duration events + ``M``
thread-name metadata), loadable in Perfetto / ``chrome://tracing``.
Per-thread timestamps are monotone by construction (each thread appends to
its own buffer in clock order); dangling ``B`` events from threads still
mid-span at export time are balanced with synthesized ``E`` events.

The reference's ``jax_annotations=`` option (each span also a
``jax.profiler.TraceAnnotation``) is not carried over: it has no CUDA
meaning, and marking spans for a device profiler (NVTX) would be a feature
the reference lacks.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class _NullSpan:
    """Shared do-nothing span: the telemetry-off hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """Context manager that stamps B/E events into its thread's buffer."""

    __slots__ = ("_tracer", "_name", "_cat", "_buf")

    def __init__(self, tracer: "Tracer", name: str, cat: str):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._buf: Optional[list] = None

    def __enter__(self) -> "_Span":
        t = self._tracer
        self._buf = buf = t._thread_buffer()
        buf.append((self._name, self._cat, "B", t._now_us()))
        return self

    def __exit__(self, *exc) -> None:
        self._buf.append((self._name, self._cat, "E", self._tracer._now_us()))
        return None


class Tracer:
    def __init__(self):
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        # seq tid -> (thread_name, event buffer). Sequential tids (not
        # thread idents, which the OS reuses) keep two short-lived threads
        # from sharing a lane in the exported trace.
        self._threads: Dict[int, Tuple[str, List[tuple]]] = {}
        self._local = threading.local()
        self._next_tid = 0

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _thread_buffer(self) -> List[tuple]:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = []
            with self._lock:
                tid = self._next_tid
                self._next_tid += 1
                self._threads[tid] = (threading.current_thread().name, buf)
            self._local.buf = buf
        return buf

    def span(self, name: str, cat: str = "stage") -> _Span:
        return _Span(self, name, cat)

    def instant(self, name: str, cat: str = "stage") -> None:
        """Zero-duration marker on the current thread."""
        self._thread_buffer().append((name, cat, "I", self._now_us()))

    def wrap(self, name: str, fn: Callable, cat: str = "stage") -> Callable:
        """Wrap ``fn`` so it runs under a span *on the thread that executes
        it* — the hook for pool-submitted work (host gather, d2h waits,
        planner materialize): the span lands on the worker's lane, not on
        the main thread that called ``submit``."""

        def _traced(*args, **kwargs):
            with self.span(name, cat):
                return fn(*args, **kwargs)

        return _traced

    # ---------------------------------------------------------------- export

    def _snapshot_threads(self) -> List[Tuple[int, str, List[tuple]]]:
        with self._lock:
            items = sorted(self._threads.items())
        # copy each buffer: writer threads may still be appending (a slice
        # of an append-only list is a consistent prefix)
        return [(tid, name, list(buf)) for tid, (name, buf) in items]

    def events(self) -> List[dict]:
        """Chrome trace-event dicts, dangling B events balanced."""
        pid = 1
        out: List[dict] = []
        for tid, tname, buf in self._snapshot_threads():
            out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                        "args": {"name": tname}})
            open_stack: List[tuple] = []
            last_ts = 0.0
            for name, cat, ph, ts in buf:
                last_ts = ts
                if ph == "B":
                    open_stack.append((name, cat))
                elif ph == "E":
                    if open_stack:
                        open_stack.pop()
                ev = {"ph": ph, "pid": pid, "tid": tid, "ts": ts}
                if ph != "E":
                    ev["name"] = name
                    ev["cat"] = cat
                if ph == "I":
                    ev["s"] = "t"
                out.append(ev)
            # balance spans still open on this thread at export time
            while open_stack:
                open_stack.pop()
                out.append({"ph": "E", "pid": pid, "tid": tid, "ts": last_ts})
        return out

    def export_chrome(self, path: str) -> int:
        """Write Chrome trace-event JSON; returns the event count."""
        events = self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)

    def totals(self) -> Dict[Tuple[str, str], float]:
        """Aggregate span seconds keyed by (thread_name, span_name) —
        thread-correct per-stage wall time. Nested spans each accrue their
        own full duration."""
        out: Dict[Tuple[str, str], float] = {}
        for _tid, tname, buf in self._snapshot_threads():
            stack: List[Tuple[str, float]] = []
            for name, _cat, ph, ts in buf:
                if ph == "B":
                    stack.append((name, ts))
                elif ph == "E" and stack:
                    bname, bts = stack.pop()
                    key = (tname, bname)
                    out[key] = out.get(key, 0.0) + (ts - bts) / 1e6
        return out

    def thread_names(self) -> List[str]:
        with self._lock:
            return [name for name, _buf in self._threads.values()]
