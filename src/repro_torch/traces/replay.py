"""TraceReplayStream: a recorded trace as a look-ahead training stream.

Port of ``repro/traces/replay.py`` (numpy only; the prefetch thread reads
shards and launches nothing on the card). With a tracer (``tracer=`` or
the global install of ``repro_torch.obs``) each decode runs under a span
on the thread that decodes: ``trace.decode`` on ``trace-prefetch``,
``trace.decode_sync`` on the consumer when it decodes a position itself.

Implements the full ``LookaheadStream`` surface (`__next__`, ``peek_ids``,
``peek_table_ids``, ``consumed``, ``state_dict``, ``exhausted``) so every
cache runtime drives it unchanged, plus:

* **Background double-buffered prefetch.** A daemon thread keeps the next
  ``prefetch`` batches decoded ahead of the consumer — while the pipeline
  drains the front half of the window the thread refills the back half, so
  [Plan] never stalls on shard I/O. Because the reader is position-
  addressed (fixed-size records), the prefetcher is purely a warm-up: if
  the consumer outruns it, the batch is read synchronously — the delivered
  sequence is bit-identical either way. Positions being decoded are
  tracked in an in-flight set under the condition variable, so consumer
  and prefetcher never decode the same position twice: a consumer landing
  on an in-flight position waits for the decode instead of re-reading it,
  and a position the consumer claims is skipped by the prefetcher. A
  ``seek()`` bumps a generation counter that invalidates any decode still
  in flight (its result is discarded, never delivered or cached).

* **Exact-position checkpointing.** ``state_dict()`` records the batch
  cursor; ``TraceReplayStream(path, start=state["consumed"])`` (or
  :meth:`resume`) continues with an identical schedule — the elastic
  restart path needs no generator replay-and-skip.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np

from repro_torch.obs import NULL_SPAN, resolve as obs_resolve
from repro_torch.traces.format import TraceReader


class TraceReplayStream:
    def __init__(
        self,
        trace: Union[str, TraceReader],
        *,
        start: int = 0,
        stop: Optional[int] = None,
        prefetch: int = 8,
        tracer=None,
    ):
        """Replay batches ``[start, stop)`` of the trace (``stop=None`` =
        to the end; a ``stop`` beyond the trace is clamped). ``trace`` is a
        trace directory path or any reader exposing the ``TraceReader``
        surface (``num_batches`` / ``batch`` / ``global_ids`` / ``group``)."""
        self._reader = (
            TraceReader(trace) if isinstance(trace, (str, os.PathLike)) else trace
        )
        self._n = self._reader.num_batches
        if stop is not None:
            self._n = min(self._n, max(0, int(stop)))
        if not (0 <= start <= self._n):
            raise ValueError(f"start {start} out of range [0, {self._n}]")
        self._pos = start
        self._depth = max(0, int(prefetch))
        self._cache: Dict[int, Tuple[np.ndarray, dict]] = {}
        self._cv = threading.Condition()
        self._stop = False
        # positions with a decode in progress (consumer or prefetcher):
        # guarded by _cv; whoever claims a position is the only decoder.
        self._inflight: Set[int] = set()
        # seek() bumps the generation; a decode started under an older
        # generation discards its result instead of caching/delivering it.
        self._gen = 0
        # opt-in tracing: decode spans land on whichever thread decodes
        self._tracer, _ = obs_resolve(tracer, None)
        self._thread: Optional[threading.Thread] = None
        if self._depth > 0:
            self._thread = threading.Thread(
                target=self._prefetch_loop, daemon=True, name="trace-prefetch"
            )
            self._thread.start()

    def _span(self, name: str):
        t = self._tracer
        return NULL_SPAN if t is None else t.span(name, cat="io")

    # -- prefetcher ---------------------------------------------------------
    def _window(self) -> range:
        return range(self._pos, min(self._pos + self._depth, self._n))

    def _prefetch_loop(self):
        while True:
            with self._cv:
                want = None
                while not self._stop:
                    want = next(
                        (
                            p
                            for p in self._window()
                            if p not in self._cache and p not in self._inflight
                        ),
                        None,
                    )
                    if want is not None:
                        break
                    self._cv.wait()
                if self._stop:
                    return
                gen = self._gen
                self._inflight.add(want)
            try:
                with self._span("trace.decode"):
                    item = self._reader.batch(want)  # decode outside the lock
            except BaseException:
                with self._cv:
                    self._inflight.discard(want)
                    self._cv.notify_all()
                raise
            with self._cv:
                self._inflight.discard(want)
                # a decode invalidated by seek() (or that slid out of the
                # window / raced close()) is discarded, never cached
                if (
                    gen == self._gen
                    and not self._stop
                    and want in self._window()
                ):
                    self._cache[want] = item
                self._cv.notify_all()

    # -- stream surface -----------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, dict]:
        with self._cv:
            if self._pos >= self._n:
                raise StopIteration
            pos = self._pos
            item = self._cache.pop(pos, None)
            if item is None and pos in self._inflight:
                # the prefetcher is already decoding this position — wait
                # for it instead of issuing a duplicate synchronous read
                while (
                    pos in self._inflight
                    and pos not in self._cache
                    and not self._stop
                ):
                    self._cv.wait()
                item = self._cache.pop(pos, None)
            if item is None:
                # claim the position so the prefetcher skips it: exactly
                # one decode per position, prefetch on or off
                self._inflight.add(pos)
        if item is None:
            try:
                with self._span("trace.decode_sync"):
                    item = self._reader.batch(pos)
            finally:
                with self._cv:
                    self._inflight.discard(pos)
                    self._cv.notify_all()
        with self._cv:
            self._pos = pos + 1
            for k in [k for k in self._cache if k < self._pos]:
                del self._cache[k]
            self._cv.notify_all()
        return item

    def peek_ids(self, k: int) -> List[np.ndarray]:
        """Global ids of the next k batches WITHOUT consuming them (fewer
        at end-of-trace — check :attr:`exhausted` to disambiguate)."""
        with self._cv:
            positions = list(range(self._pos, min(self._pos + k, self._n)))
            cached = {p: self._cache[p][0] for p in positions if p in self._cache}
        return [
            cached[p] if p in cached else self._reader.global_ids(p)
            for p in positions
        ]

    def peek_table_ids(self, k: int, group) -> List[List[np.ndarray]]:
        """Per-table LOCAL id streams of the next k batches."""
        return [group.split(ids) for ids in self.peek_ids(k)]

    @property
    def consumed(self) -> int:
        return self._pos

    @property
    def num_batches(self) -> int:
        return self._n

    @property
    def exhausted(self) -> bool:
        """True iff every batch has been consumed (a short ``peek_ids``
        window at the trace tail is never ambiguous)."""
        return self._pos >= self._n

    @property
    def reader(self) -> TraceReader:
        return self._reader

    @property
    def group(self):
        return self._reader.group

    # -- checkpoint / restart ------------------------------------------------
    def state_dict(self) -> dict:
        return {"consumed": self._pos, "num_batches": self._n}

    def seek(self, pos: int) -> None:
        """Jump the cursor to an exact batch position. Cached batches are
        dropped and any decode still in flight is invalidated (its result
        is discarded when it completes — it can never be delivered for the
        post-seek schedule)."""
        if not (0 <= pos <= self._n):
            raise ValueError(f"seek {pos} out of range [0, {self._n}]")
        with self._cv:
            self._pos = pos
            self._gen += 1  # invalidate in-flight decodes
            self._cache.clear()
            self._cv.notify_all()

    @classmethod
    def resume(
        cls, trace: Union[str, TraceReader], state: dict, *, prefetch: int = 8
    ) -> "TraceReplayStream":
        """Rebuild the stream at the checkpointed batch position, keeping
        the checkpointed ``stop`` bound (state records the bounded length,
        so a step-limited run never resumes past its original schedule)."""
        stop = state.get("num_batches")
        return cls(
            trace,
            start=int(state["consumed"]),
            stop=None if stop is None else int(stop),
            prefetch=prefetch,
        )

    # -- lifecycle ----------------------------------------------------------
    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop the prefetcher and join its thread. If the thread is stuck
        in a decode past ``timeout`` seconds, the thread handle is KEPT (a
        later ``close()`` can reap it) and a TimeoutError is raised — a
        silently abandoned live thread would keep reading shards after the
        caller believes the stream is closed. Idempotent once joined."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"prefetch thread still decoding after {timeout}s; "
                    "call close() again to reap it"
                )
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort: don't leak the daemon thread's wait
        try:
            self.close()
        except Exception:
            pass
