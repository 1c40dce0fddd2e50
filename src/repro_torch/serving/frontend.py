"""Request front-end: concurrent single-request lookups -> pipeline cycles.

``EmbeddingServer`` is the serving analogue of the training input pipeline:
callers submit one request's id tensor at a time (``lookup()`` returns a
future), and a worker thread batches waiting requests into (R, T, L)
micro-batches for a read-only serving runtime. The worker admits every
formable micro-batch to the backend BEFORE serving one cycle, so under
concurrent load the backend's queue deepens naturally — and since the
backend plans over its queued tail, offered load directly becomes
look-ahead: the busier the server, the higher the hit-rate at the head.
That inversion (queue depth is prefetch distance, not just waiting time)
is the whole point of the queue-as-lookahead design.

Batches are formed from whole requests only (a request's bags come back
from a single cycle, keeping its latency one serve), size-capped at
``max_batch`` requests per cycle.

Port of ``repro/serving/frontend.py``. The worker thread is the only
thread that drives the backend, so it is the one thread that launches
kernels on the card; the submitting threads only queue numpy arrays and
wait on futures. With a tracer (``tracer=``, else the backend's, else the
global install of ``repro_torch.obs``) the worker's ``frontend.form`` and
``frontend.complete`` spans land on ``serving-frontend``.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.obs import NULL_SPAN, resolve as obs_resolve


class EmbeddingServer:
    """Micro-batching front-end over a read-only serving runtime.

    ``backend`` is any serving runtime exposing ``enqueue(ids, tag)`` /
    ``serve_next() -> (bags, stats, tag)`` / ``pending`` (e.g. the
    registry's ``scratchpipe-serve``). All requests must share one
    (T, L) id shape — the pipeline's compiled lookup shape.
    """

    def __init__(self, backend, *, max_batch: int = 32, tracer=None):
        self.backend = backend
        # front-end spans land on the worker thread below; default to the
        # backend's tracer so one opt-in covers the whole serving stack,
        # else the process-global install
        self._tracer, _ = obs_resolve(
            tracer if tracer is not None else getattr(backend, "_tracer", None), None)
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        self._waiting: List[Tuple[np.ndarray, Future]] = []
        # futures admitted to the backend and not yet resolved (worker only)
        self._admitted: List[Future] = []
        self._stop = False
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="serving-frontend"
        )
        self._thread.start()

    def _span(self, name: str):
        t = self._tracer
        return NULL_SPAN if t is None else t.span(name, cat="serve")

    # -- client surface -----------------------------------------------------
    def lookup(self, ids: np.ndarray) -> "Future[np.ndarray]":
        """Submit one request's (T, L) id tensor; the future resolves to its
        (T, D) embedding bags once its micro-batch's cycle completes."""
        ids = np.asarray(ids)
        fut: Future = Future()
        with self._cv:
            if self._err is not None:
                raise RuntimeError("serving worker died") from self._err
            if self._stop:
                raise RuntimeError("EmbeddingServer is closed")
            self._waiting.append((ids, fut))
            self._cv.notify_all()
        return fut

    def lookup_sync(self, ids: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        return self.lookup(ids).result(timeout=timeout)

    # -- worker -------------------------------------------------------------
    def _form_batches(self) -> int:
        """Admit every formable micro-batch to the backend (caller holds
        ``_cv``). Returns the number of batches admitted."""
        formed = 0
        while self._waiting:
            take = self._waiting[: self.max_batch]
            del self._waiting[: len(take)]
            ids = np.stack([r[0] for r in take])
            futures = [r[1] for r in take]
            self.backend.enqueue(ids, tag=futures)
            self._admitted.extend(futures)
            formed += 1
        return formed

    def _worker(self) -> None:
        try:
            while True:
                with self._cv:
                    while (
                        not self._waiting
                        and not self.backend.pending
                        and not self._stop
                    ):
                        self._cv.wait()
                    if self._stop and not self._waiting and not self.backend.pending:
                        return
                    # admit ALL waiting requests first: the backend plans
                    # over its queue, so forming the tail before serving
                    # the head is what turns load into look-ahead
                    with self._span("frontend.form"):
                        self._form_batches()
                bags, _st, futures = self.backend.serve_next()
                with self._span("frontend.complete"):
                    for i, fut in enumerate(futures):
                        fut.set_result(bags[i])
                self._admitted = [f for f in self._admitted if not f.done()]
        except BaseException as e:  # deliver the failure to every caller
            with self._cv:
                self._err = e
                pending = [f for _, f in self._waiting]
                self._waiting.clear()
            # the requests already in the backend's queue wait too (the
            # reference leaves those futures unresolved)
            pending += [f for f in self._admitted if not f.done()]
            for f in pending:
                f.set_exception(e)
            raise

    # -- lifecycle ----------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Drain every outstanding request, then stop the worker."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"serving worker still draining after {timeout}s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
