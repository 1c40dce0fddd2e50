"""Deterministic fault injection for the training runtimes.

Port of ``repro/chaos/injector.py``. The recovery guarantees of the port —
inline op replay, degrade-to-sync, checkpoint/restore bit-parity, host-row
checksum repair — are only worth anything if they are exercised. This
module injects the faults:

* ``kill-<point>@N``   — raise :class:`InjectedWorkerDeath` on the N-th
  call at that point (gather / writeback / d2h). Under the supervised
  overlapped executor this models a worker-thread death: the watchdog
  recomputes the op inline and the run continues bit-identically.
* ``fail-<point>@N``   — same, as a plain :class:`ChaosError` (transient
  op failure rather than thread death).
* ``stall-<point>@N:S``— sleep S seconds inside the N-th call (a hung
  worker; trips the per-op timeout when S exceeds it).
* ``corrupt-row@N:K``  — on the N-th [Plan] call, flip one byte in each of
  K random host-table rows THROUGH the raw buffer (bypassing the write
  API). The table's checksum guard (armed at attach time) detects this at
  the next guarded read/verify as ``RowCorruptionError``.
* ``nan-loss@N``       — replace the N-th [Train] call's loss with NaN
  (the storage update still lands — exactly the poisoned-step shape that
  ``nan_policy="restore"`` must excise via checkpoint restore).

The ``d2h`` hook wraps the function the d2h thread runs: the wait for a
victim copy the main thread enqueued (``core/pipeline.py: _wait_rows``),
so kill-d2h and stall-d2h exercise a worker, as in the reference; the
injector wraps the runtime's functions after the tracer did (injector
outermost). Events are one-shot and keyed on deterministic per-point call
counters, so a chaos run is exactly reproducible: same spec + same seed ->
same faults at the same cycles. Specs parse from compact strings
(``"kill-gather@3;corrupt-row@13:5"``) for the ``--chaos`` flag, or are
drawn from a seeded RNG (:meth:`ChaosPlan.random`) for soak tests.
:meth:`ChaosInjector.attach_server` arms a ``ReadOnlyCacheServer``:
``kill-fetch``/``fail-fetch`` ride its retried prefetch hook, corruption its
planner's clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from repro_torch.obs import resolve as obs_resolve
from repro_torch.runtime.supervision import TransientOpError


def _nan_like(loss):
    """A NaN of the loss's kind: a tensor on its device, else a float."""
    if isinstance(loss, torch.Tensor):
        return torch.full_like(loss, float("nan"))
    return float("nan")


class ChaosError(TransientOpError):
    """An injected transient op failure."""


class InjectedWorkerDeath(ChaosError):
    """An injected worker-thread death (kill-* events)."""


_ACTIONS = ("kill", "fail", "stall", "corrupt", "nan")
# hook -> the event points it serves. "plan" is the cycle clock: row
# corruption and plan-kills both key off the plan-call counter.
_HOOKS = {
    "gather": ("gather",),
    "writeback": ("writeback",),
    "d2h": ("d2h",),
    "fetch": ("fetch",),
    "plan": ("plan", "row"),
    "train": ("train", "loss"),
}
_POINTS = tuple(p for pts in _HOOKS.values() for p in pts)


@dataclasses.dataclass
class ChaosEvent:
    action: str  # kill | fail | stall | corrupt | nan
    point: str  # gather | writeback | d2h | fetch | plan | row | train | loss
    at: int  # fire on the at-th call at that point (1-based)
    arg: float = 0.0  # stall seconds / corrupt row count
    fired: bool = False

    @property
    def spec(self) -> str:
        s = f"{self.action}-{self.point}@{self.at}"
        return f"{s}:{self.arg:g}" if self.arg else s


@dataclasses.dataclass
class ChaosPlan:
    events: List[ChaosEvent]

    @property
    def spec(self) -> str:
        return ";".join(e.spec for e in self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    @classmethod
    def parse(cls, spec: str) -> "ChaosPlan":
        """``"kill-gather@3;stall-d2h@12:0.2;corrupt-row@13:5;nan-loss@9"``"""
        events = []
        for part in filter(None, (s.strip() for s in spec.split(";"))):
            try:
                head, at = part.split("@")
                action, point = head.split("-", 1)
                arg = 0.0
                if ":" in at:
                    at, arg_s = at.split(":")
                    arg = float(arg_s)
                events.append(ChaosEvent(action, point, int(at), arg))
            except ValueError as e:
                raise ValueError(f"bad chaos event {part!r} in {spec!r}") from e
        for e in events:
            if e.action not in _ACTIONS:
                raise ValueError(f"unknown chaos action {e.action!r}")
            if e.point not in _POINTS:
                raise ValueError(f"unknown chaos point {e.point!r}")
            if e.action == "corrupt" and e.point != "row":
                raise ValueError("corrupt events must target point 'row'")
            if e.action == "nan" and e.point != "loss":
                raise ValueError("nan events must target point 'loss'")
        return cls(events)

    @classmethod
    def random(
        cls, seed: int, *, n_events: int = 3, cycles: int = 20
    ) -> "ChaosPlan":
        """A seeded random transient-fault mix (kill/fail/stall) for soak
        runs — corruption and NaNs are opt-in via explicit specs."""
        rng = np.random.default_rng(seed)
        points = ("gather", "writeback", "d2h")
        events = []
        for _ in range(n_events):
            action = ("kill", "fail", "stall")[int(rng.integers(3))]
            point = points[int(rng.integers(len(points)))]
            at = int(rng.integers(1, max(2, cycles)))
            arg = round(float(rng.uniform(0.05, 0.2)), 3) if action == "stall" else 0.0
            events.append(ChaosEvent(action, point, at, arg))
        return cls(events)


class ChaosInjector:
    """Arms a :class:`ChaosPlan` against a runtime by wrapping its op
    hooks. Deterministic: per-point call counters + a seeded RNG for the
    corruption victims. ``fired`` records what actually triggered (events
    landing past the end of a short run simply never fire)."""

    def __init__(self, plan: ChaosPlan, *, seed: int = 0, metrics=None):
        self.plan = plan
        self.rng = np.random.default_rng(seed)
        self.counts = {hook: 0 for hook in _HOOKS}
        self.fired: List[ChaosEvent] = []
        self.corrupted: List[int] = []  # host rows flipped so far
        self._host = None
        _, m = obs_resolve(None, metrics)
        self._c_injected = (
            m.counter("chaos.injected") if m is not None else None
        )

    # ------------------------------------------------------------------ #
    def _fire(self, ev: ChaosEvent, hook: str) -> None:
        ev.fired = True
        self.fired.append(ev)
        if self._c_injected is not None:
            self._c_injected.inc()
        if ev.action == "stall":
            time.sleep(ev.arg)
        elif ev.action == "corrupt":
            self._corrupt_rows(max(1, int(ev.arg)))
        elif ev.action == "kill":
            raise InjectedWorkerDeath(
                f"injected worker death: {ev.spec} (hook {hook})"
            )
        elif ev.action == "fail":
            raise ChaosError(f"injected op failure: {ev.spec} (hook {hook})")
        # "nan" is handled by the train wrapper (needs the loss in hand)

    def _tick(self, hook: str) -> List[ChaosEvent]:
        """Advance the hook's call counter; fire side-effect events; return
        the due events the CALLER must apply (the nan-loss case)."""
        self.counts[hook] += 1
        c = self.counts[hook]
        due = []
        for ev in self.plan.events:
            if ev.fired or ev.point not in _HOOKS[hook] or ev.at != c:
                continue
            if ev.action == "nan":
                ev.fired = True
                self.fired.append(ev)
                if self._c_injected is not None:
                    self._c_injected.inc()
                due.append(ev)
            else:
                self._fire(ev, hook)
        return due

    def _corrupt_rows(self, k: int) -> None:
        host = self._host
        assert host is not None, "injector not attached"
        rows = self.rng.choice(host.rows, size=min(k, host.rows), replace=False)
        raw = host.data.view(np.uint8).reshape(host.rows, -1)
        for r in rows:
            # one flipped byte per victim row, through the raw buffer —
            # invisible to the write API, caught only by the checksum guard
            raw[int(r), int(self.rng.integers(raw.shape[1]))] ^= 0xFF
        self.corrupted.extend(int(r) for r in rows)

    def _wrap(self, hook: str, fn):
        def wrapped(*args, **kw):
            self._tick(hook)
            return fn(*args, **kw)

        wrapped.__name__ = f"chaos_{hook}"
        return wrapped

    def _wrap_train(self, fn):
        def wrapped(*args, **kw):
            storage, aux = fn(*args, **kw)
            if self._tick("train"):
                # poison the observable loss; the storage update has
                # already landed (that is the point of the drill)
                if isinstance(aux, dict) and "loss" in aux:
                    aux = {**aux, "loss": _nan_like(aux["loss"])}
                else:
                    aux = float("nan")
            return storage, aux

        return wrapped

    # ------------------------------------------------------------------ #
    def attach(self, pipe) -> "ChaosInjector":
        """Arm against a training runtime (ScratchPipe, or shard 0 of a
        ShardedScratchPipe — one faulty node is the model). May be called
        again on a rebuilt runtime: fired events stay fired, and the
        counters go on counting."""
        target = pipe.pipes[0] if hasattr(pipe, "pipes") else pipe
        self._host = target.host
        # the checksum guard goes on while a corruption is still to come (an
        # injector attached anew after a restart skips its full-table pass)
        if any(e.action == "corrupt" and not e.fired for e in self.plan.events):
            self._host.enable_guard()
        target._gather_fn = self._wrap("gather", target._gather_fn)
        target._writeback_fn = self._wrap("writeback", target._writeback_fn)
        target._d2h_fn = self._wrap("d2h", target._d2h_fn)
        planner = target.planner
        planner.plan = self._wrap("plan", planner.plan)
        if target.train_fn is not None:
            target.train_fn = self._wrap_train(target.train_fn)
        if getattr(target, "fused_train_fn", None) is not None:
            target.fused_train_fn = self._wrap_train(target.fused_train_fn)
        return self

    def attach_server(self, server) -> "ChaosInjector":
        """Arm against a ``ReadOnlyCacheServer``: fetch faults ride the
        failsafe prefetch hook (``_fetch_gather``); row corruption turns on
        the host table's checksum guard and rides the plan clock."""
        self._host = server.host
        if any(e.action == "corrupt" and not e.fired for e in self.plan.events):
            self._host.enable_guard()
        server._fetch_gather = self._wrap("fetch", server._fetch_gather)
        server.planner.plan = self._wrap("plan", server.planner.plan)
        return self
