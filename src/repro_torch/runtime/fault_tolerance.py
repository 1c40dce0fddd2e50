"""Fault tolerance: supervised embedding-runtime training with
checkpoint/restart, NaN-step quarantine, and preemption-aware save.

Port of ``repro/runtime/fault_tolerance.py`` for the cache runtimes: a
worker dies or a host row is corrupted -> the supervisor rebuilds the
runtime, restores the latest checkpoint (planner state, scratchpad, host
table, the in-flight hold window, the trainer's dense parameters and step
counter), fast-forwards the deterministic data stream, and resumes; the
resumed run is bitwise equal to one that never failed. And the LM
``TrainSupervisor``, the reference's plain step-function loop: periodic
checkpoints of the (params, optimizer state) tree, restore + replay of the
deterministic batch stream on a failure or a non-finite loss.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.host_table import RowCorruptionError
from repro_torch.runtime.supervision import TransientOpError


class PreemptionHandler:
    """SIGTERM -> checkpoint at the next step boundary (SLURM/Borg style)."""

    def __init__(self, install: bool = False):
        self.requested = False
        if install:
            signal.signal(signal.SIGTERM, self._on_signal)

    def _on_signal(self, *_):
        self.requested = True


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    nan_steps_skipped: int = 0
    last_step: int = 0
    checkpoints: int = 0
    # wall-clock of each restore (rebuild + load), feeding the MTTR bench
    restore_ms: list = dataclasses.field(default_factory=list)
    # wall-clock of each save call on the training thread (the snapshot
    # to host memory; the write itself is async unless blocking)
    save_ms: list = dataclasses.field(default_factory=list)
    # what triggered each restart, and at which stream position
    causes: list = dataclasses.field(default_factory=list)


class TrainSupervisor:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` over a stream with
    periodic checkpoints and automatic restore-on-failure (the reference's,
    for LM training: ``launch/train.py: train_lm``).

    * ``stream_factory(skip)`` rebuilds the batch iterator positioned after
      ``skip`` consumed batches (deterministic replay).
    * transient exceptions (``RuntimeError``) and non-finite losses trigger
      restore + resume (up to ``max_restarts``); with no checkpoint yet the
      run starts over from step 0 and the state it has.
    * ``nan_policy``: "restore" (the default), "skip" (drop the step's
      update and go on: the returned state is the one before it) or "raise".
    * a save in flight on the checkpoint thread is joined before a restore
      reads the latest step (the reference's restore can race it, ROADMAP
      Queue 3); a preemption request saves at the next step boundary, waits
      for the write and stops.
    """

    def __init__(
        self,
        ckpt: CheckpointManager,
        step_fn: Callable,
        stream_factory: Callable[[int], Iterator],
        *,
        ckpt_every: int = 50,
        max_restarts: int = 5,
        nan_policy: str = "restore",  # "restore" | "skip" | "raise"
        preemption: Optional[PreemptionHandler] = None,
    ):
        if nan_policy not in ("restore", "skip", "raise"):
            raise ValueError(f"nan_policy {nan_policy!r}: restore, skip or raise")
        self.ckpt = ckpt
        self.step_fn = step_fn
        self.stream_factory = stream_factory
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.nan_policy = nan_policy
        self.preemption = preemption or PreemptionHandler()

    def _restore(self, state, report: SupervisorReport):
        t0 = time.perf_counter()
        state, step = self.ckpt.restore(state)
        report.restore_ms.append((time.perf_counter() - t0) * 1e3)
        return state, step

    def run(self, state, total_steps: int) -> tuple:
        report = SupervisorReport()
        step = 0
        self.ckpt.wait()
        if self.ckpt.latest_step() is not None:  # resume from a checkpoint
            state, step = self._restore(state, report)
        stream = self.stream_factory(step)
        restarts = 0
        while step < total_steps:
            try:
                batch = next(stream)
            except StopIteration:
                break
            try:
                new_state, metrics = self.step_fn(state, batch)
                loss = metrics.get("loss")
                if loss is not None and not np.isfinite(float(loss)):
                    report.nan_steps_skipped += 1
                    if self.nan_policy == "raise":
                        raise FloatingPointError(f"non-finite loss at step {step}")
                    if self.nan_policy == "restore":
                        raise _NonFinite(step)
                    new_state = state  # "skip": drop the update, keep going
                state = new_state
                step += 1
                report.steps_run += 1
                report.last_step = step
                if step % self.ckpt_every == 0 or self.preemption.requested:
                    t0 = time.perf_counter()
                    self.ckpt.save(step, state)
                    report.save_ms.append((time.perf_counter() - t0) * 1e3)
                    report.checkpoints += 1
                    if self.preemption.requested:
                        self.ckpt.wait()
                        break
            except (_NonFinite, RuntimeError, FloatingPointError) as e:
                if isinstance(e, FloatingPointError) and self.nan_policy == "raise":
                    raise
                restarts += 1
                report.restarts += 1
                report.causes.append((step, type(e).__name__))
                if restarts > self.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={self.max_restarts}") from e
                self.ckpt.wait()  # a save in flight decides whether there is a checkpoint
                if self.ckpt.latest_step() is None:
                    step = 0  # no checkpoint yet: restart from scratch
                    stream = self.stream_factory(0)
                    continue
                state, step = self._restore(state, report)
                stream = self.stream_factory(step)
        self.ckpt.wait()
        return state, report


class _NonFinite(Exception):
    pass


class EmbeddingTrainSupervisor:
    """Checkpoint/restart supervision for embedding-cache RUNTIMES (the
    pipelined designs of ``repro_torch.core``), as opposed to the plain
    ``step_fn`` loop of the reference's ``TrainSupervisor``.

    The extra difficulty over a stateless step loop is the hold window: a
    pipelined runtime has up to ``window`` mini-batches in flight, so "the
    checkpoint at batch N" must capture planner state, scratchpad, host
    table AND the in-flight entries — which ``state_arrays()`` now does at
    any cycle. The supervisor's restart contract is therefore exact: a run
    that is killed and restored produces bit-identical losses and cache
    decisions to one that never failed (tests/test_torch_recovery.py).

    * ``runtime_factory() -> (runtime, trainer_or_None)`` rebuilds the full
      stack from scratch — host table, trainer, runtime, and (in chaos
      runs) the fault injector — modeling a process restart. ``trainer``
      (``core/dlrm_runtime.py: DLRMTrainer``) contributes its dense
      parameters (``model.state_dict()``, under ``mlps/``) and its step
      counter to the checkpoint; stochastic rounding re-seeds from
      ``(seed, step)``, so the counter is the whole RNG state.
    * ``stream_factory(skip)`` re-creates the deterministic batch stream
      positioned after ``skip`` admitted batches; streams exposing
      ``peek_ids`` (TraceReplayStream, LookaheadStream) also drive the
      planner's look-ahead.
    * Recoverable faults — worker death/timeouts (``TransientOpError``),
      host-row corruption (``RowCorruptionError``), non-finite losses under
      ``nan_policy="restore"``, and runtime errors generally — trigger
      rebuild + restore + fast-forward, bounded by ``max_restarts``.
    * ``verify_every=k`` audits the host table's row checksums every k
      cycles and before every save (requires ``enable_guard()``; the chaos
      harness arms it), after the runtime's workers have quiesced.

    ``nan_policy="skip"`` only counts non-finite losses: with a pipelined
    runtime the embedding update has already landed by the time the loss is
    observable, so a true skip is unsound — use "restore" to excise it.
    """

    def __init__(
        self,
        ckpt: CheckpointManager,
        runtime_factory: Callable[[], tuple],
        stream_factory: Callable[[int], Iterator],
        *,
        ckpt_every: int = 10,
        max_restarts: int = 5,
        nan_policy: str = "restore",  # "restore" | "skip" | "raise"
        verify_every: int = 0,
        blocking_saves: bool = False,
        preemption: Optional[PreemptionHandler] = None,
    ):
        self.ckpt = ckpt
        self.runtime_factory = runtime_factory
        self.stream_factory = stream_factory
        self.ckpt_every = int(ckpt_every)
        self.max_restarts = int(max_restarts)
        if nan_policy not in ("restore", "skip", "raise"):
            raise ValueError(f"unknown nan_policy {nan_policy!r}")
        self.nan_policy = nan_policy
        self.verify_every = int(verify_every)
        self.blocking_saves = blocking_saves
        self.preemption = preemption or PreemptionHandler()
        self.runtime = None  # the live runtime after run() returns
        self.trainer = None
        self._last_saved = -1

    # -- runtime introspection (ScratchPipe / Sharded / serving) ----------- #
    @staticmethod
    def _in_flight(rt) -> int:
        w = getattr(rt, "_window", None)
        if w is not None:
            return len(w)
        pipes = getattr(rt, "pipes", None)
        if pipes:
            return len(pipes[-1]._window)
        return 0

    @staticmethod
    def _hosts(rt) -> list:
        pipes = getattr(rt, "pipes", None)
        if pipes:
            return [p.host for p in pipes]
        return [rt.host]

    @staticmethod
    def _loss_of(st) -> Optional[float]:
        aux = st.aux
        if isinstance(aux, dict):
            aux = aux.get("loss")
        if aux is None:
            return None
        if isinstance(aux, torch.Tensor):  # a loss on the card: one sync
            return float(aux)
        try:
            return float(np.asarray(aux))
        except (TypeError, ValueError):
            return None

    # -- checkpoint plumbing ----------------------------------------------- #
    def _save(self, admitted: int, trained: int, rt, trainer, report) -> None:
        t0 = time.perf_counter()
        state = {"mlps": trainer.model.state_dict()} if trainer is not None else {}
        extra = {"admitted": admitted, "trained": trained}
        if trainer is not None and hasattr(trainer, "_step"):
            extra["trainer_step"] = int(trainer._step)
        self.ckpt.save(
            admitted,
            state,
            host_arrays=rt.state_arrays(),
            extra=extra,
            blocking=self.blocking_saves,
        )
        report.checkpoints += 1
        report.save_ms.append((time.perf_counter() - t0) * 1e3)
        self._last_saved = admitted

    def _restore(self, rt, trainer) -> tuple:
        """Load the latest checkpoint into a freshly built runtime/trainer.
        Returns (admitted, trained) — the stream position and the number of
        completed training steps at the snapshot."""
        self.ckpt.wait()  # the latest step is a finished one
        man = self.ckpt.manifest()
        arrays = {name: self.ckpt.restore_host(name) for name in man["host"]}
        rt.load_state_arrays(arrays)
        if trainer is not None:
            state, _ = self.ckpt.restore({"mlps": trainer.model.state_dict()})
            trainer.model.load_state_dict(state["mlps"])
            if "trainer_step" in man.get("extra", {}):
                trainer._step = int(man["extra"]["trainer_step"])
        extra = man.get("extra", {})
        admitted = int(extra.get("admitted", man["step"]))
        self._last_saved = admitted
        return admitted, int(extra.get("trained", 0))

    # -- the supervised loop ------------------------------------------------ #
    def run(self, total_steps: int) -> tuple:
        report = SupervisorReport()
        rt, trainer = self.runtime_factory()
        stats: list = []
        admitted = 0
        if self.ckpt.latest_step() is not None:
            t0 = time.perf_counter()
            admitted, trained = self._restore(rt, trainer)
            del stats[trained:]
            report.restore_ms.append((time.perf_counter() - t0) * 1e3)
        stream = self.stream_factory(admitted)
        it = iter(stream)
        peek = getattr(stream, "peek_ids", None)
        restarts = 0
        cycles = 0
        while True:
            try:
                st = None
                exhausted = getattr(stream, "exhausted", False)
                if admitted < total_steps and not exhausted:
                    try:
                        ids, batch = next(it)
                    except StopIteration:
                        if self._in_flight(rt) == 0:
                            break
                        st = rt.drain_one_cycle()
                    else:
                        st = rt.run_one_cycle(ids, batch, peek)
                        admitted += 1
                else:
                    if self._in_flight(rt) == 0:
                        break
                    st = rt.drain_one_cycle()
                cycles += 1
                if st is not None:
                    stats.append(st)
                    report.steps_run += 1
                    report.last_step = int(st.step)
                    loss = self._loss_of(st)
                    if loss is not None and not np.isfinite(loss):
                        report.nan_steps_skipped += 1
                        if self.nan_policy == "raise":
                            raise FloatingPointError(
                                f"non-finite loss at step {st.step}"
                            )
                        if self.nan_policy == "restore":
                            raise _NonFinite(st.step)
                        # "skip": the update already landed; count only
                due = (
                    admitted > 0
                    and admitted % self.ckpt_every == 0
                    and admitted != self._last_saved
                )
                save = due or (
                    self.preemption.requested and admitted != self._last_saved
                )
                # the audit also runs before every save, so a checkpoint
                # never captures a corrupted row (a restore would reload it
                # with fresh checksums, past detection)
                if self.verify_every and (save or cycles % self.verify_every == 0):
                    # quiesce first: a write-back still running on the
                    # overlapped worker has written its rows but not yet
                    # their checksums, which reads as corruption (the
                    # reference verifies without waiting)
                    rt._barrier()
                    for h in self._hosts(rt):
                        h.verify()
                if save:
                    self._save(admitted, len(stats), rt, trainer, report)
                    if self.preemption.requested:
                        self.ckpt.wait()
                        break
            except (
                _NonFinite,
                TransientOpError,
                RowCorruptionError,
                FloatingPointError,
                RuntimeError,
            ) as e:
                if (
                    isinstance(e, FloatingPointError)
                    and self.nan_policy == "raise"
                ):
                    raise
                restarts += 1
                report.restarts += 1
                report.causes.append(f"admitted {admitted}: {e!r}"[:300])
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}"
                    ) from e
                t0 = time.perf_counter()
                # settle an async save still in flight before reading the
                # directory: the reference reads the manifest without
                # waiting, so a restore racing the save can load the older
                # step's tables with the newer step's parameters
                self.ckpt.wait()
                try:  # release the dead runtime's worker threads
                    rt.close()
                except Exception:
                    pass
                rt, trainer = self.runtime_factory()
                if self.ckpt.latest_step() is not None:
                    admitted, trained = self._restore(rt, trainer)
                    del stats[trained:]
                else:
                    admitted = 0
                    stats.clear()
                report.restore_ms.append((time.perf_counter() - t0) * 1e3)
                stream = self.stream_factory(admitted)
                it = iter(stream)
                peek = getattr(stream, "peek_ids", None)
        self.ckpt.wait()
        self.runtime, self.trainer = rt, trainer
        return stats, report


class FailureInjector:
    """Deterministically raise at given step numbers (tests/benchmarks)."""

    def __init__(self, fail_at):
        self.fail_at = set(fail_at)
        self.calls = 0

    def maybe_fail(self):
        self.calls += 1
        if self.calls in self.fail_at:
            raise RuntimeError(f"injected node failure at call {self.calls}")
