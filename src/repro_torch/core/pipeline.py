"""ScratchPipe: the pipelined always-hit embedding cache runtime (paper §IV).

Port of ``repro/core/pipeline.py`` at fp32, fp16 or int8 replica
precision, with both executors and both planner placements. Six-stage
pipeline over mini-batches, one training iteration completing per pipeline
cycle at steady state:

    [Plan] -> [Collect] -> [Exchange] -> [Insert] -> [Train(fwd+bwd+update)]

Stage execution inside a cycle is deliberately ordered ADVERSARIALLY w.r.t.
the paper's RAW hazards — [Collect] of the newest in-flight batch runs
*before* [Insert]/[Train] of older batches — so any hold-window bug surfaces
as stale data instead of being masked by sequential execution. With the
paper's window (3 past + current + 2 future) execution is equivalent to
sequential training (tests/test_torch_train.py ports the property tests).

``train_fn(storage, slots, batch) -> (storage, aux)`` is the [Train] stage:
it gathers from the scratchpad with ``slots`` (numpy from the host planner,
a device tensor from the device planner) and updates those rows IN PLACE on
the card (``core/dlrm_runtime.py``).

The device half is PyTorch on ``device``: [Collect] reads the victims with
plain indexing (a copy, taken before the older batches' [Train] of the same
cycle updates the scratchpad), [Exchange] moves the fetched rows host ->
device and the victims device -> host, [Insert] fills with the port's
``fill`` kernel, or — with ``fused_train_fn`` — inside the [Train] launch
(``fill_gather_reduce``). Empty operands launch nothing, and
variable-length index operands are padded to the reference's buckets —
pow-2 by default, or the set ``pad_buckets=`` gives (a trace-derived set,
``traces/profiling.py: derive_pad_buckets``, ``launch/train.py
--adaptive-pad``) — so the kernels see the reference's operands, drop
sentinels included; the padding changes operand lengths, never results.
``policy`` ("lru", "lfu", "random"; the device planner takes "lru" only,
as the reference's) and ``memoize_plan`` go to the planner;
``record_stage_times=True`` fills each ``StepStats.stage_times`` with the
calling thread's seconds per stage (``plan``, ``collect``, ``exchange``,
``insert``, ``train``), the reference's keys.

Multi-table (``table_group=``, paper §VI-D): the tables of a
:class:`~repro_torch.core.table_group.TableGroup` share one scratchpad
whose slots are split into per-table ranges (``slot_budgets=``, default
``table_group.precision_slot_budgets(num_slots)``), so one table's burst
never evicts another's held rows; both planners take the row offsets and
slot ranges, and ``StepStats.by_table`` carries each table's hits and
misses. One storage holds one replica precision: the group's must be
uniform (mixed per-table precisions need
:class:`~repro_torch.core.sharded_pipeline.ShardedScratchPipe`, one
manager and storage per table).

Executors:

  * ``executor="sync"`` (default) — every stage runs on the calling thread
    in the hazard-adversarial order above; the victims' d2h copy waits for
    the card, once per cycle.
  * ``executor="overlapped"`` — ONE ordered host worker runs the [Collect]
    gather (with the master -> replica quantize inside it) and the [Insert]
    write-back (with the dequantize), in the sync engine's submission
    order; a d2h thread waits for the victims' and the device plan's
    copies. Host-table operations all run on the one worker, so every host
    read/write interleaving is the sync engine's and the two executors are
    bitwise equal. Every CUDA launch stays on the calling thread: the
    workers run numpy and wait on events, nothing else. The d2h copies go
    on a dedicated stream into pinned buffers (``device.HostCopy``),
    ordered by an event recorded right after their producer, so they do not
    queue behind the [Train] kernels enqueued after it. A worker's
    exception surfaces from ``run``; there is no fallback to ``sync``.
    Call :meth:`close` to release the threads.

Planner placement: ``planner="host"`` (default) runs the numpy
:class:`~repro_torch.core.plan.Planner`; ``"device"`` keeps the plan state
on the card (:class:`~repro_torch.core.plan_device.DevicePlanner`): raw ids
go h2d, the dense id -> slot translation feeds [Train] without visiting the
host, and the miss/fill/evict vectors come back in one packed d2h (on the
d2h thread under ``overlapped``). Both placements give equal plans.

Replica precision (``core/quantize.py``): the host table keeps fp32
masters. ``num_slots`` is the byte budget in fp32 rows; fp16 holds 2x and
int8 4x as many rows in it (``nominal_slots`` keeps the budget,
``num_slots`` the rows). [Collect] quantizes the missed master rows on the
host (numpy), so the h2d copy already moves the small rows — both halves of
an int8 ``(payload, scale)`` pair; the victim read and its d2h move the
quantized rows too, and [Insert] and ``flush_to_host`` dequantize them into
the masters on the host.

The runtime keeps the reference's per-tier byte counters ([Collect]/
[Insert] host bytes, [Exchange] PCIe bytes, [Train] HBM bytes, priced at
``quantize.row_bytes`` of the replica), LOGICAL (unpadded) and identical to
the reference's on the same stream.

Telemetry (``repro_torch.obs``, opt-in: ``tracer=``/``metrics=`` or the
global install): spans ``plan``, ``collect``, ``exchange``,
``insert_host``, ``insert_fill`` and ``train`` on the calling thread, and
the pool functions wrapped once at construction, so ``collect.gather``
(the precision's own gather, quantize included) and ``insert.writeback``
land on ``scratchpipe-host``, ``exchange.d2h`` and ``plan.materialize`` on
``scratchpipe-d2h``; ``cache.*`` counters per [Train], per-table cells,
and lazy gauges over the byte counters and the planner (``obs_labels=``
adds labels). With both off the hot loop sees ``NULL_SPAN`` and ``is
None`` branches only; a traced run is bitwise equal to an untraced one.

Supervision (``supervise=SupervisePolicy(...)``, overlapped executor): a
host or d2h op that raises or outlives ``op_timeout`` is recomputed INLINE
on the calling thread, every op from the failed one on in submission
order, after its stalled future is quiesced; a d2h op's replay waits on
the same pending copy (it never enqueues a second one). After
``degrade_after`` incidents the pools are shut down and the runtime runs
``executor="sync"`` for the rest of the run. Results are unchanged either
way. :meth:`state_arrays`/:meth:`load_state_arrays` snapshot and restore
the whole runtime at any cycle, mid-window included (planner, scratchpad,
host table in place, traffic counters, the in-flight entries), so a
restored run is bitwise equal to the uninterrupted one.

bf16 scratchpad (``storage_dtype=torch.bfloat16``, the reference's fp32-path
experiment knob; no launcher sets it, so none has a flag): the host keeps
fp32 masters, [Exchange] moves fp32 rows, and the fill kernel rounds them
into bf16 slots; [Train] gathers bf16 bags into the fp32 MLP and rounds
each add of the update to bf16 (``core/scratchpad.py``). The victims cross
d2h as their 16 bits and are widened exactly into the masters on the host
(numpy has no bfloat16), as ``flush_to_host`` and ``state_arrays`` widen
the scratchpad. The byte counters price a row at fp32, as the reference's
do. ``storage_dtype`` with a reduced ``precision`` raises, as in the
reference, and so does a dtype other than fp32 or bf16.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.pack import pack_blob, unpack_blob
from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.plan import Planner, PlanResult, pad_index, pad_rows
from repro_torch.core.plan_device import DevicePlanner
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.runtime import register_runtime
from repro_torch.device import HostCopy, PendingCopy, resolve_device, to_host
from repro_torch.obs import NULL_SPAN, resolve as obs_resolve
from repro_torch.runtime.supervision import (
    OpSupervisor,
    SupervisedOp,
    SupervisePolicy,
    TransientOpError,
)


@dataclasses.dataclass
class StepStats:
    step: int
    n_lookups: int
    n_unique: int
    n_hits: int
    n_miss: int
    n_evict: int
    hit_lookups: int = 0  # lookup-level (non-unique) hit count
    by_table: Any = None  # per-table {hits, misses} (multi-table runs only)
    # the calling thread's seconds per stage (ScratchPipe(record_stage_times=True))
    stage_times: Optional[Dict[str, float]] = None
    aux: Any = None

    @property
    def hit_rate(self) -> float:
        return self.n_hits / max(self.n_unique, 1)


#: PlanResult fields that describe one planned micro-batch (the reference
#: serializes these per in-flight entry in its checkpoints).
_PLAN_FIELDS = (
    "step", "slots", "miss_ids", "fill_slots", "evict_slots", "evict_ids",
    "n_unique", "n_hits", "hits_by_table", "misses_by_table",
)


def _map_rows(fn, rows):
    """``fn`` over a row block, or over both halves of an int8
    ``(payload, scale)`` pair (a :class:`QuantStorage` stays one)."""
    if isinstance(rows, tuple):
        out = [fn(r) for r in rows]
        return QuantStorage(*out) if isinstance(rows, QuantStorage) else tuple(out)
    return fn(rows)


def _numel(x) -> int:
    """Element count of a numpy array or a tensor (``.size`` is a method
    on a tensor)."""
    return x.numel() if isinstance(x, torch.Tensor) else int(x.size)


def _wait_rows(pending):
    """The victims' d2h (both halves of an int8 pair) as numpy: on the d2h
    thread a wait for a copy the main thread enqueued (``PendingCopy``);
    under the sync executor a blocking copy of the tensors, on the main
    thread (bf16 victims widened exactly to fp32)."""
    return _map_rows(lambda p: p.wait() if isinstance(p, PendingCopy) else to_host(p),
                     pending)


def _to_numpy(x):
    """A tensor (an int8 pair: both halves) -> an owning numpy copy; None
    stays None. Pairs come back as plain tuples (the blob's form)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_to_numpy(a) for a in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16: widened, exactly
            return to_host(x)
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def capture_plan(p) -> dict:
    """A plan (host PlanResult, or a device plan: its host fields
    materialize, its device ``slots`` come back) -> a plain host dict of
    the ``_PLAN_FIELDS``, as checkpoints hold it."""
    out: Dict[str, Any] = {}
    for f in _PLAN_FIELDS:
        v = getattr(p, f)
        if f in ("step", "n_unique", "n_hits"):
            out[f] = int(v)
        else:
            out[f] = None if v is None else _to_numpy(v)
    return out


@dataclasses.dataclass
class _InFlight:
    ids: np.ndarray
    batch: Any
    plan: Optional[PlanResult] = None
    # int8 rows travel as (payload, scale) pairs in each of the four fields
    host_rows: Any = None  # [Collect] host->staging (quantized)
    host_rows_f: Optional[SupervisedOp] = None  # overlapped: pending gather
    evicted_dev: Any = None  # [Collect] device victim read
    evict_ready: Any = None  # overlapped: event right after the victim read
    fetched_dev: Any = None  # [Exchange] h2d
    evicted_host: Any = None  # [Exchange] d2h
    evicted_host_f: Optional[SupervisedOp] = None  # overlapped: pending d2h
    stage: int = 0  # stages completed: 1=planned .. 4=inserted
    times: Dict[str, float] = dataclasses.field(default_factory=dict)  # per stage


class ScratchPipe:
    def __init__(
        self,
        host_table: HostEmbeddingTable,
        num_slots: int,
        train_fn: Callable[[torch.Tensor, np.ndarray, Any], Tuple[torch.Tensor, Any]],
        *,
        past_window: int = 3,
        future_window: int = 2,
        policy: str = "lru",
        pipelined: bool = True,
        storage_dtype=None,
        precision: Optional[str] = None,
        table_group=None,
        slot_budgets=None,
        executor: str = "sync",
        fused_train_fn: Optional[Callable] = None,
        memoize_plan: bool = True,
        record_stage_times: bool = False,
        planner: str = "host",
        pad_buckets: Optional[Sequence[int]] = None,
        tracer=None,
        metrics=None,
        obs_labels: Optional[Dict[str, str]] = None,
        supervise: Optional[SupervisePolicy] = None,
        device="cuda",
    ):
        if executor not in ("sync", "overlapped"):
            raise ValueError(f"unknown executor {executor!r}")
        if planner not in ("host", "device"):
            raise ValueError(f"unknown planner placement {planner!r}")
        self.device = resolve_device(device)
        # an explicit precision= must agree with the group's (uniform) one:
        # one storage holds one replica format
        group_prec = table_group.uniform_precision() if table_group is not None else None
        if precision is None:
            precision = group_prec or "fp32"
        elif group_prec is not None and precision != group_prec:
            raise ValueError(
                f"precision={precision!r} conflicts with the table group's "
                f"uniform precision {group_prec!r}"
            )
        self.precision = qz.check_precision(precision)
        eff_slots = num_slots * qz.SLOT_MULTIPLIER[self.precision]
        self.host = host_table
        self.train_fn = train_fn
        self.fused_train_fn = fused_train_fn
        self.record_stage_times = record_stage_times
        self.pipelined = pipelined
        self.pad_buckets = tuple(sorted(pad_buckets)) if pad_buckets else None
        self.table_group = table_group
        if not pipelined:  # straw-man (§IV-B): depth-1, no hazards possible
            past_window, future_window = 0, 0
        windows = dict(past_window=past_window, future_window=future_window, policy=policy)
        if table_group is not None:
            if table_group.total_rows != host_table.rows:
                raise ValueError(
                    f"table_group covers {table_group.total_rows} rows, "
                    f"host table has {host_table.rows}"
                )
            budgets = (list(slot_budgets) if slot_budgets is not None
                       else table_group.precision_slot_budgets(num_slots))
            if sum(budgets) > eff_slots:
                raise ValueError(f"slot budgets {budgets} exceed num_slots={eff_slots}")
            windows.update(row_offsets=table_group.offsets,
                           slot_ranges=table_group.slot_ranges(budgets))
        if planner == "device":
            self.planner = DevicePlanner(host_table.rows, eff_slots, device=self.device,
                                         pad_buckets=self.pad_buckets, **windows)
        else:
            self.planner = Planner(host_table.rows, eff_slots, memoize=memoize_plan,
                                   **windows)
        self.storage = sp.make_storage(
            eff_slots, host_table.dim, precision=self.precision, dtype=storage_dtype,
            device=self.device
        )
        self.num_slots = eff_slots
        self.nominal_slots = num_slots  # the fp32-row byte budget
        # bytes ONE replica row moves over pcie/hbm (== host.row_bytes at fp32)
        self._row_bytes = qz.row_bytes(
            host_table.dim, self.precision, host_table.data.dtype.itemsize
        )
        self.pcie = HostTraffic()  # read = d2h, written = h2d
        self.hbm = HostTraffic()  # device-side traffic ([Train] + fills)
        self._window: Deque[_InFlight] = collections.deque()
        self._stats: List[StepStats] = []
        self.future_window = future_window
        self.executor = executor
        # overlapped executor: ONE ordered host worker (gathers and
        # write-backs interleave exactly as the sync engine runs them) and a
        # d2h thread that waits for the copies back
        self._host_pool: Optional[ThreadPoolExecutor] = None
        self._d2h_pool: Optional[ThreadPoolExecutor] = None
        self._pending: Deque[SupervisedOp] = collections.deque()
        self._copy: Optional[HostCopy] = None
        if executor == "overlapped":
            self._host_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="scratchpipe-host")
            self._d2h_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="scratchpipe-d2h")
            self._copy = HostCopy(self.device)
        # -- telemetry, resolved once (with both off: NULL_SPAN, `is None`)
        self._tracer, self._metrics = obs_resolve(tracer, metrics)
        self._gather_fn = self.host.gather
        if self.precision != "fp32":
            # master -> replica quantization inside the gather, so under
            # overlapped it runs on the host worker and the h2d copy already
            # moves the small rows
            def _gather_quantized(ids, _g=self.host.gather, _p=self.precision):
                return qz.quantize_rows_np(_g(ids), _p)

            self._gather_fn = _gather_quantized
        self._writeback_fn = self._writeback
        self._d2h_fn = _wait_rows
        if self._tracer is not None:
            # wrapped once, here, so the spans land on the thread that runs
            # the function; the precision's own gather is the one wrapped
            # (the reference wraps host.gather, which drops the quantize)
            self._gather_fn = self._tracer.wrap("collect.gather", self._gather_fn,
                                                cat="host")
            self._writeback_fn = self._tracer.wrap("insert.writeback", self._writeback,
                                                   cat="host")
            self._d2h_fn = self._tracer.wrap("exchange.d2h", _wait_rows, cat="d2h")
        self._mc = None
        if self._metrics is not None:
            self._setup_metrics(dict(obs_labels or {}))
        # -- supervised execution: only the overlapped executor has workers
        self.supervise = supervise
        self._sv: Optional[OpSupervisor] = None
        if supervise is not None and executor == "overlapped":
            self._sv = OpSupervisor(supervise, metrics=self._metrics, tracer=self._tracer)

    def _setup_metrics(self, labels: Dict[str, str]) -> None:
        """Counter cells made now; gauges read the byte counters and the
        planner lazily, at snapshot time (nothing added per cycle)."""
        m = self._metrics
        labels.setdefault("runtime", "scratchpipe" if self.pipelined else "strawman")
        self._mc = {k: m.counter(f"cache.{k}", **labels)
                    for k in ("cycles", "lookups", "unique", "hits", "misses",
                              "evicts", "fills")}
        self._tbl_counters = None
        if self.table_group is not None:
            self._tbl_counters = [
                (m.counter("cache.hits", table=t.name, **labels),
                 m.counter("cache.misses", table=t.name, **labels))
                for t in self.table_group.tables
            ]
        m.gauge("scratchpad.bytes", fn=lambda: sp.storage_bytes(self.storage),
                dtype=self.precision, **labels)
        m.gauge("traffic.pcie.h2d_bytes", fn=lambda: self.pcie.written, **labels)
        m.gauge("traffic.pcie.d2h_bytes", fn=lambda: self.pcie.read, **labels)
        m.gauge("traffic.hbm.read_bytes", fn=lambda: self.hbm.read, **labels)
        m.gauge("traffic.hbm.written_bytes", fn=lambda: self.hbm.written, **labels)
        m.gauge("traffic.host.read_bytes", fn=lambda: self.host.traffic.read, **labels)
        m.gauge("traffic.host.written_bytes", fn=lambda: self.host.traffic.written,
                **labels)
        m.gauge("planner.occupancy", fn=lambda: self.planner.occupancy, **labels)
        m.gauge("planner.hold_occupancy", fn=self._hold_occupancy, **labels)
        m.gauge("planner.memo.hits", fn=lambda: self._memo_counts()[0], **labels)
        m.gauge("planner.memo.misses", fn=lambda: self._memo_counts()[1], **labels)

    def _hold_occupancy(self) -> int:
        """Slots held by the RAW window (hold register != 0)."""
        if isinstance(self.planner, DevicePlanner):  # one register per table
            return sum(int((s.hold[:-1] != 0).sum()) for s in self.planner._states)
        return int(np.count_nonzero(self.planner.hold))

    def _memo_counts(self) -> Tuple[int, int]:
        """(hits, misses) of the planner's per-batch memo (the host
        planner's digest cache, the device planner's prep cache)."""
        c = self.planner._prep if isinstance(self.planner, DevicePlanner) else self.planner._digests
        return c.hits, c.misses

    def _span(self, name: str, cat: str = "train"):
        t = self._tracer
        return NULL_SPAN if t is None else t.span(name, cat)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        """A host index vector -> int32 tensor on the device (h2d)."""
        return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(self.device)

    def _dequant(self, rows):
        """replica -> master: dequantize written-back rows on the host
        (identity at fp32; on the host worker under overlapped)."""
        if self.precision == "fp32":
            return rows
        return qz.dequantize_rows_np(rows, self.precision)

    # ------------------------------------------------------------------ #
    # overlapped-executor plumbing
    # ------------------------------------------------------------------ #
    def _submit_host(self, fn, *args) -> SupervisedOp:
        if self._host_pool is None:
            # degraded mid-run: execute inline (sync semantics)
            return SupervisedOp.completed(fn, args, fn(*args))
        op = SupervisedOp(fn, args)
        op.future = self._host_pool.submit(fn, *args)
        self._pending.append(op)
        # reap retired work each cycle: surfaces worker exceptions promptly
        # and keeps the deque from growing with the run length
        while self._pending and self._pending[0].probe_done() and self._settle_head():
            pass
        return op

    def _settle_head(self) -> bool:
        """Settle the oldest queued op. Unsupervised, a worker's exception
        raises here; under supervision a failed or stalled op starts the
        ordered inline recovery of the whole queue, and False is returned
        (the queue is then empty)."""
        if self._sv is None:
            self._pending.popleft().result_now()
            return True
        try:
            self._pending[0].wait(self._sv.policy.op_timeout)
        except TransientOpError as e:
            self._sv.note_failure(e)
            self._recover_pending()
            return False
        self._pending.popleft()
        return True

    def _op_result(self, op: SupervisedOp):
        """A host-queue result, read on the calling thread. Every EARLIER op
        settles first (submission order), so under supervision a failure
        upstream of ``op`` is recovered before a value computed against
        tainted host state is consumed."""
        while not op.settled and self._pending and self._settle_head():
            pass
        return op.result_now()

    def _barrier(self) -> None:
        """Wait for every outstanding host operation (gathers, write-backs,
        and through them the victims' copies). Called at run and drain ends
        and before anything reads the host table or its counters. Under
        supervision a failed or stalled op is recovered inline instead of
        raising."""
        while self._pending and self._settle_head():
            pass

    def _recover_pending(self) -> None:
        """Ordered recovery of the host-op queue after a failure or timeout:
        every op from the first failed one on is recomputed INLINE (on this,
        the calling thread) in submission order. Host ops are pure reads
        (gather) or idempotent writes keyed by evict ids (scatter), so the
        replay reproduces the sync engine's host-table interleaving exactly.
        Retries are bounded by the policy; repeated incidents degrade the
        runtime to the sync executor."""
        sv = self._sv
        with self._span("ft.recover", cat="host"):
            poisoned = False
            while self._pending:
                op = self._pending.popleft()
                if not poisoned:
                    try:
                        op.wait(sv.policy.op_timeout)
                        continue
                    except TransientOpError as e:
                        sv.note_failure(e)
                        poisoned = True
                # quiesce before replaying: never run the op inline while a
                # (stalled) worker might still be executing it. Its result
                # is dropped, not kept: the worker ran it without the failed
                # op's effect (a gather behind a failed write-back reads
                # the rows before they are written)
                f = op.future
                if f is not None and not f.done() and not f.cancel():
                    futures_wait([f], timeout=sv.policy.op_timeout * 5)
                sv.run_inline(op)
        if sv.note_incident():
            self._degrade_to_sync()

    def _degrade_to_sync(self) -> None:
        """After repeated worker faults: settle every in-flight op, abandon
        the pools, and run every later stage inline (``executor="sync"``).
        Output is unchanged — the sync order IS the reference order — only
        overlap is lost."""
        if self._host_pool is None and self._d2h_pool is None:
            return
        self._sv.note_degraded()
        for e in self._window:
            if e.host_rows_f is not None:
                e.host_rows = self._sv.value_or_inline(e.host_rows_f)
                e.host_rows_f = None
            if e.evicted_host_f is not None:
                e.evicted_host = self._sv.value_or_inline(e.evicted_host_f)
                e.evicted_host_f = None
        pools = [p for p in (self._host_pool, self._d2h_pool) if p is not None]
        self._host_pool = self._d2h_pool = None
        self.executor = "sync"
        for p in pools:
            # queued work (a device plan's materialize) still completes;
            # the threads then exit — nothing new is ever submitted
            p.shutdown(wait=False)

    def _d2h_value(self, d2h):
        """A victims' d2h value: a SupervisedOp (overlapped; recomputed
        inline under supervision — a wait on the same pending copy, so the
        value is byte-identical), or already host rows."""
        if isinstance(d2h, SupervisedOp):
            return d2h.result_now() if self._sv is None else self._sv.value_or_inline(d2h)
        return d2h

    def _writeback(self, evict_ids: np.ndarray, d2h) -> None:
        """Host-worker task: wait for the victims' d2h, then scatter. Runs
        strictly after every earlier-submitted gather (one ordered worker)."""
        self.host.scatter(evict_ids, self._dequant(self._d2h_value(d2h)))

    def close(self) -> None:
        """Quiesce and release the overlapped executor's threads.
        Idempotent; a no-op for the sync executor."""
        try:
            self._barrier()
        finally:
            for pool in (self._host_pool, self._d2h_pool):
                if pool is not None:
                    pool.shutdown(wait=True)
            self._host_pool = self._d2h_pool = None

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #
    @staticmethod
    def _timed(entry: _InFlight, stage: str, t0: float) -> None:
        """Add the seconds since ``t0`` to ``entry``'s time for ``stage``
        (the [Insert] halves add up to one "insert")."""
        entry.times[stage] = entry.times.get(stage, 0.0) + time.perf_counter() - t0

    def _stage_plan(self, entry: _InFlight, lookahead: List[np.ndarray]):
        t0 = time.perf_counter()
        with self._span("plan"):
            entry.plan = self.planner.plan(entry.ids, lookahead)
            if self._d2h_pool is not None and hasattr(entry.plan, "start_materialize"):
                # device planner + overlapped: the miss/evict vectors come
                # back on the d2h thread, beside [Train]
                entry.plan.start_materialize(self._d2h_pool, tracer=self._tracer)
        self._timed(entry, "plan", t0)

    def _stage_collect(self, entry: _InFlight):
        t0 = time.perf_counter()
        with self._span("collect"):
            p = entry.plan
            if p.miss_ids.size:
                # host read; master -> replica quantization on the host, so
                # the h2d copy below already moves the small rows
                if self._host_pool is not None:
                    entry.host_rows_f = self._submit_host(self._gather_fn, p.miss_ids)
                else:
                    entry.host_rows = self._gather_fn(p.miss_ids)
            if p.evict_slots.size:
                # pad victim reads to the pow-2 bucket (slot 0 is always
                # safe to read); the d2h side slices the real rows back out
                entry.evicted_dev = sp.read(
                    self.storage,
                    self._index(pad_index(p.evict_slots, 0, self.pad_buckets)))
                if self._d2h_pool is not None:
                    entry.evict_ready = self._copy.ready()
            self.hbm.read += p.evict_slots.size * self._row_bytes
        self._timed(entry, "collect", t0)

    def _stage_exchange(self, entry: _InFlight):
        t0 = time.perf_counter()
        with self._span("exchange"):
            p = entry.plan
            if p.miss_ids.size:  # h2d, both halves of an int8 pair
                rows = (self._op_result(entry.host_rows_f)
                        if entry.host_rows_f is not None else entry.host_rows)
                entry.fetched_dev = _map_rows(
                    lambda r: torch.from_numpy(pad_rows(r, self.pad_buckets)).to(self.device),
                    rows,
                )
            n_evict = int(p.evict_slots.size)
            if n_evict and self._d2h_pool is not None:
                # the copies are enqueued here (the launching thread); the
                # d2h thread only waits for them, and so does a replay
                pending = _map_rows(
                    lambda t: self._copy.start(t[:n_evict], entry.evict_ready),
                    entry.evicted_dev,
                )
                op = SupervisedOp(self._d2h_fn, (pending,))
                op.future = self._d2h_pool.submit(self._d2h_fn, pending)
                entry.evicted_host_f = op
            elif n_evict:  # d2h of the real victims, padding dropped
                entry.evicted_host = self._d2h_fn(
                    _map_rows(lambda t: t[:n_evict], entry.evicted_dev))
            self.pcie.written += p.miss_ids.size * self._row_bytes
            self.pcie.read += p.evict_slots.size * self._row_bytes
        self._timed(entry, "exchange", t0)

    def _stage_insert_host(self, entry: _InFlight):
        """[Insert], host half: write evicted (dirty, trained) rows back."""
        t0 = time.perf_counter()
        with self._span("insert_host"):
            p = entry.plan
            if p.evict_ids.size:
                if self._host_pool is not None:
                    self._submit_host(self._writeback_fn, p.evict_ids,
                                      entry.evicted_host_f)
                else:
                    self.host.scatter(p.evict_ids, self._dequant(entry.evicted_host))
        self._timed(entry, "insert", t0)

    def _stage_insert_fill(self, entry: _InFlight):
        """[Insert], device half: fill fetched rows into their slots."""
        t0 = time.perf_counter()
        with self._span("insert_fill"):
            p = entry.plan
            if p.fill_slots.size:
                self.storage = sp.fill(
                    self.storage,
                    self._index(pad_index(p.fill_slots, self.num_slots, self.pad_buckets)),
                    entry.fetched_dev,
                )
            self.hbm.written += p.fill_slots.size * self._row_bytes
        self._timed(entry, "insert", t0)

    def _stage_train(
        self, entry: _InFlight, fused_entry: Optional[_InFlight] = None
    ) -> StepStats:
        t0 = time.perf_counter()
        with self._span("train"):
            return self._train_body(entry, fused_entry, t0)

    def _train_body(self, entry: _InFlight, fused_entry: Optional[_InFlight],
                    t0: float) -> StepStats:
        p = entry.plan
        if fused_entry is not None:
            # one launch: the younger batch's [Insert]-fill rides inside
            # this batch's [Train] forward (order — fill, then train — is
            # exactly the split engine's intra-cycle order)
            fp = fused_entry.plan
            self.storage, aux = self.fused_train_fn(
                self.storage,
                pad_index(fp.fill_slots, self.num_slots, self.pad_buckets),
                fused_entry.fetched_dev,
                p.slots,
                entry.batch,
            )
            self.hbm.written += fp.fill_slots.size * self._row_bytes
            fused_entry.times.setdefault("insert", 0.0)  # its fill rode in [Train]
        else:
            self.storage, aux = self.train_fn(self.storage, p.slots, entry.batch)
        n_lookups = _numel(p.slots)
        # [Train] HBM traffic: gather reads + coalesced scatter read-mod-write
        self.hbm.read += n_lookups * self._row_bytes
        self.hbm.read += p.n_unique * self._row_bytes
        self.hbm.written += p.n_unique * self._row_bytes
        by_table = None
        if p.hits_by_table is not None:
            by_table = {"hits": p.hits_by_table, "misses": p.misses_by_table}
        self._timed(entry, "train", t0)
        st = StepStats(
            step=p.step,
            n_lookups=n_lookups,
            n_unique=p.n_unique,
            n_hits=p.n_hits,
            n_miss=int(p.miss_ids.size),
            n_evict=int(p.evict_slots.size),
            hit_lookups=n_lookups,  # always-hit at [Train] (§IV)
            by_table=by_table,
            stage_times=dict(entry.times) if self.record_stage_times else None,
            aux=aux,
        )
        self._stats.append(st)
        mc = self._mc
        if mc is not None:
            mc["cycles"].inc()
            mc["lookups"].inc(st.n_lookups)
            mc["unique"].inc(st.n_unique)
            mc["hits"].inc(st.n_hits)
            mc["misses"].inc(st.n_miss)
            mc["evicts"].inc(st.n_evict)
            mc["fills"].inc(int(p.fill_slots.size))
            if by_table is not None and self._tbl_counters is not None:
                for (ch, cm), h, m in zip(self._tbl_counters, by_table["hits"],
                                          by_table["misses"]):
                    ch.inc(int(h))
                    cm.inc(int(m))
        return st

    # ------------------------------------------------------------------ #
    # pipeline driver
    # ------------------------------------------------------------------ #
    def run(
        self, stream: Iterator[Tuple[np.ndarray, Any]], lookahead_fn=None
    ) -> List[StepStats]:
        """stream yields (sparse_ids, batch_payload). ``lookahead_fn(k)``
        returns the ids of the next k mini-batches WITHOUT consuming them
        (see data/lookahead.py). Returns per-step stats (train order)."""
        if not self.pipelined:
            return self._run_sequential(stream)
        out: List[StepStats] = []
        it = iter(stream)
        draining = False
        while True:
            if not draining:
                # streams exposing ``exhausted`` (LookaheadStream) are asked
                # directly, so the drain never rests on a sentinel next()
                if getattr(stream, "exhausted", False):
                    draining = True
                else:
                    try:
                        ids, batch = next(it)
                    except StopIteration:
                        draining = True
                    else:
                        entry = _InFlight(np.asarray(ids), batch)
                        la = (
                            lookahead_fn(self.future_window)
                            if lookahead_fn
                            else []
                        )
                        self._stage_plan(entry, la)
                        entry.stage = 1
                        self._window.append(entry)
            self._advance_cycle(out)
            if draining and not self._window:
                break
        self._barrier()
        return out

    def _advance_cycle(self, out: List[StepStats]):
        """One pipeline cycle: every in-flight entry advances exactly one
        stage (entries entered on different cycles, so their stage indices
        are all distinct). Execution order inside the cycle is the
        hazard-adversarial one — the newest batch's [Collect] reads host and
        scratchpad state BEFORE the older batches' [Insert] write-back and
        [Train] update run. A missing hold-window rule therefore produces
        stale reads (caught by the property tests) instead of being hidden
        by sequential execution."""
        by_stage = {e.stage: e for e in self._window}
        if 1 in by_stage:
            self._stage_collect(by_stage[1])
        if 2 in by_stage:
            self._stage_exchange(by_stage[2])
        e3 = by_stage.get(3)
        e4 = by_stage.get(4)
        if e3 is not None:
            self._stage_insert_host(e3)
        fuse = (
            self.fused_train_fn is not None
            and e4 is not None
            and e3 is not None
            and e3.plan.fill_slots.size > 0
        )
        if e3 is not None and not fuse:
            self._stage_insert_fill(e3)
        if e4 is not None:
            out.append(self._stage_train(e4, fused_entry=e3 if fuse else None))
            self._window.remove(e4)
        for s in (1, 2, 3):
            if s in by_stage:
                by_stage[s].stage = s + 1

    # -- incremental driving (lockstep multi-shard execution, §VI-G) ------- #
    def run_one_cycle(self, ids, batch, lookahead_fn=None) -> Optional[StepStats]:
        """Plan one new mini-batch and advance the pipeline one cycle. The
        unpipelined straw-man completes the whole step immediately (the
        EmbeddingCacheRuntime contract)."""
        if not self.pipelined:
            return self._step_sequential(np.asarray(ids), batch)
        entry = _InFlight(np.asarray(ids), batch)
        la = lookahead_fn(self.future_window) if lookahead_fn else []
        self._stage_plan(entry, la)
        entry.stage = 1
        self._window.append(entry)
        out: List[StepStats] = []
        self._advance_cycle(out)
        return out[0] if out else None

    def drain_one_cycle(self) -> Optional[StepStats]:
        """Advance one cycle without a new batch (pipeline drain)."""
        out: List[StepStats] = []
        self._advance_cycle(out)
        if not self._window:
            self._barrier()
        return out[0] if out else None

    def _step_sequential(self, ids: np.ndarray, batch) -> StepStats:
        """One full straw-man step: Plan/Collect/Exchange/Insert/Train
        back-to-back. The fused path merges the batch's own [Insert]-fill
        into its [Train] launch."""
        entry = _InFlight(ids, batch)
        self._stage_plan(entry, [])
        self._stage_collect(entry)
        self._stage_exchange(entry)
        self._stage_insert_host(entry)
        if self.fused_train_fn is not None and entry.plan.fill_slots.size:
            return self._stage_train(entry, fused_entry=entry)
        self._stage_insert_fill(entry)
        return self._stage_train(entry)

    def _run_sequential(self, stream) -> List[StepStats]:
        """Straw-man (§IV-B): dynamic cache, no pipelining — every batch runs
        the five stages back-to-back."""
        out = [
            self._step_sequential(np.asarray(ids), batch) for ids, batch in stream
        ]
        self._barrier()
        return out

    # ------------------------------------------------------------------ #
    def flush_to_host(self):
        """Write every cached (dirty) row back to the host table."""
        self._barrier()
        # bind once: the device planner's slot_to_id is a d2h per access
        slot_to_id = self.planner.slot_to_id
        live = np.flatnonzero(slot_to_id >= 0)
        if live.size:
            vals = _map_rows(to_host, sp.read(self.storage, self._index(live)))
            self.host.scatter(slot_to_id[live], self._dequant(vals))

    # -- checkpoint/restart (crash-consistent, ANY cycle) ------------------ #
    def _to_device(self, x):
        """Host rows (an int8 pair: both halves) -> tensors on the device."""
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(self._to_device(a) for a in x)
        return torch.from_numpy(np.array(x)).to(self.device)

    def _capture_window(self) -> list:
        """Every in-flight entry as host structures. Pending ops are
        RESOLVED (not cancelled): after ``_barrier()`` the host queue is
        drained, and the d2h waits settle here. Non-destructive — the
        entries keep their (now settled) ops and the run continues."""
        entries = []
        for e in self._window:
            host_rows = e.host_rows
            if e.host_rows_f is not None:
                host_rows = self._op_result(e.host_rows_f)
            evicted_host = e.evicted_host
            if e.evicted_host_f is not None:
                evicted_host = self._d2h_value(e.evicted_host_f)
            entries.append({
                "ids": np.asarray(e.ids),
                "stage": int(e.stage),
                "batch": e.batch,  # host-normalized inside pack_blob
                "plan": None if e.plan is None else capture_plan(e.plan),
                "host_rows": _to_numpy(host_rows),
                "evicted_dev": _to_numpy(e.evicted_dev),
                "fetched_dev": _to_numpy(e.fetched_dev),
                "evicted_host": _to_numpy(evicted_host),
            })
        return entries

    def _restore_entry(self, d: dict) -> _InFlight:
        e = _InFlight(np.asarray(d["ids"]), d["batch"])
        e.stage = int(d["stage"])
        if d["plan"] is not None:
            # always a host PlanResult: the captured fields are exactly what
            # later stages consume, equal to what either planner produced
            e.plan = PlanResult(**d["plan"])
        e.host_rows = d["host_rows"]
        e.evicted_dev = self._to_device(d["evicted_dev"])
        e.fetched_dev = self._to_device(d["fetched_dev"])
        ev = d["evicted_host"]
        if ev is not None:
            if self._host_pool is not None:
                # [Insert]-host under overlapped hands the op straight to the
                # write-back task: restore it settled
                e.evicted_host_f = SupervisedOp.completed(lambda *_a, _v=ev: _v, (), ev)
            else:
                e.evicted_host = ev
        return e

    def state_arrays(self) -> dict:
        """Crash-consistent host snapshot at ANY cycle: planner state,
        scratchpad contents (int8: ``storage`` + ``storage_scale``), host
        table, traffic counters and the in-flight hold window (``window``:
        a packed blob of the queued batches, staged rows and settled d2h
        values), in the reference's keys. ``_barrier()`` first drains the
        ordered host queue, so every captured value is the sync engine's at
        this cycle. Every array is a copy except ``host_table``, which is
        the live table (``CheckpointManager.save`` copies it)."""
        self._barrier()
        out = {"host_table": self.host.data}
        if isinstance(self.storage, QuantStorage):
            out["storage"] = _to_numpy(self.storage.data)
            out["storage_scale"] = _to_numpy(self.storage.scale)
        else:
            out["storage"] = _to_numpy(self.storage)
        for k, v in self.planner.state_dict().items():
            out[f"planner_{k}"] = np.array(v)
        out["traffic"] = np.array(
            [self.pcie.read, self.pcie.written, self.hbm.read, self.hbm.written,
             self.host.traffic.read, self.host.traffic.written], dtype=np.int64)
        if self._window:
            out["window"] = pack_blob(self._capture_window())
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        """Load a :meth:`state_arrays` snapshot (this package's or the
        reference's) into this runtime: the host table IN PLACE (a shard's
        table is a view of the caller's), the scratchpad, the planner, the
        counters and the in-flight window onto this runtime's device."""
        self._barrier()
        self._window.clear()
        ht = np.asarray(arrays["host_table"])
        if ht.shape != self.host.data.shape:
            raise ValueError(f"checkpoint host table {ht.shape} != {self.host.data.shape}")
        self.host.data[...] = ht
        self.host.reguard()
        if "storage_scale" in arrays:
            self.storage = QuantStorage(self._to_device(arrays["storage"]),
                                        self._to_device(arrays["storage_scale"]))
        else:  # a bf16 storage was saved widened to fp32: narrowed back, exactly
            self.storage = self._to_device(arrays["storage"]).to(self.storage.dtype)
        self.planner.load_state_dict(
            {k[len("planner_"):]: np.array(v) for k, v in arrays.items()
             if k.startswith("planner_")})
        if "traffic" in arrays:
            t = [int(x) for x in np.asarray(arrays["traffic"])]
            self.pcie.read, self.pcie.written = t[0], t[1]
            self.hbm.read, self.hbm.written = t[2], t[3]
            self.host.traffic.read, self.host.traffic.written = t[4], t[5]
        if "window" in arrays:
            for d in unpack_blob(arrays["window"]):
                self._window.append(self._restore_entry(d))

    @property
    def stats(self) -> List[StepStats]:
        return self._stats

    def traffic(self) -> dict:
        self._barrier()  # host counters settle with the worker queue
        return {"host": self.host.traffic, "pcie": self.pcie, "hbm": self.hbm}


@register_runtime("scratchpipe")
def _make_scratchpipe(host_table, train_fn, *, num_slots, **kw) -> ScratchPipe:
    return ScratchPipe(host_table, num_slots, train_fn, **kw)


@register_runtime("strawman")
def _make_strawman(host_table, train_fn, *, num_slots, **kw) -> ScratchPipe:
    kw.pop("pipelined", None)
    return ScratchPipe(host_table, num_slots, train_fn, pipelined=False, **kw)
