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
The reference's ``policy``, ``memoize_plan`` and ``record_stage_times``
options are not carried over: no caller of the port sets them (LRU and the
memoized planner are the defaults kept).

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

Not ported yet (each raises NotImplementedError with a pointer to
ROADMAP.md): ``supervise`` and ``state_arrays`` (item 12),
``tracer``/``metrics`` (item 12).
"""
from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.plan import Planner, PlanResult, pad_index, pad_rows
from repro_torch.core.plan_device import DevicePlanner
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.runtime import register_runtime
from repro_torch.device import HostCopy, resolve_device


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
    # main-thread seconds per stage (kept for field parity with the
    # reference; the port's runtimes leave it None and time stages from
    # outside, as chip_smoke.py does)
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1 {item})"
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
    """d2h-thread task: wait for a victim copy (both halves of an int8
    pair) and return it as numpy."""
    return _map_rows(lambda p: p.wait(), pending)


@dataclasses.dataclass
class _InFlight:
    ids: np.ndarray
    batch: Any
    plan: Optional[PlanResult] = None
    # int8 rows travel as (payload, scale) pairs in each of the four fields
    host_rows: Any = None  # [Collect] host->staging (quantized)
    host_rows_f: Optional[Future] = None  # overlapped: pending gather
    evicted_dev: Any = None  # [Collect] device victim read
    evict_ready: Any = None  # overlapped: event right after the victim read
    fetched_dev: Any = None  # [Exchange] h2d
    evicted_host: Any = None  # [Exchange] d2h
    evicted_host_f: Optional[Future] = None  # overlapped: pending d2h
    stage: int = 0  # stages completed: 1=planned .. 4=inserted


class ScratchPipe:
    def __init__(
        self,
        host_table: HostEmbeddingTable,
        num_slots: int,
        train_fn: Callable[[torch.Tensor, np.ndarray, Any], Tuple[torch.Tensor, Any]],
        *,
        past_window: int = 3,
        future_window: int = 2,
        pipelined: bool = True,
        precision: Optional[str] = None,
        table_group=None,
        slot_budgets=None,
        executor: str = "sync",
        fused_train_fn: Optional[Callable] = None,
        planner: str = "host",
        pad_buckets: Optional[Sequence[int]] = None,
        tracer=None,
        metrics=None,
        supervise=None,
        device="cuda",
    ):
        if executor not in ("sync", "overlapped"):
            raise ValueError(f"unknown executor {executor!r}")
        if planner not in ("host", "device"):
            raise ValueError(f"unknown planner placement {planner!r}")
        if supervise is not None:
            raise _not_ported("supervise", "item 12")
        if tracer is not None or metrics is not None:
            raise _not_ported("tracer/metrics", "item 12")
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
        self.pipelined = pipelined
        self.pad_buckets = tuple(sorted(pad_buckets)) if pad_buckets else None
        self.table_group = table_group
        if not pipelined:  # straw-man (§IV-B): depth-1, no hazards possible
            past_window, future_window = 0, 0
        windows = dict(past_window=past_window, future_window=future_window)
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
            self.planner = Planner(host_table.rows, eff_slots, **windows)
        self.storage = sp.make_storage(
            eff_slots, host_table.dim, precision=self.precision, device=self.device
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
        self._pending: Deque[Future] = collections.deque()
        self._copy: Optional[HostCopy] = None
        if executor == "overlapped":
            self._host_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="scratchpipe-host")
            self._d2h_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="scratchpipe-d2h")
            self._copy = HostCopy(self.device)
        self._gather_fn = self.host.gather
        if self.precision != "fp32":
            # master -> replica quantization inside the gather, so under
            # overlapped it runs on the host worker and the h2d copy already
            # moves the small rows
            def _gather_quantized(ids, _g=self.host.gather, _p=self.precision):
                return qz.quantize_rows_np(_g(ids), _p)

            self._gather_fn = _gather_quantized

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
    def _submit_host(self, fn, *args) -> Future:
        fut = self._host_pool.submit(fn, *args)
        self._pending.append(fut)
        # reap retired work each cycle: surfaces worker exceptions promptly
        # and keeps the deque from growing with the run length
        while self._pending and self._pending[0].done():
            self._pending.popleft().result()
        return fut

    def _op_result(self, fut: Future):
        """A host-queue result, read on the calling thread; a worker's
        exception raises here."""
        if fut in self._pending:
            self._pending.remove(fut)
        return fut.result()

    def _barrier(self) -> None:
        """Wait for every outstanding host operation (gathers, write-backs,
        and through them the victims' copies). Called at run and drain ends
        and before anything reads the host table or its counters."""
        while self._pending:
            self._pending.popleft().result()

    def _writeback(self, evict_ids: np.ndarray, d2h: Future) -> None:
        """Host-worker task: wait for the victims' d2h, then scatter. Runs
        strictly after every earlier-submitted gather (one ordered worker)."""
        self.host.scatter(evict_ids, self._dequant(d2h.result()))

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
    def _stage_plan(self, entry: _InFlight, lookahead: List[np.ndarray]):
        entry.plan = self.planner.plan(entry.ids, lookahead)
        if self._d2h_pool is not None and hasattr(entry.plan, "start_materialize"):
            # device planner + overlapped: the miss/evict vectors come back
            # on the d2h thread, beside [Train]
            entry.plan.start_materialize(self._d2h_pool)

    def _stage_collect(self, entry: _InFlight):
        p = entry.plan
        if p.miss_ids.size:
            # host read; master -> replica quantization on the host, so the
            # h2d copy below already moves the small rows
            if self._host_pool is not None:
                entry.host_rows_f = self._submit_host(self._gather_fn, p.miss_ids)
            else:
                entry.host_rows = self._gather_fn(p.miss_ids)
        if p.evict_slots.size:
            # pad victim reads to the pow-2 bucket (slot 0 is always safe
            # to read); the d2h side slices the real rows back out
            entry.evicted_dev = sp.read(
                self.storage, self._index(pad_index(p.evict_slots, 0, self.pad_buckets))
            )
            if self._copy is not None:
                entry.evict_ready = self._copy.ready()
        self.hbm.read += p.evict_slots.size * self._row_bytes

    def _stage_exchange(self, entry: _InFlight):
        p = entry.plan
        if p.miss_ids.size:  # h2d, both halves of an int8 pair
            rows = (self._op_result(entry.host_rows_f)
                    if entry.host_rows_f is not None else entry.host_rows)
            entry.fetched_dev = _map_rows(
                lambda r: torch.from_numpy(pad_rows(r, self.pad_buckets)).to(self.device),
                rows,
            )
        n_evict = int(p.evict_slots.size)
        if n_evict and self._copy is not None:
            # the copies are enqueued here (the launching thread); the d2h
            # thread only waits for them
            pending = _map_rows(
                lambda t: self._copy.start(t[:n_evict], entry.evict_ready),
                entry.evicted_dev,
            )
            entry.evicted_host_f = self._d2h_pool.submit(_wait_rows, pending)
        elif n_evict:  # d2h of the real victims, padding dropped
            entry.evicted_host = _map_rows(
                lambda t: t[:n_evict].cpu().numpy(), entry.evicted_dev
            )
        self.pcie.written += p.miss_ids.size * self._row_bytes
        self.pcie.read += p.evict_slots.size * self._row_bytes

    def _stage_insert_host(self, entry: _InFlight):
        """[Insert], host half: write evicted (dirty, trained) rows back."""
        p = entry.plan
        if p.evict_ids.size:
            if self._host_pool is not None:
                self._submit_host(self._writeback, p.evict_ids, entry.evicted_host_f)
            else:
                self.host.scatter(p.evict_ids, self._dequant(entry.evicted_host))

    def _stage_insert_fill(self, entry: _InFlight):
        """[Insert], device half: fill fetched rows into their slots."""
        p = entry.plan
        if p.fill_slots.size:
            self.storage = sp.fill(
                self.storage,
                self._index(pad_index(p.fill_slots, self.num_slots, self.pad_buckets)),
                entry.fetched_dev,
            )
        self.hbm.written += p.fill_slots.size * self._row_bytes

    def _stage_train(
        self, entry: _InFlight, fused_entry: Optional[_InFlight] = None
    ) -> StepStats:
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
        st = StepStats(
            step=p.step,
            n_lookups=n_lookups,
            n_unique=p.n_unique,
            n_hits=p.n_hits,
            n_miss=int(p.miss_ids.size),
            n_evict=int(p.evict_slots.size),
            hit_lookups=n_lookups,  # always-hit at [Train] (§IV)
            by_table=by_table,
            aux=aux,
        )
        self._stats.append(st)
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
            vals = _map_rows(lambda t: t.cpu().numpy(),
                             sp.read(self.storage, self._index(live)))
            self.host.scatter(slot_to_id[live], self._dequant(vals))

    def state_arrays(self) -> dict:
        raise _not_ported("checkpointing (state_arrays)", "item 12")

    def load_state_arrays(self, arrays: dict) -> None:
        raise _not_ported("checkpointing (load_state_arrays)", "item 12")

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
