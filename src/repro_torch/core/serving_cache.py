"""Read-only serving runtimes: the always-hit cache under inference traffic.

Port of ``repro/core/serving_cache.py``: ``NoCacheServer`` (the oracle),
``StaticCacheServer`` and ``ReadOnlyCacheServer``, registered as
``nocache-serve``, ``static-serve`` and ``scratchpipe-serve``. Planning,
queueing and byte accounting are the reference's numpy code unchanged; the
device half is PyTorch: rows go to the device with
``torch.from_numpy(...).to(device)``, bags come back with
``.cpu().numpy()``, and the [Lookup] and [Insert] run the port's kernels
(``core/scratchpad.py``) — the hand-written CUDA kernels on the card, their
plain versions on the CPU. Bags are bit-identical to the reference's.

The request queue IS the look-ahead window: the runtime plans over the
queued tail while serving the head, so a micro-batch that waited
``window`` cycles in the queue finds every one of its rows already resident
when it is finally looked up. Serving deletes the write-back half of the
training pipeline: rows are never dirty, so there is no hold-window shift
register (``past_window=0``) and eviction is free. The cycle is [Plan] ->
[Exchange] -> [Insert] -> [Lookup]. Every plan call passes the visible
queue (head first) as ``future_batches``, so the planner's future holds
keep rows the queue still needs from being evicted.

One ``serve_next()`` call = one pipeline cycle: pop the head, snapshot
which of its rows have LANDED in the scratchpad, emergency-complete
whatever has not (counted as misses), dispatch the lookup, then advance
the remaining visible entries one stage each. Because the head's slot
translate is re-probed from the HitMap at serve time and fills are
validated against the current HitMap before landing, results are
bit-identical to the no-cache oracle under ANY eviction interleaving.

Replica precision (``core/quantize.py``): the plan-ahead scratchpad may
hold fp16 or int8 rows of the fp32 host masters. Rows quantize once on fill
and are never written back; the [Lookup] dequantizes in the kernel and
returns fp32 bags, equal bit for bit to the fp32 oracle's over host rows
that were quantized and dequantized the same way.

Not ported yet (see ROADMAP.md): the ``tracer``/``metrics`` hooks,
``fetch_retries``, ``state_arrays``/``load_state_arrays``/warm start
(``convert.py`` carries a reference server's fp32 state across instead;
Queue 1 item 12), and the ``storage_dtype`` knob (item 11).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.pipeline import StepStats
from repro_torch.core.plan import Planner, PlanResult, pad_index, pad_rows
from repro_torch.core.runtime import register_runtime
from repro_torch.core.table_group import TableGroup
from repro_torch.device import resolve_device


def _lookup_bags(storage, slots: np.ndarray) -> np.ndarray:
    """[Lookup]: the training forward's gather+bag-reduce, backward elided.
    ``slots`` (R, T, L) on the host -> (R, T, D) fp32 bags on the host (the
    copy back synchronizes the device). An fp16 or int8 storage goes
    through the dequantizing gather."""
    dev = storage.data.device if isinstance(storage, QuantStorage) else storage.device
    ids = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32)).to(dev)
    if sp.storage_precision(storage) == "fp32":
        return sp.gather_reduce(storage, ids).cpu().numpy()
    return sp.gather_reduce_q(storage, ids).cpu().numpy()


@dataclasses.dataclass
class _ServeEntry:
    """One queued micro-batch moving through the serving pipeline."""

    ids: np.ndarray  # (R, T, L) global row ids
    tag: Any = None  # opaque front-end handle (returned at serve)
    plan: Optional[PlanResult] = None
    fetched: Optional[np.ndarray] = None  # host rows for plan.miss_ids
    stage: int = 0  # 0=queued 1=planned 2=fetched 3=inserted


class _ServingRuntimeBase:
    """Queue surface + EmbeddingCacheRuntime protocol shared by the serving
    designs. Unpipelined designs serve a whole batch per cycle."""


    def __init__(
        self,
        host_table: HostEmbeddingTable,
        *,
        queue_depth: int = 0,
        device="cuda",
    ):
        self.host = host_table
        self.queue_depth = int(queue_depth)
        self.device = resolve_device(device)
        self.pcie = HostTraffic()
        self.hbm = HostTraffic()
        self._queue: Deque[_ServeEntry] = collections.deque()
        self._stats: List[StepStats] = []
        self._step = 0

    # -- queue surface ------------------------------------------------------
    def enqueue(self, ids: np.ndarray, tag: Any = None) -> None:
        """Admit one micro-batch of requests ((R, T, L) global ids)."""
        e = _ServeEntry(np.asarray(ids), tag)
        self._queue.append(e)
        self._admitted(e)

    def _admitted(self, entry: _ServeEntry) -> None:
        pass  # pipelined designs plan newly visible entries here

    @property
    def pending(self) -> int:
        return len(self._queue)

    def serve_next(self) -> Tuple[np.ndarray, StepStats, Any]:
        """Serve the oldest queued micro-batch: (bags (R, T, D), stats, tag)."""
        if not self._queue:
            raise IndexError("serve_next on an empty queue")
        entry = self._queue.popleft()
        self._step += 1
        bags, st = self._serve(entry)
        self._stats.append(st)
        return bags, st, entry.tag

    def _serve(self, entry: _ServeEntry) -> Tuple[np.ndarray, StepStats]:
        raise NotImplementedError

    # -- EmbeddingCacheRuntime protocol -------------------------------------
    def run(self, stream, lookahead_fn=None) -> List[StepStats]:
        """Drive the runtime over an (ids, payload) stream, holding the
        queue at ``queue_depth`` micro-batches behind the head (payloads
        are ignored — serving consumes id streams)."""
        out: List[StepStats] = []
        for ids, _payload in stream:
            self.enqueue(ids)
            if self.pending > self.queue_depth:
                out.append(self.serve_next()[1])
        while self.pending:
            out.append(self.serve_next()[1])
        return out

    def run_one_cycle(self, ids, batch, lookahead_fn=None) -> Optional[StepStats]:
        self.enqueue(ids)
        if self.pending > self.queue_depth:
            return self.serve_next()[1]
        return None

    def flush_to_host(self) -> None:
        pass  # read-only: nothing is ever dirty

    def traffic(self) -> dict:
        return {"host": self.host.traffic, "pcie": self.pcie, "hbm": self.hbm}

    @property
    def stats(self) -> List[StepStats]:
        return self._stats


class NoCacheServer(_ServingRuntimeBase):
    """Serving oracle: every lookup gathers straight from the host tier
    into a transient padded region on the device, then runs the same bag
    gather-reduce. No device-resident rows, no state — the bit-parity
    reference."""


    def _serve(self, entry: _ServeEntry) -> Tuple[np.ndarray, StepStats]:
        ids = entry.ids
        flat = ids.ravel()
        uniq, inv = np.unique(flat, return_inverse=True)
        rows = self.host.gather(uniq)
        storage = torch.from_numpy(pad_rows(rows)).to(self.device)
        self.pcie.written += rows.nbytes
        bags = _lookup_bags(storage, inv.reshape(ids.shape))
        self.hbm.read += flat.size * self.host.row_bytes
        st = StepStats(
            step=self._step,
            n_lookups=int(flat.size),
            n_unique=int(uniq.size),
            n_hits=0,
            n_miss=int(uniq.size),
            n_evict=0,
            hit_lookups=0,
        )
        return bags, st


class StaticCacheServer(_ServingRuntimeBase):
    """Yin et al. pinned top-N cache, serving flavor: profiled hot rows
    stay on the device in fp32; each cycle's misses ride a transient tail
    (fetched from the host, never inserted): the storage and the padded
    miss rows are concatenated (a copy, ``torch.cat``), then one gather
    serves the micro-batch. Decays under drift exactly like the training
    variant — the comparison point the curve is measured against."""

    def __init__(
        self,
        host_table: HostEmbeddingTable,
        hot_ids: np.ndarray,
        *,
        queue_depth: int = 0,
        device="cuda",
    ):
        super().__init__(host_table, queue_depth=queue_depth, device=device)
        self.hot_ids = np.asarray(np.sort(hot_ids), dtype=np.int64)
        self.id_to_slot = np.full(host_table.rows, -1, dtype=np.int64)
        self.id_to_slot[self.hot_ids] = np.arange(self.hot_ids.size)
        self.storage = torch.from_numpy(host_table.gather(self.hot_ids)).to(self.device)
        host_table.traffic.reset()  # preload is not steady-state traffic

    def _serve(self, entry: _ServeEntry) -> Tuple[np.ndarray, StepStats]:
        ids = entry.ids
        flat = ids.ravel()
        uniq = np.unique(flat)
        slots_u = self.id_to_slot[uniq]
        miss_ids = uniq[slots_u < 0]
        n_hit_lookups = int(np.sum(self.id_to_slot[flat] >= 0))
        miss_rows = self.host.gather(miss_ids)
        self.pcie.written += miss_rows.nbytes
        if miss_ids.size:
            tail = torch.from_numpy(pad_rows(miss_rows)).to(self.device)
            ext = torch.cat([self.storage, tail], dim=0)
        else:
            ext = self.storage
        try:
            self.id_to_slot[miss_ids] = self.hot_ids.size + np.arange(miss_ids.size)
            slots = self.id_to_slot[flat].reshape(ids.shape)
        finally:
            self.id_to_slot[miss_ids] = -1
        bags = _lookup_bags(ext, slots)
        self.hbm.read += flat.size * self.host.row_bytes
        st = StepStats(
            step=self._step,
            n_lookups=int(flat.size),
            n_unique=int(uniq.size),
            n_hits=int(uniq.size - miss_ids.size),
            n_miss=int(miss_ids.size),
            n_evict=0,
            hit_lookups=n_hit_lookups,
        )
        return bags, st


class ReadOnlyCacheServer(_ServingRuntimeBase):
    """ScratchPipe's plan-ahead cache with the write-back half deleted.

    The queue is the look-ahead window: up to ``window`` micro-batches
    behind the head are admitted into the 4-stage pipeline
    ([Plan] -> [Exchange] -> [Insert] -> [Lookup]) and age one stage per
    serve cycle. At queue depth >= ``window`` every served batch finds all
    of its rows landed — 100% lookup hits; shallower queues pay emergency
    completion on the serve path (misses + latency, never wrong results).

    The scratchpad holds ``precision`` rows (fp32, fp16, or int8 with a
    per-row fp32 scale) on ``device``; ``precision`` defaults to the table
    group's uniform precision, else fp32, and must not conflict with it.
    ``num_slots`` is a byte budget in fp32-row units: the scratchpad holds
    ``num_slots * quantize.SLOT_MULTIPLIER[precision]`` rows.
    """


    def __init__(
        self,
        host_table: HostEmbeddingTable,
        num_slots: int,
        *,
        window: int = 2,
        queue_depth: Optional[int] = None,
        policy: str = "lru",
        table_group: Optional[TableGroup] = None,
        slot_budgets=None,
        pad_buckets: Optional[Sequence[int]] = None,
        precision: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(
            host_table,
            queue_depth=window if queue_depth is None else queue_depth,
            device=device,
        )
        self.window = int(window)
        group_prec = (
            table_group.uniform_precision() if table_group is not None else None
        )
        if precision is None:
            precision = group_prec or "fp32"
        elif group_prec is not None and precision != group_prec:
            raise ValueError(
                f"precision={precision!r} conflicts with the table group's "
                f"uniform precision {group_prec!r}"
            )
        self.precision = qz.check_precision(precision)
        eff_slots = int(num_slots) * qz.SLOT_MULTIPLIER[self.precision]
        self.num_slots = eff_slots
        self.nominal_slots = int(num_slots)
        self._row_bytes = qz.row_bytes(
            host_table.dim, self.precision, host_table.data.dtype.itemsize
        )
        self.pad_buckets = tuple(sorted(pad_buckets)) if pad_buckets else None
        self.table_group = table_group
        if table_group is not None:
            if table_group.total_rows != host_table.rows:
                raise ValueError(
                    f"table_group covers {table_group.total_rows} rows, "
                    f"host table has {host_table.rows}"
                )
            budgets = (
                list(slot_budgets)
                if slot_budgets is not None
                else table_group.precision_slot_budgets(num_slots)
            )
            if sum(budgets) > eff_slots:
                raise ValueError(
                    f"slot budgets {budgets} exceed num_slots={eff_slots}"
                )
            row_offsets = table_group.offsets
            slot_ranges = table_group.slot_ranges(budgets)
        else:
            row_offsets = slot_ranges = None
        # past_window=0: no dirty rows, no RAW hold register. future_window
        # covers the visible queue — the look-ahead protection itself.
        self.planner = Planner(
            host_table.rows,
            eff_slots,
            past_window=0,
            future_window=self.window,
            policy=policy,
            row_offsets=row_offsets,
            slot_ranges=slot_ranges,
        )
        self.storage = sp.make_storage(
            eff_slots, host_table.dim, precision=self.precision, device=self.device
        )
        # slot content validity: True iff the slot holds the row the HitMap
        # currently maps to it (fills land here; plans invalidate here)
        self._landed = np.zeros(eff_slots, dtype=bool)
        # the visible window: planned entries, head first (<= window + 1)
        self._visible: Deque[_ServeEntry] = collections.deque()

    # -- pipeline plumbing --------------------------------------------------
    def _future_ids(self, *heads: np.ndarray) -> List[np.ndarray]:
        """Look-ahead id list for a plan call: optional explicit head ids
        first (the nearest future lookups), then the visible queue."""
        out = list(heads)
        out.extend(e.ids for e in self._visible)
        return out

    def _plan_entry(self, entry: _ServeEntry) -> None:
        entry.plan = self.planner.plan(entry.ids, self._future_ids())
        # newly (re-)assigned slots await their fill
        if entry.plan.fill_slots.size:
            self._landed[entry.plan.fill_slots] = False
        entry.stage = 1

    def _admitted(self, entry: _ServeEntry) -> None:
        self._refill_visible()

    def _refill_visible(self) -> None:
        """Admit queued entries into the visible window ([Plan] stage)."""
        for e in self._queue:
            if len(self._visible) >= self.window + 1:
                break
            if e.stage == 0:
                self._plan_entry(e)
                self._visible.append(e)

    def _fetch(self, entry: _ServeEntry) -> None:
        """[Exchange]: host-gather the planned misses (still-valid ones are
        filled at [Insert]; stale pairs are dropped there)."""
        p = entry.plan
        entry.fetched = self.host.gather(p.miss_ids) if p.miss_ids.size else None
        entry.stage = 2

    def _insert(self, entry: _ServeEntry) -> None:
        """[Insert]: fill fetched rows whose (row -> slot) mapping is still
        current and still unlanded (an emergency fill or a later plan may
        have superseded the pair)."""
        p = entry.plan
        if p.miss_ids.size and entry.fetched is not None:
            valid = (self.planner.hitmap[p.miss_ids] == p.fill_slots) & (
                ~self._landed[p.fill_slots]
            )
            if np.any(valid):
                self._fill_rows(p.fill_slots[valid], entry.fetched[valid])
        entry.stage = 3

    def _fill_rows(self, slots: np.ndarray, rows: np.ndarray) -> None:
        """Quantize fp32 host rows to the replica precision, pad them and
        their slots to the bucket, and fill them in (an int8 pair pads both
        components)."""
        padded_slots = pad_index(
            np.ascontiguousarray(slots, dtype=np.int32), self.num_slots,
            self.pad_buckets,
        )
        q = qz.quantize_rows_np(rows, self.precision)
        if isinstance(q, tuple):  # int8: (payload, scale) components
            q = tuple(
                torch.from_numpy(pad_rows(c, self.pad_buckets)).to(self.device)
                for c in q
            )
        else:
            q = torch.from_numpy(pad_rows(q, self.pad_buckets)).to(self.device)
        sp.fill(self.storage, torch.from_numpy(padded_slots).to(self.device), q)
        self._landed[slots] = True
        self.pcie.written += slots.size * self._row_bytes
        self.hbm.written += slots.size * self._row_bytes

    def _advance(self) -> None:
        """Advance every visible non-head entry one stage (the background
        pipeline work overlapping this cycle's serve)."""
        for e in self._visible:
            if e.stage == 1:
                self._fetch(e)
            elif e.stage == 2:
                self._insert(e)

    # -- serve --------------------------------------------------------------
    def _serve(self, entry: _ServeEntry) -> Tuple[np.ndarray, StepStats]:
        if entry.stage == 0:
            # empty-queue arrival: never entered the visible window
            self._plan_entry(entry)
        else:
            self._visible.remove(entry)
        ids = entry.ids
        flat = ids.ravel().astype(np.int32)
        uniq = np.unique(flat)

        # residency snapshot BEFORE any emergency work: the measurable
        # hit — this row was already resident when the request was served
        probe = self.planner.hitmap[uniq]
        resident_u = (probe >= 0) & self._landed[np.maximum(probe, 0)]
        n_hits = int(resident_u.sum())
        resident_rows = np.zeros(self.host.rows, dtype=bool)
        resident_rows[uniq[resident_u]] = True
        hit_lookups = int(resident_rows[flat].sum())

        # emergency completion (shallow queue / evicted prefetch): land
        # every non-resident row now, on this request's critical path
        n_evict = int(entry.plan.evict_slots.size)
        missing = uniq[~resident_u]
        if missing.size:
            n_evict += self._emergency_fill(entry, missing)

        slots = self.planner.hitmap[flat]
        if not ((slots >= 0).all() and self._landed[slots].all()):
            raise RuntimeError("serving invariant broken: unresident row at [Lookup]")
        bags = _lookup_bags(self.storage, slots.reshape(ids.shape))
        self.hbm.read += flat.size * self._row_bytes

        st = StepStats(
            step=self._step,
            n_lookups=int(flat.size),
            n_unique=int(uniq.size),
            n_hits=n_hits,
            n_miss=int(missing.size),
            n_evict=n_evict,
            hit_lookups=hit_lookups,
            aux={"emergency": int(missing.size), "stage_at_serve": entry.stage},
        )
        # the cycle's background stage work (modeled as overlapped)
        self._advance()
        self._refill_visible()
        return bags, st

    def _emergency_fill(self, entry: _ServeEntry, missing: np.ndarray) -> int:
        """Land ``missing`` head rows immediately. Rows still mapped (their
        fill just hasn't landed) fill at their current slot — reusing this
        entry's already-fetched bytes when it owns the pending fill; rows
        evicted since plan are re-planned with the head protected as the
        nearest future batch. Returns the evictions this caused."""
        p = entry.plan
        probe = self.planner.hitmap[missing]
        mapped = missing[probe >= 0]
        n_evict = 0
        if mapped.size:
            slots = self.planner.hitmap[mapped]
            rows = np.empty((mapped.size, self.host.dim), self.host.data.dtype)
            if entry.fetched is not None and p.miss_ids.size:
                # this entry's own in-flight fetch already paid for some rows
                idx = np.searchsorted(p.miss_ids, mapped)
                idx = np.clip(idx, 0, p.miss_ids.size - 1)
                own = p.miss_ids[idx] == mapped
                rows[own] = entry.fetched[idx[own]]
            else:
                own = np.zeros(mapped.size, dtype=bool)
            if np.any(~own):
                rows[~own] = self.host.gather(mapped[~own])
            self._fill_rows(slots, rows)
        orphaned = missing[probe < 0]
        if orphaned.size:
            # evicted between plan and serve: re-plan with the head itself
            # as the nearest future batch, so the re-plan cannot evict the
            # head's own resident rows
            plan = self.planner.plan(orphaned, self._future_ids(entry.ids))
            n_evict = int(plan.evict_slots.size)
            if plan.fill_slots.size:
                self._landed[plan.fill_slots] = False
                self._fill_rows(plan.fill_slots, self.host.gather(plan.miss_ids))
        return n_evict


def _require_no_train_fn(name: str, train_fn) -> None:
    if train_fn is not None:
        raise TypeError(
            f"runtime {name!r} is read-only (serving): it takes no train_fn "
            "— pass None"
        )


@register_runtime("scratchpipe-serve")
def _make_scratchpipe_serve(
    host_table, train_fn=None, *, num_slots, **kw
) -> ReadOnlyCacheServer:
    _require_no_train_fn("scratchpipe-serve", train_fn)
    return ReadOnlyCacheServer(host_table, num_slots, **kw)


@register_runtime("nocache-serve")
def _make_nocache_serve(host_table, train_fn=None, **kw) -> NoCacheServer:
    _require_no_train_fn("nocache-serve", train_fn)
    return NoCacheServer(host_table, **kw)


@register_runtime("static-serve")
def _make_static_serve(
    host_table, train_fn=None, *, hot_ids, **kw
) -> StaticCacheServer:
    _require_no_train_fn("static-serve", train_fn)
    return StaticCacheServer(host_table, hot_ids, **kw)
