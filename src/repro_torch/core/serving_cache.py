"""Read-only serving runtimes: the always-hit cache under inference traffic.

Port of ``repro/core/serving_cache.py`` (fp32): ``NoCacheServer`` (the
oracle) and ``ReadOnlyCacheServer``, registered as ``nocache-serve`` and
``scratchpipe-serve``. Planning, queueing and byte accounting are the
reference's numpy code unchanged; the device half is PyTorch: rows go to
the device with ``torch.from_numpy(...).to(device)``, bags come back with
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

Not ported yet (see ROADMAP.md): ``static-serve``, the ``tracer``/
``metrics`` hooks, ``fetch_retries``, ``state_arrays``/
``load_state_arrays``/warm start (``convert.py`` carries a reference
server's state across instead), and fp16/int8 replicas.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.pipeline import StepStats
from repro_torch.core.plan import Planner, PlanResult, pad_index, pad_rows
from repro_torch.core.runtime import register_runtime
from repro_torch.core.table_group import TableGroup
from repro_torch.device import resolve_device


def _lookup_bags(storage: torch.Tensor, slots: np.ndarray) -> np.ndarray:
    """[Lookup]: the training forward's gather+bag-reduce, backward elided.
    ``slots`` (R, T, L) on the host -> (R, T, D) fp32 bags on the host (the
    copy back synchronizes the device)."""
    ids = torch.from_numpy(np.ascontiguousarray(slots, dtype=np.int32))
    return sp.gather_reduce(storage, ids.to(storage.device)).cpu().numpy()


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


class ReadOnlyCacheServer(_ServingRuntimeBase):
    """ScratchPipe's plan-ahead cache with the write-back half deleted.

    The queue is the look-ahead window: up to ``window`` micro-batches
    behind the head are admitted into the 4-stage pipeline
    ([Plan] -> [Exchange] -> [Insert] -> [Lookup]) and age one stage per
    serve cycle. At queue depth >= ``window`` every served batch finds all
    of its rows landed — 100% lookup hits; shallower queues pay emergency
    completion on the serve path (misses + latency, never wrong results).
    The scratchpad holds fp32 rows on ``device``.
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
        device="cuda",
    ):
        super().__init__(
            host_table,
            queue_depth=window if queue_depth is None else queue_depth,
            device=device,
        )
        self.window = int(window)
        if table_group is not None and table_group.uniform_precision() != "fp32":
            raise ValueError(
                "the port's serving scratchpad holds fp32 rows; fp16/int8 "
                "replicas come with the mixed-precision slice"
            )
        self.num_slots = int(num_slots)
        self._row_bytes = qz.row_bytes(
            host_table.dim, "fp32", host_table.data.dtype.itemsize
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
            if sum(budgets) > self.num_slots:
                raise ValueError(
                    f"slot budgets {budgets} exceed num_slots={self.num_slots}"
                )
            row_offsets = table_group.offsets
            slot_ranges = table_group.slot_ranges(budgets)
        else:
            row_offsets = slot_ranges = None
        # past_window=0: no dirty rows, no RAW hold register. future_window
        # covers the visible queue — the look-ahead protection itself.
        self.planner = Planner(
            host_table.rows,
            self.num_slots,
            past_window=0,
            future_window=self.window,
            policy=policy,
            row_offsets=row_offsets,
            slot_ranges=slot_ranges,
        )
        self.storage = sp.make_storage(
            self.num_slots, host_table.dim, device=self.device
        )
        # slot content validity: True iff the slot holds the row the HitMap
        # currently maps to it (fills land here; plans invalidate here)
        self._landed = np.zeros(self.num_slots, dtype=bool)
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
        padded_slots = pad_index(
            np.ascontiguousarray(slots, dtype=np.int32), self.num_slots,
            self.pad_buckets,
        )
        sp.fill(
            self.storage,
            torch.from_numpy(padded_slots).to(self.device),
            torch.from_numpy(pad_rows(rows, self.pad_buckets)).to(self.device),
        )
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
