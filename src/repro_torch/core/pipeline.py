"""ScratchPipe: the pipelined always-hit embedding cache runtime (paper §IV).

Port of ``repro/core/pipeline.py`` with the ``sync`` executor and the host
planner, at fp32, fp16 or int8 replica precision. Six-stage pipeline over
mini-batches, one
training iteration completing per pipeline cycle at steady state:

    [Plan] -> [Collect] -> [Exchange] -> [Insert] -> [Train(fwd+bwd+update)]

Stage execution inside a cycle is deliberately ordered ADVERSARIALLY w.r.t.
the paper's RAW hazards — [Collect] of the newest in-flight batch runs
*before* [Insert]/[Train] of older batches — so any hold-window bug surfaces
as stale data instead of being masked by sequential execution. With the
paper's window (3 past + current + 2 future) execution is equivalent to
sequential training (tests/test_torch_train.py ports the property tests).

``train_fn(storage, slots, batch) -> (storage, aux)`` is the [Train] stage:
it gathers from the scratchpad with ``slots`` (numpy, from the planner) and
updates those rows IN PLACE on the card (``core/dlrm_runtime.py``).

The device half is PyTorch on ``device``: [Collect] reads the victims with
plain indexing (a copy, taken before the older batches' [Train] of the same
cycle updates the scratchpad), [Exchange] moves the fetched rows host ->
device and the victims device -> host (the copy back synchronizes, once
per cycle), [Insert] fills with the port's ``fill`` kernel, or — with
``fused_train_fn`` — inside the [Train] launch (``fill_gather_reduce``).
Empty operands launch nothing, and variable-length index operands are
padded to the reference's default pow-2 buckets so the kernels see the
reference's operands, drop sentinels included. The reference's
``policy``, ``pad_buckets``, ``memoize_plan`` and ``record_stage_times``
options are not carried over: no caller of the port sets them (LRU,
pow-2 buckets and the memoized planner are the defaults kept).

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
ROADMAP.md): ``executor="overlapped"`` (Queue 1 item 6), ``planner="device"``
(item 7), ``table_group``/``slot_budgets`` (item 9), ``supervise`` and
``state_arrays`` (item 12), ``tracer``/``metrics`` (item 12).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core import scratchpad as sp
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.plan import Planner, PlanResult, pad_index, pad_rows
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.runtime import register_runtime
from repro_torch.device import resolve_device


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


@dataclasses.dataclass
class _InFlight:
    ids: np.ndarray
    batch: Any
    plan: Optional[PlanResult] = None
    # int8 rows travel as (payload, scale) pairs in each of the four fields
    host_rows: Any = None  # [Collect] host->staging (quantized)
    evicted_dev: Any = None  # [Collect] device victim read
    fetched_dev: Any = None  # [Exchange] h2d
    evicted_host: Any = None  # [Exchange] d2h
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
        tracer=None,
        metrics=None,
        supervise=None,
        device="cuda",
    ):
        if executor not in ("sync", "overlapped"):
            raise ValueError(f"unknown executor {executor!r}")
        if planner not in ("host", "device"):
            raise ValueError(f"unknown planner placement {planner!r}")
        if executor == "overlapped":
            raise _not_ported('executor="overlapped"', "item 6")
        if planner == "device":
            raise _not_ported('planner="device"', "item 7")
        if table_group is not None or slot_budgets is not None:
            raise _not_ported("table_group/slot_budgets", "item 9")
        if supervise is not None:
            raise _not_ported("supervise", "item 12")
        if tracer is not None or metrics is not None:
            raise _not_ported("tracer/metrics", "item 12")
        self.device = resolve_device(device)
        self.precision = qz.check_precision(precision or "fp32")
        eff_slots = num_slots * qz.SLOT_MULTIPLIER[self.precision]
        self.host = host_table
        self.train_fn = train_fn
        self.fused_train_fn = fused_train_fn
        self.pipelined = pipelined
        if not pipelined:  # straw-man (§IV-B): depth-1, no hazards possible
            past_window, future_window = 0, 0
        self.planner = Planner(
            host_table.rows,
            eff_slots,
            past_window=past_window,
            future_window=future_window,
        )
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

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        """A host index vector -> int32 tensor on the device (h2d)."""
        return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(self.device)

    def _dequant(self, rows):
        """replica -> master: dequantize written-back rows on the host
        (identity at fp32)."""
        if self.precision == "fp32":
            return rows
        return qz.dequantize_rows_np(rows, self.precision)

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #
    def _stage_plan(self, entry: _InFlight, lookahead: List[np.ndarray]):
        entry.plan = self.planner.plan(entry.ids, lookahead)

    def _stage_collect(self, entry: _InFlight):
        p = entry.plan
        if p.miss_ids.size:
            # host read; master -> replica quantization on the host, so the
            # h2d copy below already moves the small rows
            entry.host_rows = qz.quantize_rows_np(
                self.host.gather(p.miss_ids), self.precision
            )
        if p.evict_slots.size:
            # pad victim reads to the pow-2 bucket (slot 0 is always safe
            # to read); the d2h side slices the real rows back out
            entry.evicted_dev = sp.read(
                self.storage, self._index(pad_index(p.evict_slots, 0))
            )
        self.hbm.read += p.evict_slots.size * self._row_bytes

    def _stage_exchange(self, entry: _InFlight):
        p = entry.plan
        if p.miss_ids.size:  # h2d, both halves of an int8 pair
            entry.fetched_dev = _map_rows(
                lambda r: torch.from_numpy(pad_rows(r)).to(self.device),
                entry.host_rows,
            )
        n_evict = int(p.evict_slots.size)
        if n_evict:  # d2h of the real victims, padding dropped
            entry.evicted_host = _map_rows(
                lambda t: t[:n_evict].cpu().numpy(), entry.evicted_dev
            )
        self.pcie.written += p.miss_ids.size * self._row_bytes
        self.pcie.read += p.evict_slots.size * self._row_bytes

    def _stage_insert_host(self, entry: _InFlight):
        """[Insert], host half: write evicted (dirty, trained) rows back."""
        p = entry.plan
        if p.evict_ids.size:
            self.host.scatter(p.evict_ids, self._dequant(entry.evicted_host))

    def _stage_insert_fill(self, entry: _InFlight):
        """[Insert], device half: fill fetched rows into their slots."""
        p = entry.plan
        if p.fill_slots.size:
            self.storage = sp.fill(
                self.storage,
                self._index(pad_index(p.fill_slots, self.num_slots)),
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
                pad_index(fp.fill_slots, self.num_slots),
                fused_entry.fetched_dev,
                p.slots,
                entry.batch,
            )
            self.hbm.written += fp.fill_slots.size * self._row_bytes
        else:
            self.storage, aux = self.train_fn(self.storage, p.slots, entry.batch)
        # [Train] HBM traffic: gather reads + coalesced scatter read-mod-write
        self.hbm.read += p.slots.size * self._row_bytes
        self.hbm.read += p.n_unique * self._row_bytes
        self.hbm.written += p.n_unique * self._row_bytes
        by_table = None
        if p.hits_by_table is not None:
            by_table = {"hits": p.hits_by_table, "misses": p.misses_by_table}
        st = StepStats(
            step=p.step,
            n_lookups=int(p.slots.size),
            n_unique=p.n_unique,
            n_hits=p.n_hits,
            n_miss=int(p.miss_ids.size),
            n_evict=int(p.evict_slots.size),
            hit_lookups=int(p.slots.size),  # always-hit at [Train] (§IV)
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
        return [
            self._step_sequential(np.asarray(ids), batch) for ids, batch in stream
        ]

    # ------------------------------------------------------------------ #
    def flush_to_host(self):
        """Write every cached (dirty) row back to the host table."""
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
        return {"host": self.host.traffic, "pcie": self.pcie, "hbm": self.hbm}


@register_runtime("scratchpipe")
def _make_scratchpipe(host_table, train_fn, *, num_slots, **kw) -> ScratchPipe:
    return ScratchPipe(host_table, num_slots, train_fn, **kw)


@register_runtime("strawman")
def _make_strawman(host_table, train_fn, *, num_slots, **kw) -> ScratchPipe:
    kw.pop("pipelined", None)
    return ScratchPipe(host_table, num_slots, train_fn, pipelined=False, **kw)
