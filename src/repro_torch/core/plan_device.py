"""Device-resident [Plan] controller: the port of ``repro/core/plan_jax.py``.

Functionally identical to :class:`repro_torch.core.plan.Planner` (the numpy
host controller, LRU) but written as a fixed-shape state transition on
tensors of one device, so the Plan stage runs on the card: the raw ids go
h2d, the dense id -> slot translation feeds [Train] without visiting the
host, and only the miss/fill/evict vectors and five counts come back, in
ONE packed d2h copy per cycle.

``plan_step`` makes no host synchronization on the card: no ``.item()``,
``nonzero``, boolean-mask indexing, ``torch.unique`` or Python scalar
assigned through indexing (``index_fill_`` instead); every data-dependent
count stays a 0-d tensor and every variable-length output is a fixed-shape
vector padded with -1 (the reference's sentinel form). Victims come from
one stable sort of a per-slot priority (eligible slots by ``last_use``,
the rest at int32 max), so ties resolve by slot index exactly as the host
planner's stable argsort.

What differs from the reference, and why:

  * torch has no drop-mode scatter (an out-of-range index raises, on the
    card as a device-side assert), so ``hitmap``, ``slot_to_id``, ``hold``,
    ``last_use`` and the per-cycle slot masks carry ONE trailing dummy
    element that takes every padded write. Index 0 cannot take them: its
    real writes would race with the placeholders (``plan_jax.py:80-85``).
    :func:`state_to_host` drops the dummy, so snapshots have the
    reference's shapes;
  * ``hold`` is int32, not uint32 (torch shifts no uint32). With
    ``past_window`` <= 30 its bits never reach the sign bit, so the
    arithmetic shift equals the reference's logical one; the state
    boundary converts (:func:`state_to_host`, :func:`state_from_host`);
  * ``torch.cumsum`` and ``sum`` of int32 return int64: both are cast back,
    so every output keeps the reference's int32 dtype (``ok`` is bool);
  * the caller's state tensors are not modified: like the reference's
    functional update, ``plan_step`` returns new ones.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import PAD_FLOOR, PinnedCache, pad_len
from repro_torch.device import HostCopy, resolve_device

_I32_MAX = int(np.iinfo(np.int32).max)
_I32 = torch.int32


class PlanState(NamedTuple):
    hitmap: torch.Tensor  # (rows + 1,) int32 id -> slot | -1; [-1] is the dummy
    slot_to_id: torch.Tensor  # (slots + 1,) int32
    hold: torch.Tensor  # (slots + 1,) int32 shift register
    last_use: torch.Tensor  # (slots + 1,) int32
    free_ptr: torch.Tensor  # () int32
    cycle: torch.Tensor  # () int32


def init_state(num_rows: int, num_slots: int, device="cpu") -> PlanState:
    dev = torch.device(device)
    return PlanState(
        hitmap=torch.full((num_rows + 1,), -1, dtype=_I32, device=dev),
        slot_to_id=torch.full((num_slots + 1,), -1, dtype=_I32, device=dev),
        hold=torch.zeros((num_slots + 1,), dtype=_I32, device=dev),
        last_use=torch.zeros((num_slots + 1,), dtype=_I32, device=dev),
        free_ptr=torch.zeros((), dtype=_I32, device=dev),
        cycle=torch.zeros((), dtype=_I32, device=dev),
    )


def _mark(size: int, idx: torch.Tensor) -> torch.Tensor:
    """(size,) bool mask, True at ``idx`` (which may hit the dummy).
    ``index_fill_``, not ``m[idx] = True``: on the card, assigning a Python
    scalar through indexing copies it from the host and synchronizes."""
    m = torch.zeros(size, dtype=torch.bool, device=idx.device)
    return m.index_fill_(0, idx.long(), True)


def plan_step(
    state: PlanState,
    ids: torch.Tensor,  # (n,) int32, -1 padded
    future_ids: torch.Tensor,  # (m,) int32, -1 padded (look-ahead window union)
    *,
    past_window: int = 3,
) -> Tuple[PlanState, dict]:
    """One [Plan] cycle. Returns (new_state, outputs) with fixed-shape
    outputs: slots (n,), fill_slots (n,), miss_ids (n,), evict_ids (n,)
    (-1 padded; fill/evict entries beyond the miss count are -1), and the
    0-d counts ``n_hits``, ``n_unique``, ``ok``, ``n_evict``, ``n_eligible``."""
    if not 0 <= past_window <= 30:
        raise ValueError(f"past_window={past_window}: the int32 hold register "
                         "holds at most 30 past cycles")
    cap = state.slot_to_id.shape[0] - 1  # the dummy slot's index
    num_rows = state.hitmap.shape[0] - 1  # the dummy row's index
    cycle = state.cycle + 1
    hold = state.hold >> 1
    hold_bit = 1 << past_window

    valid = ids >= 0
    safe_ids = torch.where(valid, ids, 0)

    # dedupe within the mini-batch: first occurrence wins
    sorted_ids = torch.sort(torch.where(valid, ids, _I32_MAX)).values
    is_first = sorted_ids != _I32_MAX
    is_first[1:] &= sorted_ids[1:] != sorted_ids[:-1]
    uniq = torch.where(is_first, sorted_ids, -1)  # (n,) unique ids, -1 padded
    uniq_valid = uniq >= 0
    uniq_safe = torch.where(uniq_valid, uniq, 0)

    # hit/miss; padded scatter entries go to the dummy element
    cur_slots = torch.where(uniq_valid, state.hitmap[uniq_safe], -1)
    hit = cur_slots >= 0
    hit_mask = _mark(cap + 1, torch.where(hit, cur_slots, cap))
    hold = torch.where(hit_mask, hold | hold_bit, hold)
    last_use = torch.where(hit_mask, cycle, state.last_use)

    miss = uniq_valid & ~hit  # (n,)
    miss_rank = torch.cumsum(miss, 0).to(_I32) - 1  # rank among misses
    n_miss = miss.sum(dtype=_I32)

    # future-window holds (recomputed fresh, as in the host planner)
    f_valid = future_ids >= 0
    f_slots = torch.where(
        f_valid, state.hitmap[torch.where(f_valid, future_ids, 0)], -1)
    future_held = _mark(cap + 1, torch.where(f_slots >= 0, f_slots, cap))

    # allocation: fresh slots first, then LRU victims among eligible
    n_fresh = torch.minimum(n_miss, cap - state.free_ptr)
    eligible = ((hold[:cap] == 0) & ~future_held[:cap]
                & (state.slot_to_id[:cap] >= 0))
    prio = torch.where(eligible, last_use[:cap], _I32_MAX)
    victim_order = torch.sort(prio, stable=True).indices.to(_I32)  # (slots,)
    n_evict = n_miss - n_fresh
    n_eligible = eligible.sum(dtype=_I32)
    ok = n_evict <= n_eligible  # enough victims? (host planner raises)

    # per-miss slot: fresh if rank < n_fresh else victim[rank - n_fresh]
    fresh_slot = state.free_ptr + miss_rank
    evict_rank = torch.clamp(miss_rank - n_fresh, 0, max(cap - 1, 0))
    victim_slot = victim_order[evict_rank] if cap else evict_rank
    fill_slot = torch.where(miss_rank < n_fresh, fresh_slot, victim_slot)
    fill_slot = torch.where(miss, fill_slot, -1)

    # evicted ids (only for victim allocations)
    is_victim = miss & (miss_rank >= n_fresh)
    evict_slot_safe = torch.where(is_victim, fill_slot, 0)
    evict_ids = torch.where(is_victim, state.slot_to_id[evict_slot_safe], -1)

    # state updates (evict-clear before miss-insert so a row evicted and
    # re-inserted in the same cycle keeps the new slot)
    hitmap = state.hitmap.clone()
    hitmap.index_fill_(0, torch.where(evict_ids >= 0, evict_ids, num_rows).long(), -1)
    hitmap[torch.where(miss, uniq_safe, num_rows)] = fill_slot
    slot_to_id = state.slot_to_id.clone()
    fill_idx = torch.where(miss, fill_slot, cap)
    slot_to_id[fill_idx] = uniq
    fill_mask = _mark(cap + 1, fill_idx)
    hold = torch.where(fill_mask, hold | hold_bit, hold)
    last_use = torch.where(fill_mask, cycle, last_use)

    out_slots = torch.where(valid, hitmap[safe_ids], -1)
    new_state = PlanState(
        hitmap=hitmap,
        slot_to_id=slot_to_id,
        hold=hold,
        last_use=last_use,
        free_ptr=state.free_ptr + n_fresh,
        cycle=cycle,
    )
    outputs = {
        "slots": out_slots,
        "miss_ids": torch.where(miss, uniq, -1),
        "fill_slots": fill_slot,
        "evict_ids": evict_ids,
        "n_hits": hit.sum(dtype=_I32),
        "n_unique": uniq_valid.sum(dtype=_I32),
        "ok": ok,
        "n_evict": torch.clamp(n_evict, min=0),
        "n_eligible": n_eligible,
    }
    return new_state, outputs


def plan_window(
    state: PlanState,
    ids_steps: torch.Tensor,  # (W, n) int32, -1 padded per step
    future_steps: torch.Tensor,  # (W, m) int32, -1 padded per step
    *,
    past_window: int = 3,
) -> Tuple[PlanState, dict]:
    """``W`` consecutive cycles with no return to the host between them;
    outputs are the per-step :func:`plan_step` dicts stacked on a leading
    ``W`` axis (the reference's ``lax.scan``)."""
    outs = []
    for t in range(ids_steps.shape[0]):
        state, out = plan_step(state, ids_steps[t], future_steps[t],
                               past_window=past_window)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# Multi-table wrapper: per-table states over one fused slot space; outputs
# offset into GLOBAL slot/row coordinates.
# ---------------------------------------------------------------------------
def init_group_states(group, budgets: Sequence[int], device="cpu") -> List[PlanState]:
    """One PlanState per table of a TableGroup, sized by its slot budget."""
    if len(budgets) != group.num_tables:
        raise ValueError(f"{len(budgets)} budgets for {group.num_tables} tables")
    return [init_state(spec.rows, int(b), device)
            for spec, b in zip(group.tables, budgets)]


def _offset(x: torch.Tensor, off: int) -> torch.Tensor:
    return torch.where(x >= 0, x + off, -1)


def plan_group_step(
    states: List[PlanState],
    group,
    per_table_ids: Sequence[torch.Tensor],  # local ids per table, -1 padded
    per_table_future: Sequence[torch.Tensor],  # local look-ahead union per table
    *,
    past_window: int = 3,
) -> Tuple[List[PlanState], List[dict]]:
    """One fused [Plan] cycle over every table. ``group`` is a TableGroup or
    any sequence of fused row offsets (len num_tables + 1). Returns
    per-table outputs with ``slots``/``fill_slots`` offset by the table's
    slot-range start and ``miss_ids``/``evict_ids`` into the fused row space
    (-1 padding kept)."""
    offsets = getattr(group, "offsets", group)
    slot_lo = 0
    new_states, outs = [], []
    for t, state in enumerate(states):
        st, out = plan_step(state, per_table_ids[t], per_table_future[t],
                            past_window=past_window)
        row_off = int(offsets[t])
        out = dict(out)
        for k, off in (("slots", slot_lo), ("fill_slots", slot_lo),
                       ("miss_ids", row_off), ("evict_ids", row_off)):
            out[k] = _offset(out[k], off)
        new_states.append(st)
        outs.append(out)
        slot_lo += state.slot_to_id.shape[0] - 1
    return new_states, outs


# ---------------------------------------------------------------------------
# State snapshots (reference shapes and dtypes: no dummy, uint32 hold)
# ---------------------------------------------------------------------------
_STATE_FIELDS = ("hitmap", "slot_to_id", "hold", "last_use", "free_ptr", "cycle")
_HOST_DTYPES = dict(hitmap=np.int32, slot_to_id=np.int32, hold=np.uint32,
                    last_use=np.int32, free_ptr=np.int32, cycle=np.int32)


def state_to_host(state: PlanState) -> Dict[str, np.ndarray]:
    """A host snapshot of a PlanState with the reference's shapes and
    dtypes (the dummy elements dropped, ``hold`` as uint32)."""
    out = {}
    for f in _STATE_FIELDS:
        t = getattr(state, f)
        a = t.cpu().numpy() if t.ndim == 0 else t[:-1].cpu().numpy()
        out[f] = np.array(a, dtype=_HOST_DTYPES[f], copy=True)
    return out


def state_from_host(arrays: Dict[str, np.ndarray], device="cpu") -> PlanState:
    """Rebuild a PlanState on ``device`` from a host snapshot (the dummy
    elements appended)."""
    dev = torch.device(device)

    def vec(a, fill):
        a = np.asarray(a).astype(np.int64)
        if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > _I32_MAX):
            raise ValueError("planner state does not fit int32")
        return torch.from_numpy(np.append(a, fill).astype(np.int32)).to(dev)

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=_I32, device=dev)

    return PlanState(
        hitmap=vec(arrays["hitmap"], -1),
        slot_to_id=vec(arrays["slot_to_id"], -1),
        hold=vec(arrays["hold"], 0),
        last_use=vec(arrays["last_use"], 0),
        free_ptr=scalar(arrays["free_ptr"]),
        cycle=scalar(arrays["cycle"]),
    )


# ---------------------------------------------------------------------------
# The runtime wrapper the pipeline selects with planner="device"
# ---------------------------------------------------------------------------
#: per-table columns of the packed host-facing outputs, after the three
#: (p,) vectors miss_ids, fill_slots, evict_ids
_COUNTS = ("n_hits", "n_unique", "ok", "n_evict", "n_eligible")


def _pack(outs: List[dict]) -> torch.Tensor:
    """(T, 3p + 5) int32: per table miss_ids | fill_slots | evict_ids | the
    five counts. Built on the main thread so materialization is ONE d2h."""
    rows = []
    for o in outs:
        counts = torch.stack([o[k].to(_I32) for k in _COUNTS])
        rows.append(torch.cat([o["miss_ids"], o["fill_slots"], o["evict_ids"], counts]))
    return torch.stack(rows)


class DevicePlanResult:
    """[Plan] outputs of one cycle from the device planner.

    ``slots`` is the DEVICE-resident dense id -> slot translation (the
    input ids' shape): [Train] and the fused forward take it directly, so
    no slot operand goes h2d. The host-facing fields (``miss_ids``,
    ``fill_slots``, ``evict_slots``, ``evict_ids``, the counts) materialize
    lazily on first access from ONE d2h copy of the packed outputs;
    :meth:`start_materialize` enqueues that copy (on the calling thread)
    and hands the wait and the compaction to a worker pool, so they overlap
    [Train]. Fields, order and dtypes equal the host
    :class:`~repro_torch.core.plan.PlanResult`'s."""

    _HOST_FIELDS = ("miss_ids", "fill_slots", "evict_slots", "evict_ids",
                    "n_unique", "n_hits", "hits_by_table", "misses_by_table")
    __slots__ = ("step", "slots", "_packed", "_slot_sizes", "_num_slots",
                 "_window_desc", "_copier", "_future", "_host") + _HOST_FIELDS

    def __init__(self, step, slots, packed, slot_sizes, num_slots, window_desc,
                 copier: HostCopy):
        self.step = step
        self.slots = slots  # device tensor, input-ids shape
        self._packed = packed  # (T, 3p + 5) device tensor
        self._slot_sizes = slot_sizes  # per-table budget (error messages)
        self._num_slots = num_slots
        self._window_desc = window_desc  # "past+1+future" (error messages)
        self._copier = copier
        self._future = None
        self._host = False

    def start_materialize(self, pool, tracer=None) -> None:
        """Enqueue the packed outputs' d2h (here: the caller's thread, the
        one that launches) and submit its wait and the compaction to
        ``pool``; with a tracer they run under a ``plan.materialize`` span
        on the pool's thread."""
        if not self._host and self._future is None:
            pending = self._copier.start(self._packed)
            fn = self._compact
            if tracer is not None:
                fn = tracer.wrap("plan.materialize", fn, cat="d2h")
            self._future = pool.submit(fn, pending)

    def _compact(self, pending) -> dict:
        host = pending.wait()
        p = (host.shape[1] - len(_COUNTS)) // 3
        miss_p, fill_p, ev_slot_p, ev_id_p, hits_t, uniq_t = [], [], [], [], [], []
        for t, row in enumerate(host):
            n_hits, n_unique, ok, n_evict, n_eligible = (int(x) for x in row[3 * p:])
            if not ok:
                # same failure, same words as the host Planner's raise
                raise RuntimeError(
                    f"scratchpad too small: need {n_evict} victims, "
                    f"only {n_eligible} evictable (table {t}: "
                    f"slots={self._slot_sizes[t]} of {self._num_slots}, "
                    f"window={self._window_desc}); size the Storage array "
                    "for the worst-case window working set (paper §VI-D)."
                )
            miss, fill, ev = row[:p], row[p:2 * p], row[2 * p:3 * p]
            m = miss >= 0
            miss_p.append(miss[m])
            fill_p.append(fill[m])
            vm = ev >= 0
            ev_id_p.append(ev[vm])
            ev_slot_p.append(fill[vm])  # a victim's fill slot IS its slot
            hits_t.append(n_hits)
            uniq_t.append(n_unique)
        out = {
            "miss_ids": np.concatenate(miss_p),
            "fill_slots": np.concatenate(fill_p),
            "evict_slots": np.concatenate(ev_slot_p),
            "evict_ids": np.concatenate(ev_id_p),
            "n_hits": sum(hits_t),
            "n_unique": sum(uniq_t),
            "hits_by_table": None,
            "misses_by_table": None,
        }
        if len(host) > 1:
            out["hits_by_table"] = np.asarray(hits_t, np.int64)
            out["misses_by_table"] = np.asarray(
                [u - h for u, h in zip(uniq_t, hits_t)], np.int64)
        return out

    def _materialize(self) -> None:
        if self._host:
            return
        if self._future is not None:
            fut, self._future = self._future, None
            fields = fut.result()
        else:
            fields = self._compact(self._copier.start(self._packed))
        for k, v in fields.items():
            setattr(self, k, v)
        self._packed = None
        self._host = True

    def __getattr__(self, name):
        # first touch of any host-facing field triggers the one d2h
        if name in DevicePlanResult._HOST_FIELDS:
            self._materialize()
            return object.__getattribute__(self, name)
        raise AttributeError(name)


class DevicePlanner:
    """Device-resident [Plan] controller with the host Planner's interface.

    Equal to ``Planner(policy="lru")`` on every output, order included
    (tests/test_torch_device_planner.py). Restrictions against the host
    controller, as in the reference:

    * LRU only;
    * fixed-shape dispatches: ids are padded to a monotone per-planner
      length (pow-2 buckets, or the smallest of ``pad_buckets`` that fits),
      so the kernels see O(log batch) shapes;
    * multi-table (``slot_ranges``) planning needs the standard
      ``(B, num_tables, L)`` id layout where ``ids[:, t, :]`` holds table
      t's global ids (checked on the first batch).
    """

    def __init__(
        self,
        num_rows: int,
        num_slots: int,
        *,
        past_window: int = 3,
        future_window: int = 2,
        policy: str = "lru",
        row_offsets: Optional[Sequence[int]] = None,
        slot_ranges: Optional[Sequence[Tuple[int, int]]] = None,
        pad_buckets: Optional[Sequence[int]] = None,
        device="cuda",
    ):
        if policy != "lru":
            raise ValueError(
                f"device planner supports policy='lru' only (got {policy!r}); "
                "use planner='host' for random/lfu replacement"
            )
        if int(num_rows) > _I32_MAX or int(num_slots) > _I32_MAX:
            raise ValueError(
                f"int32 index path: num_rows={num_rows} / num_slots="
                f"{num_slots} must fit in int32 (< 2**31)"
            )
        self.device = resolve_device(device)
        self.num_rows = int(num_rows)
        self.num_slots = int(num_slots)
        self.past_window = int(past_window)
        self.future_window = int(future_window)
        self.policy = policy
        self.row_offsets = (
            np.asarray(row_offsets, dtype=np.int64)
            if row_offsets is not None
            else np.array([0, self.num_rows], dtype=np.int64)
        )
        self.slot_ranges = (
            [(int(lo), int(hi)) for lo, hi in slot_ranges]
            if slot_ranges is not None
            else [(0, self.num_slots)]
        )
        self.num_tables = len(self.slot_ranges)
        if len(self.row_offsets) != self.num_tables + 1:
            raise ValueError(
                f"row_offsets has {len(self.row_offsets) - 1} tables, "
                f"slot_ranges has {self.num_tables}"
            )
        self._budgets = [hi - lo for lo, hi in self.slot_ranges]
        self._table_rows = np.diff(self.row_offsets)
        self._states: List[PlanState] = [
            init_state(int(r), int(b), self.device)
            for r, b in zip(self._table_rows, self._budgets)
        ]
        self._cycle = 0  # host-side mirror of the device cycle counters
        self._pad_buckets = tuple(sorted(pad_buckets)) if pad_buckets else None
        # monotone pad lengths: one set of shapes per planner even when the
        # stream's batch sizes vary (a shard's id stream, drain cycles)
        self._ids_pad = 0
        self._fut_pad = 0
        self._validated = False
        self._prep = PinnedCache(4 * (self.future_window + 2))
        self._empty_future = torch.full((PAD_FLOOR,), -1, dtype=_I32, device=self.device)
        self._copier = HostCopy(self.device)

    # -- per-batch host prep (id()-memoized across look-ahead sightings) ----
    def _prep_single(self, ids) -> np.ndarray:
        flat = np.asarray(ids, dtype=np.int32).ravel()
        if not self._validated and flat.size:
            if int(flat.min()) < 0 or int(flat.max()) >= self.num_rows:
                raise ValueError(
                    f"ids outside [0, {self.num_rows}) — the device planner "
                    "gathers with clamped indices and would diverge silently"
                )
        return flat

    def _prep_tables(self, ids) -> np.ndarray:
        arr = np.asarray(ids, dtype=np.int64)
        T = self.num_tables
        if arr.ndim != 3 or arr.shape[1] != T:
            raise ValueError(
                f"device planner with {T} tables needs (B, {T}, L) ids "
                f"(got shape {arr.shape}); use planner='host' for "
                "non-standard id layouts"
            )
        loc = (arr - self.row_offsets[:-1][None, :, None]).transpose(1, 0, 2)
        loc = np.ascontiguousarray(loc.reshape(T, -1)).astype(np.int32)
        if not self._validated:
            for t in range(T):
                if loc[t].size and (
                    int(loc[t].min()) < 0
                    or int(loc[t].max()) >= int(self._table_rows[t])
                ):
                    raise ValueError(
                        f"ids[:, {t}, :] outside table {t}'s row range — the "
                        "device planner requires the standard (B, T, L) "
                        "layout; use planner='host' otherwise"
                    )
        return loc

    def _pad_to(self, n: int, attr: str) -> int:
        p = max(pad_len(n, self._pad_buckets), getattr(self, attr))
        setattr(self, attr, p)
        return p

    def _upload(self, parts: List[np.ndarray], attr: str) -> torch.Tensor:
        """(T, width) blocks concatenated along the width and -1 padded to
        the monotone length, copied h2d from pinned memory (asynchronously
        on the card: no wait for the stream's earlier work)."""
        width = sum(x.shape[1] for x in parts)
        up = np.full((parts[0].shape[0], self._pad_to(width, attr)), -1, np.int32)
        o = 0
        for x in parts:
            up[:, o:o + x.shape[1]] = x
            o += x.shape[1]
        t = torch.from_numpy(up)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- the [Plan] cycle ----------------------------------------------------
    def plan(self, ids, future_batches=None) -> DevicePlanResult:
        self._cycle += 1
        window_desc = f"{self.past_window}+1+{self.future_window}"
        futures = (
            list(future_batches[: self.future_window])
            if self.future_window and future_batches
            else []
        )
        prep = self._prep_single if self.num_tables == 1 else self._prep_tables

        def block(x):  # (T, width) local ids of one batch
            b = self._prep.get(x, prep)
            return b[None] if b.ndim == 1 else b

        blk = block(ids)
        self._validated = True
        width = blk.shape[1]
        dev_ids = self._upload([blk], "_ids_pad")  # raw ids h2d
        if futures:
            dev_fut = self._upload([block(fb) for fb in futures], "_fut_pad")
            per_fut = list(dev_fut)
        else:
            per_fut = [self._empty_future] * self.num_tables
        self._states, outs = plan_group_step(
            self._states, self.row_offsets, list(dev_ids), per_fut,
            past_window=self.past_window,
        )
        shape = np.asarray(ids).shape
        if self.num_tables == 1:
            slots = outs[0]["slots"][:width].reshape(shape)
        else:
            B, _, L = shape
            slots = torch.stack(
                [o["slots"][:width].reshape(B, L) for o in outs], dim=1
            )  # (B, T, L) global slots, device-resident
        return DevicePlanResult(
            self._cycle, slots, _pack(outs), self._budgets, self.num_slots,
            window_desc, self._copier,
        )

    # -- stats / state the runtimes read ------------------------------------
    @property
    def occupancy(self) -> int:
        return int(sum(int((s.slot_to_id[:-1] >= 0).sum()) for s in self._states))

    @property
    def slot_to_id(self) -> np.ndarray:
        """Fused-coordinate slot -> row map (one d2h per table per call):
        slot indices and row ids global — what ``flush_to_host`` walks."""
        out = np.full(self.num_slots, -1, np.int32)
        for t, st in enumerate(self._states):
            lo, hi = self.slot_ranges[t]
            s2i = st.slot_to_id[:-1].cpu().numpy()
            m = s2i >= 0
            seg = out[lo:hi]
            seg[m] = (s2i[m].astype(np.int64) + self.row_offsets[t]).astype(np.int32)
        return out

    # -- checkpoint / resume -------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for t, st in enumerate(self._states):
            for k, v in state_to_host(st).items():
                out[f"t{t}_{k}"] = v
        return out

    def load_state_dict(self, st: Dict[str, np.ndarray]) -> None:
        states = []
        for t in range(self.num_tables):
            try:
                arrays = {f: st[f"t{t}_{f}"] for f in _STATE_FIELDS}
            except KeyError as e:
                raise ValueError(
                    "incompatible device-planner checkpoint: missing "
                    f"{e.args[0]!r} (host-planner checkpoints do not load "
                    "into planner='device' runs and vice versa)"
                ) from None
            states.append(state_from_host(arrays, self.device))
        self._states = states
        self._cycle = int(np.asarray(st["t0_cycle"]))
        self._prep.clear()
