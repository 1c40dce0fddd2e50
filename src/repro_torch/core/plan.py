"""[Plan] stage: HitMap + hold masks + victim selection (paper §IV-C/D).

Port of ``repro/core/plan.py``, copied unchanged (the planner is numpy in
both packages): the same id stream gives the same slots and the same order
of misses, fills, evictions and victims (tests/test_torch_plan.py).

Vectorized (numpy) implementation of Algorithm 1, adapted per DESIGN.md:
instead of iterating sparse IDs one-by-one, hits/misses are resolved with a
batched lookup and victims are allocated with a single masked argpartition.

Data structures (names follow the paper):
  * HitMap     — key->slot store. Implemented as a direct-mapped int32 array
                 over the global row space (the fastest software realization
                 of the paper's (key, value) store).
  * Hold mask  — per-slot W-bit shift register (W = past + 1 cycles). A bit
                 is set when a mini-batch touching the slot passes [Plan];
                 it shifts right every cycle, so the slot stays unevictable
                 exactly while that mini-batch is in flight (RAW-2/3).
  * Future holds — recomputed every cycle from the next ``future`` look-ahead
                 mini-batches' HitMap hits (RAW-4). Their misses occupy no
                 slot yet, so they cannot be victims by construction.

The HitMap is updated at [Plan] time — deliberately *ahead* of the Storage
array (paper Fig. 11): it always reflects the cache state as of the oldest
in-flight batch's [Train] completing.

Zero-redundancy fast path (wall-clock tentpole):
  * **Plan digests.** A mini-batch travels through the look-ahead window
    ``future_window + 1`` times (as look-ahead, then as the current batch),
    and the naive controller re-runs ``np.unique`` on it each time. A digest
    (flattened int32 ids + unique ids + the HitMap probe of those uniques)
    is computed once per batch object and memoized; the probe carries the
    HitMap version it was taken at, so it is reused bit-identically whenever
    the HitMap has not changed (every zero-miss cycle) and recomputed — over
    the cached uniques only — when it has. Memoization keys on the identity
    of the ids array, which the cache pins; callers must not mutate a batch
    array in place after passing it (the serving runtimes and every stream
    in ``repro_torch.traces`` hand over fresh arrays).
  * **Lazy eligibility.** Future holds and the evictable mask are only
    needed when a table actually has to evict; on zero-miss / fresh-slot
    cycles the whole O(num_slots) sweep is skipped. When needed, the mask is
    built in preallocated scratch buffers (no fresh num_slots allocations
    per cycle) and future holds are applied as index assignments.

All index arrays (slots / fill / evict / ids) are int32 end-to-end — half
the h2d bytes and planner memory traffic; ``num_rows``/``num_slots`` are
guarded against int32 overflow at construction.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

_INT32_MAX = np.iinfo(np.int32).max

# ---------------------------------------------------------------------------
# Shared operand-padding helpers (host planner, device planner, pipeline,
# static cache). Variable-length device operands (fill/evict indices, fetched
# rows) are padded to a bounded set of lengths. The reference pads so that the
# number of distinct XLA executables stays O(log batch); the port keeps the
# same padding so its fill kernel sees the reference's operands, drop
# sentinels included. The default scheme is pow-2 buckets with a floor;
# callers may pass an explicit ``buckets`` set which is tried first, falling
# back to pow-2 beyond its largest entry.
# ---------------------------------------------------------------------------

# Smallest padded operand length. Collapsing every small fill/evict into one
# bucket matters more than the wasted lanes: each DISTINCT device operand
# shape costs a full XLA compile, and ramp-up/drain cycles otherwise produce
# a trickle of one-off tiny sizes. 256 rows x 128 B = 32 KB of slack, dwarfed
# by one avoided compile.
PAD_FLOOR = 256


def pad_len(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Padded length for an ``n``-element device operand: the smallest
    adaptive bucket that fits (when ``buckets`` is given), else the pow-2
    bucket with the :data:`PAD_FLOOR` floor."""
    if buckets:
        for b in buckets:
            if n <= b:
                return int(b)
    return max(PAD_FLOOR, 1 << max(n - 1, 0).bit_length())


def pad_index(
    idx: np.ndarray, sentinel: int, buckets: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Pad an index vector to its bucket with a positive out-of-bounds
    sentinel (drop-mode scatters discard it; negative would WRAP in jax)."""
    n = idx.size
    p = pad_len(n, buckets)
    if p == n:
        return idx
    out = np.full(p, sentinel, dtype=idx.dtype)
    out[:n] = idx
    return out


def pad_rows(rows: np.ndarray, buckets: Optional[Sequence[int]] = None) -> np.ndarray:
    """Pad a (n, dim) row block to its bucket with zero rows."""
    n = rows.shape[0]
    p = pad_len(n, buckets)
    if p == n:
        return rows
    out = np.zeros((p,) + rows.shape[1:], dtype=rows.dtype)
    out[:n] = rows
    return out


class PinnedCache:
    """Small LRU cache keyed on *array identity*: ``get(ref, build)`` returns
    the cached value for the exact object ``ref``, building (and pinning
    ``ref`` so its id() cannot be recycled) on first sight. This is the
    memoization substrate both [Plan] controllers share — the host planner's
    batch digests and the device planner's per-batch prepped id blocks: a
    mini-batch travels through the look-ahead window ``future_window + 1``
    times, and the per-batch preprocessing should run once, not once per
    sighting. Callers must not mutate a batch array in place after passing
    it (every stream in ``repro_torch.traces`` hands over fresh arrays)."""

    __slots__ = ("_keep", "_entries", "hits", "misses")

    def __init__(self, keep: int):
        self._keep = int(keep)
        self._entries: "collections.OrderedDict[int, Tuple[Any, Any]]" = (
            collections.OrderedDict()
        )
        # Unconditional int counters (same discipline as HostTraffic):
        # read lazily by the obs layer's memo-hit-rate gauges at snapshot
        # time, so they cost one int add with or without metrics on.
        self.hits = 0
        self.misses = 0

    def get(self, ref: Any, build: Callable[[Any], Any]) -> Any:
        key = id(ref)
        hit = self._entries.get(key)
        if hit is not None and hit[0] is ref:
            self.hits += 1
            self._entries.move_to_end(key)
            return hit[1]
        self.misses += 1
        val = build(ref)
        self._entries[key] = (ref, val)
        while len(self._entries) > self._keep:
            self._entries.popitem(last=False)
        return val

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class PlanResult:
    """Everything later stages need for one mini-batch."""

    step: int
    slots: np.ndarray  # slot for every input id (dense, same shape as ids)
    miss_ids: np.ndarray  # unique row ids to [Collect] from the host table
    fill_slots: np.ndarray  # Storage slots the missed rows go to ([Insert])
    evict_slots: np.ndarray  # slots read out as victims ([Collect], device)
    evict_ids: np.ndarray  # row ids written back to host ([Insert])
    n_unique: int = 0
    n_hits: int = 0
    # per-table breakdowns (None for the 1-table degenerate case)
    hits_by_table: Optional[np.ndarray] = None
    misses_by_table: Optional[np.ndarray] = None


def _select_victims(vals: np.ndarray, cand: np.ndarray, n_evict: int) -> np.ndarray:
    """First ``n_evict`` candidates ordered by (priority value, slot index) —
    bit-identical to ``cand[np.argsort(vals, kind="stable")[:n_evict]]`` but
    O(cand) via argpartition instead of O(cand log cand): the full sort of
    every evictable slot was the planner's hottest line at scale. Ties at
    the cutoff value are resolved by slot index, exactly as the stable sort
    does (``cand`` is ascending by construction)."""
    if n_evict >= vals.size:
        return cand[np.argsort(vals, kind="stable")]
    kth = np.partition(vals, n_evict - 1)[n_evict - 1]
    less = np.flatnonzero(vals < kth)
    eq = np.flatnonzero(vals == kth)[: n_evict - less.size]
    sel = np.concatenate([less, eq])
    # order the small selected subset by (value, position); within-group
    # position order is already ascending, so the stable sort reproduces
    # the full stable argsort's prefix exactly
    return cand[sel[np.argsort(vals[sel], kind="stable")]]


class _BatchDigest:
    """Memoized per-batch [Plan] inputs: int32 flat ids, their uniques, and
    the HitMap probe of the uniques (tagged with the HitMap version it was
    taken at). Cached in a :class:`PinnedCache`, which pins the source array
    so its id() cannot be reused while the digest is live."""

    __slots__ = ("flat", "uniq", "probe", "probe_version")

    def __init__(self, flat, uniq):
        self.flat = flat
        self.uniq = uniq
        self.probe = None
        self.probe_version = -1


class Planner:
    """[Plan] controller over the fused row space of a TableGroup.

    ``row_offsets``/``slot_ranges`` partition the row space and the slot
    space per table: each table's misses allocate only from its own slot
    budget, so one table's burst cannot evict another table's rows. Both
    default to a single all-covering partition — the pre-TableGroup
    single-table behavior, bit-for-bit.

    ``memoize=False`` disables the digest cache (every call recomputes
    unique/probe from scratch — the pre-fast-path behavior, kept for the
    identity tests and as an escape hatch for callers that mutate batch
    arrays in place).
    """

    def __init__(
        self,
        num_rows: int,
        num_slots: int,
        *,
        past_window: int = 3,
        future_window: int = 2,
        policy: str = "lru",
        seed: int = 0,
        row_offsets: Optional[Sequence[int]] = None,
        slot_ranges: Optional[Sequence[Tuple[int, int]]] = None,
        memoize: bool = True,
    ):
        if policy not in ("lru", "random", "lfu"):
            raise ValueError(f"unknown replacement policy {policy!r}")
        if int(num_rows) > _INT32_MAX or int(num_slots) > _INT32_MAX:
            raise ValueError(
                f"int32 index path: num_rows={num_rows} / num_slots="
                f"{num_slots} must fit in int32 (< 2**31); shard the row "
                "space (ShardedScratchPipe) before growing past that"
            )
        self.num_rows = int(num_rows)
        self.num_slots = int(num_slots)
        self.past_window = int(past_window)
        self.future_window = int(future_window)
        self.policy = policy
        self.memoize = bool(memoize)
        self._rng = np.random.default_rng(seed)

        # per-table partition of the row space and the slot space
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
        if int(self.row_offsets[-1]) != self.num_rows:
            raise ValueError("row_offsets must end at num_rows")
        for t in range(self.num_tables - 1):
            if self.slot_ranges[t][1] != self.slot_ranges[t + 1][0]:
                raise ValueError("slot_ranges must be contiguous and ordered")
        if self.slot_ranges[-1][1] > self.num_slots:
            raise ValueError("slot_ranges exceed num_slots")

        self.hitmap = np.full(self.num_rows, -1, dtype=np.int32)  # id -> slot
        self.slot_to_id = np.full(self.num_slots, -1, dtype=np.int32)
        self.hold = np.zeros(self.num_slots, dtype=np.uint32)  # shift register
        self.last_use = np.zeros(self.num_slots, dtype=np.int64)  # lru
        self.use_count = np.zeros(self.num_slots, dtype=np.int64)  # lfu
        # per-table pointer into slots never allocated yet
        self._free_ptrs = np.array(
            [lo for lo, _ in self.slot_ranges], dtype=np.int64
        )
        self._cycle = 0
        # W-bit window: past mini-batches + the current one
        self._hold_bit = np.uint32(1 << self.past_window)

        # zero-redundancy machinery: digest cache + preallocated scratch
        self._hitmap_version = 0
        self._digests = PinnedCache(4 * (self.future_window + 2))
        self._eligible_buf = np.empty(self.num_slots, dtype=bool)
        self._occupied_buf = np.empty(self.num_slots, dtype=bool)

    @property
    def _free_ptr(self) -> int:
        """Single-table free pointer (degenerate-case convenience)."""
        return int(self._free_ptrs[0])

    # -- stats ---------------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return int(np.sum(self.slot_to_id >= 0))

    # -- checkpointing (host state; resumes must see identical schedules) ----
    def state_dict(self) -> dict:
        return {
            "hitmap": self.hitmap,
            "slot_to_id": self.slot_to_id,
            "hold": self.hold,
            "last_use": self.last_use,
            "use_count": self.use_count,
            "cycle": np.array([self._cycle], np.int64),
            "free_ptrs": np.asarray(self._free_ptrs, np.int64),
        }

    def load_state_dict(self, st: dict) -> None:
        self.hitmap = np.asarray(st["hitmap"], np.int32)
        self.slot_to_id = np.asarray(st["slot_to_id"], np.int32)
        self.hold = np.asarray(st["hold"], np.uint32)
        self.last_use = np.asarray(st["last_use"], np.int64)
        self.use_count = np.asarray(st["use_count"], np.int64)
        self._digests.clear()
        self._hitmap_version += 1
        if "free_ptrs" not in st:
            if "scalars" in st and self.num_tables == 1:
                # pre-TableGroup checkpoint: scalars = [free_ptr, cycle]
                fp, cyc = (int(x) for x in np.asarray(st["scalars"], np.int64))
                self._cycle = cyc
                self._free_ptrs = np.array([fp], np.int64)
                return
            raise ValueError(
                "incompatible planner checkpoint: expected 'free_ptrs'/'cycle' "
                "(or a legacy single-table 'scalars' entry)"
            )
        self._cycle = int(np.asarray(st["cycle"], np.int64)[0])
        self._free_ptrs = np.asarray(st["free_ptrs"], np.int64).copy()
        if len(self._free_ptrs) != self.num_tables:
            raise ValueError(
                f"checkpoint has {len(self._free_ptrs)} table free-pointers, "
                f"planner has {self.num_tables} tables"
            )

    # -- plan digests --------------------------------------------------------
    @staticmethod
    def _build_digest(ids) -> _BatchDigest:
        flat = np.asarray(ids, dtype=np.int32).ravel()
        return _BatchDigest(flat, np.unique(flat))

    def _digest(self, ids) -> _BatchDigest:
        """Digest of one batch object, memoized on array identity."""
        return self._digests.get(ids, self._build_digest)

    def _probe(self, d: _BatchDigest) -> np.ndarray:
        """HitMap lookup of a digest's uniques, reused while the HitMap is
        unchanged (bit-identical by construction: same map, same keys)."""
        if d.probe_version != self._hitmap_version:
            d.probe = self.hitmap[d.uniq]
            d.probe_version = self._hitmap_version
        return d.probe

    def plan(
        self, ids: np.ndarray, future_batches: Optional[List[np.ndarray]] = None
    ) -> PlanResult:
        """Run [Plan] for one mini-batch. ``ids``: any-shape int array of row
        ids. ``future_batches``: look-ahead ids of the next `future_window`
        mini-batches (RAW-4 exclusion)."""
        self._cycle += 1
        if self.memoize:
            d = self._digest(ids)
            flat, uniq = d.flat, d.uniq
            slots_u = self._probe(d)
        else:
            flat = np.asarray(ids, dtype=np.int32).ravel()
            uniq = np.unique(flat)
            slots_u = self.hitmap[uniq]

        # Step B (Algorithm 1): advance the hold shift register by one cycle.
        self.hold >>= 1

        # Step C: batched hit/miss resolution.
        hit_mask = slots_u >= 0
        hit_slots = slots_u[hit_mask]
        self.hold[hit_slots] |= self._hold_bit
        self.last_use[hit_slots] = self._cycle
        self.use_count[hit_slots] += 1

        miss_ids = uniq[~hit_mask]
        n_miss = miss_ids.size

        # Lazy eligibility: future holds + the evictable mask cost O(slots)
        # and are only needed when some table must evict — zero-miss and
        # fresh-slot cycles skip the sweep entirely. Computed at most once
        # per plan() call, into preallocated buffers; values are identical
        # to the eager path (the HitMap/hold state they read is not mutated
        # until after the allocation loop).
        future_list = (
            future_batches[: self.future_window]
            if self.future_window and future_batches
            else ()
        )
        eligible: Optional[np.ndarray] = None

        def get_eligible() -> np.ndarray:
            nonlocal eligible
            if eligible is None:
                eligible = self._eligible_buf
                np.equal(self.hold, 0, out=eligible)
                np.greater_equal(self.slot_to_id, 0, out=self._occupied_buf)
                eligible &= self._occupied_buf
                for fb in future_list:
                    if self.memoize:
                        fslots = self._probe(self._digest(fb))
                    else:
                        fslots = self.hitmap[
                            np.unique(np.asarray(fb, np.int32).ravel())
                        ]
                    fslots = fslots[fslots >= 0]
                    eligible[fslots] = False  # future holds (RAW-4)
            return eligible

        # Per-table allocation: fresh slots first, then victims with hold==0,
        # each table confined to its own slot budget. ``miss_ids`` is sorted
        # and table row ranges never interleave, so each table's misses are
        # one contiguous segment — per-table fill arrays concatenated in
        # table order stay aligned with ``miss_ids``.
        seg = np.searchsorted(miss_ids, self.row_offsets)
        fill_parts: List[np.ndarray] = []
        victim_parts: List[np.ndarray] = []
        for t in range(self.num_tables):
            n_miss_t = int(seg[t + 1] - seg[t])
            if n_miss_t == 0:
                continue
            lo, hi = self.slot_ranges[t]
            n_fresh = min(n_miss_t, hi - int(self._free_ptrs[t]))
            fresh = np.arange(
                self._free_ptrs[t], self._free_ptrs[t] + n_fresh, dtype=np.int32
            )
            self._free_ptrs[t] += n_fresh
            n_evict = n_miss_t - n_fresh
            if n_evict > 0:
                cand = np.flatnonzero(get_eligible()[lo:hi]).astype(np.int32) + lo
                if cand.size < n_evict:
                    raise RuntimeError(
                        f"scratchpad too small: need {n_evict} victims, "
                        f"only {cand.size} evictable (table {t}: "
                        f"slots={hi - lo} of {self.num_slots}, "
                        f"window={self.past_window}+1+{self.future_window}); "
                        "size the Storage array for the worst-case window "
                        "working set (paper §VI-D)."
                    )
                if self.policy == "lru":
                    victims_t = _select_victims(
                        self.last_use[cand], cand, n_evict
                    )
                elif self.policy == "lfu":
                    victims_t = _select_victims(
                        self.use_count[cand], cand, n_evict
                    )
                else:  # random
                    order = self._rng.choice(cand.size, size=n_evict, replace=False)
                    victims_t = cand[order]
                victim_parts.append(victims_t)
                fill_parts.append(np.concatenate([fresh, victims_t]))
            else:
                fill_parts.append(fresh)
        victims = (
            np.concatenate(victim_parts)
            if victim_parts
            else np.empty(0, dtype=np.int32)
        )
        evict_ids = self.slot_to_id[victims]
        fill_slots = (
            np.concatenate(fill_parts) if fill_parts else np.empty(0, np.int32)
        )

        # HitMap updated at [Plan] time (ahead of Storage — paper Fig. 11).
        if evict_ids.size:
            self.hitmap[evict_ids] = -1
        if n_miss:
            self.hitmap[miss_ids] = fill_slots
            self.slot_to_id[fill_slots] = miss_ids
            self.hold[fill_slots] |= self._hold_bit
            self.last_use[fill_slots] = self._cycle
            self.use_count[fill_slots] = 1
            self._hitmap_version += 1  # cached probes are now stale

        # Dense per-input slot mapping (what [Train] gathers with).
        slots = self.hitmap[flat].reshape(np.asarray(ids).shape)
        hits_by_table = misses_by_table = None
        if self.num_tables > 1:
            misses_by_table = np.diff(seg).astype(np.int64)
            hit_ids = uniq[hit_mask]
            hits_by_table = np.diff(
                np.searchsorted(hit_ids, self.row_offsets)
            ).astype(np.int64)
        return PlanResult(
            step=self._cycle,
            slots=slots,
            miss_ids=miss_ids,
            fill_slots=fill_slots,
            evict_slots=victims,
            evict_ids=evict_ids,
            n_unique=int(uniq.size),
            n_hits=int(hit_mask.sum()),
            hits_by_table=hits_by_table,
            misses_by_table=misses_by_table,
        )
