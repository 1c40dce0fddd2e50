"""TableGroup: a named collection of embedding tables behind one fused array.

Port of ``repro/core/table_group.py``, copied unchanged (numpy only).

DLRMs have dozens of embedding tables with heterogeneous row counts and hot
set sizes; the paper's cache managers treat each table's lookup stream as
the unit of caching (per-table HitMap / Storage partition), while the host
keeps every table in one arena. ``TableGroup`` is the single source of truth
for that layout across the whole stack:

  * the host tier stores one fused ``(total_rows, dim)`` array; table ``t``
    owns rows ``[offset[t], offset[t+1])`` (ranges never interleave);
  * global row id = ``offset[t] + local_id`` — the bijection every layer
    (trace generator, planner, runtimes, model) shares;
  * the scratchpad slot space is partitioned into per-table budgets
    (proportional to each table's expected hot set), so one table's burst
    can never evict another table's held rows.

A single-table group is the exact degenerate case: one row range, one slot
range — the planner and runtimes behave bit-identically to the ungrouped
path (asserted for the reference in tests/test_table_group.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.quantize import SLOT_MULTIPLIER, check_precision


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table: row count, embedding dim, expected hot fraction
    (used only for slot budgeting; 0.05 matches the paper's cache sizing),
    and the scratchpad replica ``precision`` (``fp32|fp16|int8`` — the HOST
    master rows are always fp32; see core/quantize.py)."""

    name: str
    rows: int
    dim: int
    hot_fraction: float = 0.05
    precision: str = "fp32"

    def __post_init__(self):
        if self.rows <= 0:
            raise ValueError(f"table {self.name!r}: rows must be > 0")
        if not (0.0 < self.hot_fraction <= 1.0):
            raise ValueError(f"table {self.name!r}: hot_fraction in (0, 1]")
        check_precision(self.precision)


class TableGroup:
    """Ordered collection of :class:`TableSpec` sharing one embedding dim,
    fused into a single global row space."""

    def __init__(self, tables: Sequence[TableSpec]):
        if not tables:
            raise ValueError("TableGroup needs at least one table")
        dims = {t.dim for t in tables}
        if len(dims) != 1:
            raise ValueError(f"all tables must share one dim, got {sorted(dims)}")
        names = [t.name for t in tables]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names: {names}")
        self.tables: Tuple[TableSpec, ...] = tuple(tables)
        self.offsets = np.concatenate(
            [[0], np.cumsum([t.rows for t in self.tables], dtype=np.int64)]
        )

    # -- constructors --------------------------------------------------------
    @classmethod
    def uniform(
        cls, num_tables: int, rows_per_table: int, dim: int, *,
        hot_fraction: float = 0.05, prefix: str = "table",
        precision: str = "fp32",
    ) -> "TableGroup":
        return cls(
            [
                TableSpec(
                    f"{prefix}{t}", rows_per_table, dim, hot_fraction,
                    precision,
                )
                for t in range(num_tables)
            ]
        )

    @classmethod
    def from_config(cls, cfg) -> "TableGroup":
        """Build from a DLRMConfig (uses ``table_rows`` when set, else a
        uniform ``num_tables x rows_per_table`` layout)."""
        rows = getattr(cfg, "table_rows", None) or (
            (cfg.rows_per_table,) * cfg.num_tables
        )
        frac = getattr(cfg, "cache_fraction", 0.05)
        precision = getattr(cfg, "precision", "fp32")
        return cls(
            [
                TableSpec(f"table{t}", r, cfg.embed_dim, frac, precision)
                for t, r in enumerate(rows)
            ]
        )

    # -- shape ----------------------------------------------------------------
    @property
    def num_tables(self) -> int:
        return len(self.tables)

    @property
    def total_rows(self) -> int:
        return int(self.offsets[-1])

    @property
    def dim(self) -> int:
        return self.tables[0].dim

    @property
    def rows(self) -> Tuple[int, ...]:
        return tuple(t.rows for t in self.tables)

    @property
    def precisions(self) -> Tuple[str, ...]:
        return tuple(t.precision for t in self.tables)

    def with_precision(self, precision: str) -> "TableGroup":
        """A copy of this group with every table's replica precision
        replaced — how a trace-manifest group (always recorded fp32) is
        re-targeted at a reduced-precision run."""
        check_precision(precision)
        return TableGroup(
            [dataclasses.replace(t, precision=precision) for t in self.tables]
        )

    def uniform_precision(self) -> str:
        """The single replica precision shared by every table. One fused
        scratchpad array holds one dtype, so the single-storage runtimes
        require this to be uniform; mixed per-table precisions are only
        realizable by the sharded runtime (one scratchpad per shard)."""
        ps = set(self.precisions)
        if len(ps) != 1:
            raise ValueError(
                "mixed per-table precisions "
                f"{list(self.precisions)} need one scratchpad per table — "
                "use ShardedScratchPipe.from_group (a single fused "
                "scratchpad array holds one precision)"
            )
        return next(iter(ps))

    def __len__(self) -> int:
        return len(self.tables)

    def __repr__(self) -> str:
        rows = ",".join(str(t.rows) for t in self.tables)
        return f"TableGroup({self.num_tables} tables, rows=[{rows}], dim={self.dim})"

    # -- id mapping -----------------------------------------------------------
    def to_global(self, table: int, local_ids: np.ndarray) -> np.ndarray:
        """Local row ids of one table -> fused global row ids."""
        return np.asarray(local_ids, dtype=np.int64) + self.offsets[table]

    def table_of(self, global_ids: np.ndarray) -> np.ndarray:
        """Fused global row ids -> owning table index."""
        gid = np.asarray(global_ids, dtype=np.int64)
        return np.searchsorted(self.offsets, gid, side="right") - 1

    def to_local(self, global_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Fused global row ids -> (table index, local row id)."""
        gid = np.asarray(global_ids, dtype=np.int64)
        t = self.table_of(gid)
        return t, gid - self.offsets[t]

    def globalize(self, per_table_ids: np.ndarray) -> np.ndarray:
        """(B, T, L) per-table local ids -> (B, T, L) global ids."""
        ids = np.asarray(per_table_ids, dtype=np.int64)
        if ids.ndim != 3 or ids.shape[1] != self.num_tables:
            raise ValueError(
                f"expected (B, {self.num_tables}, L) ids, got {ids.shape}"
            )
        return ids + self.offsets[:-1][None, :, None]

    def split(self, global_ids: np.ndarray) -> List[np.ndarray]:
        """Flatten global ids and split into per-table LOCAL id arrays
        (the per-table lookup streams; order within a table preserved)."""
        flat = np.asarray(global_ids, dtype=np.int64).ravel()
        t = self.table_of(flat)
        return [flat[t == i] - self.offsets[i] for i in range(self.num_tables)]

    def row_slice(self, table: int) -> slice:
        """Fused-array row range owned by ``table`` (zero-copy view slice)."""
        return slice(int(self.offsets[table]), int(self.offsets[table + 1]))

    # -- scratchpad budgeting -------------------------------------------------
    def slot_budgets(self, num_slots: int, min_per_table: int = 1) -> List[int]:
        """Partition ``num_slots`` scratchpad slots into per-table budgets:
        every table gets at least ``min_per_table`` slots (capped at its row
        count — pass the table's worst-case 6-batch window working set for
        the paper's §VI-D sizing rule), and the remaining slots are split
        proportionally to each table's expected hot set
        (rows * hot_fraction), largest-remainder rounded."""
        mins = np.array(
            [max(1, min(int(min_per_table), t.rows)) for t in self.tables],
            dtype=np.int64,
        )
        if num_slots < int(mins.sum()):
            raise ValueError(
                f"{num_slots} slots cannot cover the per-table floors "
                f"{mins.tolist()} (sum {int(mins.sum())})"
            )
        extra = num_slots - int(mins.sum())
        weights = np.array(
            [t.rows * t.hot_fraction for t in self.tables], dtype=np.float64
        )
        ideal = weights / weights.sum() * extra
        caps = np.array([t.rows for t in self.tables], dtype=np.int64)
        # a table can never occupy more slots than it has rows
        budgets = np.minimum(mins + np.floor(ideal).astype(np.int64), caps)
        # largest-remainder distribution of the leftover slots, respecting
        # the row-count caps (surplus beyond sum(rows) stays unassigned)
        rem = num_slots - int(budgets.sum())
        order = np.argsort(-(ideal - np.floor(ideal)), kind="stable")
        i = 0
        while rem > 0 and np.any(budgets < caps):
            t = order[i % self.num_tables]
            if budgets[t] < caps[t]:
                budgets[t] += 1
                rem -= 1
            i += 1
        return [int(b) for b in budgets]

    def precision_slot_budgets(
        self, num_slots: int, min_per_table: int = 1
    ) -> List[int]:
        """Byte-budget slot accounting: ``num_slots`` is denominated in
        fp32-row payload bytes; each table's proportional share is then
        converted to ROWS through its own replica precision
        (fp16 packs 2x, int8 4x rows into the same bytes). Sum of the
        returned budgets times per-row payload bytes equals the fp32
        budget's payload bytes; the int8 scale column rides on top and is
        reported by ``scratchpad.storage_bytes`` (not credited here)."""
        budgets = self.slot_budgets(num_slots, min_per_table)
        return [
            int(b) * SLOT_MULTIPLIER[t.precision]
            for b, t in zip(budgets, self.tables)
        ]

    def window_floor(self, batch_lookups: int, window: int = 6) -> int:
        """Paper §VI-D worst-case window working set per table: ``window``
        in-flight mini-batches each touching at most ``batch_lookups``
        distinct rows of the table."""
        return int(window * batch_lookups)

    def slot_ranges(self, budgets: Sequence[int]) -> List[Tuple[int, int]]:
        """Per-table contiguous (lo, hi) slot ranges from budgets."""
        bounds = np.concatenate([[0], np.cumsum(np.asarray(budgets, np.int64))])
        return [
            (int(bounds[t]), int(bounds[t + 1])) for t in range(self.num_tables)
        ]


def single_table(rows: int, dim: int, *, hot_fraction: float = 0.05) -> TableGroup:
    """The degenerate 1-table group (the pre-TableGroup code path)."""
    return TableGroup([TableSpec("table0", rows, dim, hot_fraction)])
