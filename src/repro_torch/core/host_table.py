"""Capacity-tier ("CPU DRAM") embedding table.

Port of ``repro/core/host_table.py``: the host tier is numpy in both
packages, and the same ``seed`` builds the same table bit for bit
(tests/test_torch_plan.py). One change: the rows are drawn in blocks
(``normal_rows``), the same values without the reference's two (rows, dim)
float64 transients, 16 bytes a value.

The paper keeps the full embedding tables in slow/large CPU memory; gathers
and scatters against it are the bottleneck ScratchPipe removes from the
critical path. Byte counters feed the calibrated bandwidth model used by the
paper-figure benchmarks.

Integrity guard (opt-in): ``enable_guard()`` keeps a per-row XOR checksum
of the table. Every ``gather`` verifies the rows it reads and every
``scatter``/``scatter_add_grad`` re-sums the rows it writes, so a bit flip
in host DRAM (or a stray write through the raw ``data`` buffer) raises
``RowCorruptionError`` at the first read instead of silently training on
garbage. Recovery is either targeted (``repair_rows`` re-fetches the rows
from a master copy) or global (checkpoint restore + fast-forward, which the
port has not reached yet). The guard is off by default: the
checksum pass costs a full-row read per gather/scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


#: rows a block of ``normal_rows`` draws (4 MB of float64 at dim 128)
NORMAL_BLOCK_ROWS = 4096


def normal_rows(rows: int, dim: int, seed: int, dtype=np.float32) -> np.ndarray:
    """``(default_rng(seed).standard_normal((rows, dim)) / sqrt(dim))
    .astype(dtype)``, bit for bit: the generator's stream does not depend
    on how many values a call draws, and each block is scaled and rounded
    as the whole would be."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(dim)
    out = np.empty((rows, dim), dtype)
    buf = np.empty((min(rows, NORMAL_BLOCK_ROWS), dim))
    for lo in range(0, rows, NORMAL_BLOCK_ROWS):
        block = buf[: min(NORMAL_BLOCK_ROWS, rows - lo)]
        rng.standard_normal(out=block)
        np.multiply(block, scale, out=block)
        out[lo: lo + len(block)] = block
    return out


class RowCorruptionError(RuntimeError):
    """One or more host-table rows no longer match their checksums."""

    def __init__(self, rows: Sequence[int]):
        self.rows = [int(r) for r in rows]
        super().__init__(
            f"host-table row corruption detected in {len(self.rows)} row(s): "
            f"{self.rows[:8]}{'…' if len(self.rows) > 8 else ''}"
        )


@dataclasses.dataclass
class HostTraffic:
    """Byte counters for one memory tier / link."""

    read: int = 0
    written: int = 0

    def reset(self):
        self.read = 0
        self.written = 0

    @property
    def total(self) -> int:
        return self.read + self.written


class HostEmbeddingTable:
    """rows x dim fp32 table resident in host memory (numpy).

    For multi-table models (DLRM) the tables are flattened into one global
    row space (global_id = table * rows_per_table + id) — this matches the
    paper's per-table cache managers (ranges never interleave) while keeping
    one vectorized controller.
    """

    def __init__(
        self,
        rows: int,
        dim: int,
        *,
        seed: int = 0,
        dtype=np.float32,
        data=None,
        guard: bool = False,
    ):
        if data is not None:
            assert data.shape == (rows, dim)
            self.data = data
        else:
            self.data = normal_rows(rows, dim, seed, dtype)
        self.traffic = HostTraffic()
        self._sums: Optional[np.ndarray] = None
        if guard:
            self.enable_guard()

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def row_bytes(self) -> int:
        return self.data.shape[1] * self.data.dtype.itemsize

    # -- integrity guard ----------------------------------------------------
    @property
    def guarded(self) -> bool:
        return self._sums is not None

    def _row_sums(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized per-row XOR fold of the raw row bytes. A single flipped
        byte always changes the fold (x ^ y != 0 for x != y at the same
        position), which is the corruption model the chaos harness injects."""
        a = np.ascontiguousarray(rows)
        if a.ndim == 1:
            a = a[None, :]
        nbytes = a.shape[1] * a.itemsize
        if nbytes % 4 == 0:
            v = a.view(np.uint32).reshape(a.shape[0], -1)
        else:
            v = a.view(np.uint8).reshape(a.shape[0], -1)
        return np.bitwise_xor.reduce(v.astype(np.uint32, copy=False), axis=1)

    def enable_guard(self) -> None:
        """Compute checksums for the whole table and start verifying."""
        self._sums = self._row_sums(self.data)

    def reguard(self, ids: Optional[np.ndarray] = None) -> None:
        """Recompute checksums (all rows, or just ``ids``) after a legitimate
        out-of-band write — e.g. an in-place checkpoint load."""
        if self._sums is None:
            return
        if ids is None:
            self._sums = self._row_sums(self.data)
        else:
            u = np.unique(np.asarray(ids).ravel())
            self._sums[u] = self._row_sums(self.data[u])

    def verify(self, ids: Optional[np.ndarray] = None) -> None:
        """Raise :class:`RowCorruptionError` if any (given) row's bytes no
        longer match its checksum. No-op when the guard is off."""
        if self._sums is None:
            return
        if ids is None:
            bad = np.flatnonzero(self._row_sums(self.data) != self._sums)
        else:
            u = np.unique(np.asarray(ids).ravel())
            if u.size == 0:
                return
            bad = u[self._row_sums(self.data[u]) != self._sums[u]]
        if bad.size:
            raise RowCorruptionError(bad.tolist())

    def repair_rows(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Targeted recovery: overwrite corrupted rows with known-good master
        values (e.g. from a replica or the latest checkpoint) and re-sum."""
        ids = np.asarray(ids).ravel()
        self.traffic.written += ids.size * self.row_bytes
        self.data[ids] = rows
        self.reguard(ids)

    # -- access path --------------------------------------------------------
    def gather(self, ids: np.ndarray) -> np.ndarray:
        """[Collect]: read missed rows from the capacity tier."""
        if self._sums is not None:
            self.verify(ids)
        self.traffic.read += ids.size * self.row_bytes
        return self.data[ids]

    def scatter(self, ids: np.ndarray, values: np.ndarray) -> None:
        """[Insert]: write evicted (dirty, trained) rows back."""
        self.traffic.written += ids.size * self.row_bytes
        self.data[ids] = values
        if self._sums is not None:
            self.reguard(ids)

    def scatter_add_grad(self, ids: np.ndarray, grads: np.ndarray, lr: float):
        """Baseline path (no-cache / static-cache miss): the memory-bound
        gradient duplication + coalescing + scatter executed on the host
        tier. read-modify-write = 2x row traffic."""
        if self._sums is not None:
            self.verify(ids)
        self.traffic.read += ids.size * self.row_bytes
        self.traffic.written += ids.size * self.row_bytes
        np.subtract.at(self.data, ids, lr * grads)
        if self._sums is not None:
            self.reguard(ids)
