"""Sharded, mmap-able binary trace format for embedding-access workloads.

Port of ``repro/traces/format.py`` (numpy only), on the port's own
:class:`~repro_torch.core.table_group.TableSpec`: both packages write the
same bytes for the same batches (shard files and ``manifest.json``), and
each reads the other's traces (tests/test_torch_traces.py).

ScratchPipe's always-hit guarantee rests on the dataset recording future
sparse ids (paper §IV-A): the look-ahead window is only as real as the
workload source backing it. This module makes workloads first-class
artifacts — a recorded trace is a directory:

    <trace>/
      manifest.json        header: table specs, batch shape, provenance
      shard-00000.bin      fixed-size batch records (mmap-able)
      shard-00001.bin
      ...

Each shard starts with a 32-byte binary header (magic, version, shard
index, record count) followed by fixed-size records, one per mini-batch:

    ids   int64  (B, T, L)   per-table LOCAL row ids
    dense float32 (B, D)     dense features
    label float32 (B,)       CTR label
    pad   to an 8-byte multiple (keeps the int64 ids of every record
                              aligned for zero-copy memmap views)

Ids are stored LOCAL (per table, before fusing) so a trace is portable
across fused layouts; the manifest's table specs rebuild the exact
:class:`~repro_torch.core.table_group.TableGroup` and the reader re-globalizes
on access. Fixed-size records + per-shard headers give O(1) random access
to any batch position — what makes mid-trace restart and the replay
stream's prefetch window cheap.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.table_group import TableGroup, TableSpec

MANIFEST_NAME = "manifest.json"
TRACE_MAGIC = "SPTRACE"
SHARD_MAGIC = b"SPTRSHRD"
VERSION = 1
_SHARD_HEADER = struct.Struct("<8sIIQQ")  # magic, version, index, records, pad
SHARD_HEADER_BYTES = _SHARD_HEADER.size
assert SHARD_HEADER_BYTES == 32


def _shard_name(i: int) -> str:
    return f"shard-{i:05d}.bin"


@dataclasses.dataclass(frozen=True)
class TraceMeta:
    """Everything needed to interpret the shards (the manifest header)."""

    tables: Tuple[TableSpec, ...]
    batch_size: int
    lookups_per_table: int
    num_dense_features: int
    num_batches: int
    batches_per_shard: int
    provenance: Dict[str, Any]
    version: int = VERSION

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    @property
    def ids_bytes(self) -> int:
        return 8 * self.batch_size * self.num_tables * self.lookups_per_table

    @property
    def dense_bytes(self) -> int:
        return 4 * self.batch_size * self.num_dense_features

    @property
    def label_bytes(self) -> int:
        return 4 * self.batch_size

    @property
    def record_bytes(self) -> int:
        raw = self.ids_bytes + self.dense_bytes + self.label_bytes
        return (raw + 7) // 8 * 8  # pad: every record's ids stay 8-aligned

    def group(self) -> TableGroup:
        return TableGroup(self.tables)

    def to_json(self) -> dict:
        return {
            "magic": TRACE_MAGIC,
            "version": self.version,
            "tables": [dataclasses.asdict(t) for t in self.tables],
            "batch_size": self.batch_size,
            "lookups_per_table": self.lookups_per_table,
            "num_dense_features": self.num_dense_features,
            "num_batches": self.num_batches,
            "batches_per_shard": self.batches_per_shard,
            "provenance": self.provenance,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceMeta":
        if d.get("magic") != TRACE_MAGIC:
            raise ValueError(f"not a trace manifest (magic={d.get('magic')!r})")
        if int(d["version"]) > VERSION:
            raise ValueError(
                f"trace version {d['version']} newer than reader ({VERSION})"
            )
        return cls(
            tables=tuple(TableSpec(**t) for t in d["tables"]),
            batch_size=int(d["batch_size"]),
            lookups_per_table=int(d["lookups_per_table"]),
            num_dense_features=int(d["num_dense_features"]),
            num_batches=int(d["num_batches"]),
            batches_per_shard=int(d["batches_per_shard"]),
            provenance=dict(d.get("provenance", {})),
            version=int(d["version"]),
        )


class TraceWriter:
    """Append-only writer; one fixed-size record per mini-batch.

    Shards roll over every ``batches_per_shard`` records; each shard's
    header record count is back-patched on close, and the manifest is the
    last thing written — a crashed recording never leaves a trace that
    parses as complete.
    """

    def __init__(
        self,
        path: str,
        group: TableGroup,
        *,
        batch_size: int,
        lookups_per_table: int,
        num_dense_features: int = 13,
        batches_per_shard: int = 256,
        provenance: Optional[Dict[str, Any]] = None,
    ):
        if batches_per_shard <= 0:
            raise ValueError("batches_per_shard must be positive")
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.group = group
        self.meta = TraceMeta(
            tables=group.tables,
            batch_size=batch_size,
            lookups_per_table=lookups_per_table,
            num_dense_features=num_dense_features,
            num_batches=0,
            batches_per_shard=batches_per_shard,
            provenance=dict(provenance or {}),
        )
        self._shape = (batch_size, group.num_tables, lookups_per_table)
        self._written = 0
        self._fh = None
        self._shard_records = 0
        self._closed = False

    # -- shard management ---------------------------------------------------
    def _open_shard(self):
        idx = self._written // self.meta.batches_per_shard
        self._fh = open(os.path.join(self.path, _shard_name(idx)), "wb")
        self._fh.write(_SHARD_HEADER.pack(SHARD_MAGIC, VERSION, idx, 0, 0))
        self._shard_records = 0

    def _close_shard(self):
        if self._fh is None:
            return
        # back-patch the record count (shard index derived from the LAST
        # written record — close() can run exactly at a shard boundary)
        self._fh.seek(0)
        head = _SHARD_HEADER.pack(
            SHARD_MAGIC, VERSION, self._shard_index, self._shard_records, 0
        )
        self._fh.write(head)
        self._fh.close()
        self._fh = None

    @property
    def _shard_index(self) -> int:
        return (self._written - 1) // self.meta.batches_per_shard

    # -- API ----------------------------------------------------------------
    def append(
        self, local_ids: np.ndarray, dense: np.ndarray, label: np.ndarray
    ) -> None:
        """Write one batch: LOCAL per-table ids (B, T, L), dense (B, D),
        label (B,)."""
        if self._closed:
            raise RuntimeError("writer closed")
        ids = np.ascontiguousarray(local_ids, dtype="<i8")
        if ids.shape != self._shape:
            raise ValueError(f"ids shape {ids.shape} != {self._shape}")
        hi = ids.max(initial=0, axis=(0, 2)) if ids.size else None
        for t, spec in enumerate(self.group.tables):
            if ids.size and int(hi[t]) >= spec.rows:
                raise ValueError(
                    f"table {spec.name!r}: id {int(hi[t])} >= rows {spec.rows}"
                )
            if ids.size and ids[:, t, :].min() < 0:
                raise ValueError(f"table {spec.name!r}: negative id")
        dense = np.ascontiguousarray(dense, dtype="<f4")
        label = np.ascontiguousarray(label, dtype="<f4")
        if dense.shape != (self.meta.batch_size, self.meta.num_dense_features):
            raise ValueError(f"dense shape {dense.shape} mismatch")
        if label.shape != (self.meta.batch_size,):
            raise ValueError(f"label shape {label.shape} mismatch")
        if self._fh is None:
            self._open_shard()
        self._fh.write(ids.tobytes())
        self._fh.write(dense.tobytes())
        self._fh.write(label.tobytes())
        pad = self.meta.record_bytes - (
            self.meta.ids_bytes + self.meta.dense_bytes + self.meta.label_bytes
        )
        if pad:
            self._fh.write(b"\x00" * pad)
        self._written += 1
        self._shard_records += 1
        if self._shard_records == self.meta.batches_per_shard:
            self._close_shard()

    def close(self) -> None:
        if self._closed:
            return
        self._close_shard()
        self.meta = dataclasses.replace(self.meta, num_batches=self._written)
        man = self.meta.to_json()
        man["shards"] = [
            _shard_name(i)
            for i in range(
                (self._written + self.meta.batches_per_shard - 1)
                // self.meta.batches_per_shard
            )
        ]
        tmp = os.path.join(self.path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1)
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))
        self._closed = True

    @property
    def num_batches(self) -> int:
        return self._written

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TraceReader:
    """O(1) random access over a recorded trace via per-shard memmaps.

    ``batch(i)`` returns the same ``(global_ids, payload)`` item the source
    generator yielded; arrays are fresh plain ndarrays (safe to mutate and
    to hand to ``torch.from_numpy``; never a view of the mapping, nor a
    ``np.memmap`` instance, so they outlive :meth:`close`).
    """

    def __init__(self, path: str):
        self.path = path
        man_path = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(man_path):
            raise FileNotFoundError(
                f"{man_path} missing — not a recorded trace directory"
            )
        with open(man_path) as f:
            self.meta = TraceMeta.from_json(json.load(f))
        self.group = self.meta.group()
        self._maps: Dict[int, np.memmap] = {}

    # -- shard access -------------------------------------------------------
    def _map(self, shard: int) -> np.memmap:
        mm = self._maps.get(shard)
        if mm is None:
            fp = os.path.join(self.path, _shard_name(shard))
            mm = np.memmap(fp, dtype=np.uint8, mode="r")
            magic, ver, idx, n_rec, _ = _SHARD_HEADER.unpack_from(mm[:32])
            if magic != SHARD_MAGIC or idx != shard:
                raise ValueError(f"corrupt shard header in {fp}")
            expect = min(
                self.meta.batches_per_shard,
                self.meta.num_batches - shard * self.meta.batches_per_shard,
            )
            if n_rec != expect:
                raise ValueError(
                    f"{fp}: {n_rec} records, manifest expects {expect}"
                )
            self._maps[shard] = mm
        return mm

    def _record(self, i: int) -> np.ndarray:
        if not (0 <= i < self.meta.num_batches):
            raise IndexError(f"batch {i} out of range [0, {self.meta.num_batches})")
        shard, off = divmod(i, self.meta.batches_per_shard)
        mm = self._map(shard)
        start = SHARD_HEADER_BYTES + off * self.meta.record_bytes
        return mm[start : start + self.meta.record_bytes]

    # -- API ----------------------------------------------------------------
    @property
    def num_batches(self) -> int:
        return self.meta.num_batches

    @property
    def batch_size(self) -> int:
        return self.meta.batch_size

    @property
    def lookups_per_table(self) -> int:
        return self.meta.lookups_per_table

    @property
    def num_dense_features(self) -> int:
        return self.meta.num_dense_features

    def local_ids(self, i: int) -> np.ndarray:
        """(B, T, L) per-table LOCAL ids of batch ``i`` (copy)."""
        m = self.meta
        rec = self._record(i)
        shape = (m.batch_size, m.num_tables, m.lookups_per_table)
        return np.array(rec[: m.ids_bytes].view("<i8").reshape(shape), dtype=np.int64)

    def global_ids(self, i: int) -> np.ndarray:
        """(B, T, L) fused global ids of batch ``i``."""
        return self.group.globalize(self.local_ids(i))

    def batch(self, i: int) -> Tuple[np.ndarray, dict]:
        """The full (global_ids, payload) item, bit-identical to what the
        recorded generator yielded."""
        m = self.meta
        rec = self._record(i)
        local = self.local_ids(i)
        dense = np.array(
            rec[m.ids_bytes : m.ids_bytes + m.dense_bytes]
            .view("<f4")
            .reshape(m.batch_size, m.num_dense_features),
            dtype=np.float32,
        )
        lo = m.ids_bytes + m.dense_bytes
        label = np.array(rec[lo : lo + m.label_bytes].view("<f4"), dtype=np.float32)
        return self.group.globalize(local), {
            "dense": dense,
            "label": label,
            "sparse_ids": local,
        }

    def close(self) -> None:
        self._maps.clear()

    def __len__(self) -> int:
        return self.meta.num_batches

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
