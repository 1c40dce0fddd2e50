"""Criteo-TSV ingestion: turn a raw click log into a recorded trace.

The Criteo Terabyte / Kaggle day files are TSV lines:

    label \\t I1..I13 (int counters) \\t C1..C26 (32-bit hex categoricals)

with empty fields for missing values. Ingestion maps each categorical
column to one embedding table and hashes the raw feature value into that
table's row space (Knuth multiplicative hash — the standard trick when the
true vocabulary exceeds the table, and deterministic so re-ingestion is
bit-identical). Dense counters get the usual ``log1p`` transform. The
output is the standard trace format, so a real click log replays through
every cache runtime exactly like a synthetic trace — but with lookahead
windows the dataset genuinely recorded (paper §IV-A made literal).

Criteo has one categorical value per feature per example, so
``lookups_per_table = 1``; wider logs (multi-valued features) can be
ingested by repeating columns per table via ``table_columns``.

Port of ``repro/traces/criteo.py`` (pure Python + numpy): the same TSV
gives the same trace bytes in both packages.
"""
from __future__ import annotations

from typing import IO, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.table_group import TableGroup, TableSpec
from repro_torch.traces.format import TraceWriter

CRITEO_NUM_DENSE = 13
CRITEO_NUM_CAT = 26
_HASH_PRIME = 2_654_435_761  # Knuth multiplicative hash
_MISSING = 0x811C9DC5  # distinct sentinel for empty fields


def hash_feature(raw: str, rows: int) -> int:
    """Deterministic raw-categorical -> row-id hash. Criteo categoricals
    are 32-bit hex strings; anything else falls back to FNV-1a bytes."""
    if not raw:
        v = _MISSING
    else:
        try:
            v = int(raw, 16)
        except ValueError:
            v = 1469598103934665603
            for b in raw.encode():
                v = ((v ^ b) * 1099511628211) & 0x7FFFFFFFFFFFFFFF
    return (v * _HASH_PRIME) % rows


def parse_criteo_line(
    line: str,
    num_dense: int = CRITEO_NUM_DENSE,
    num_cat: Optional[int] = CRITEO_NUM_CAT,
) -> Optional[Tuple[float, np.ndarray, List[str]]]:
    """One TSV line -> (label, log1p dense (num_dense,), raw cat strings).
    ``num_cat=None`` infers the categorical column count from the line
    (the caller validates it). Returns None for malformed lines (real day
    files contain a few)."""
    parts = line.rstrip("\n").split("\t")
    if num_cat is None:
        num_cat = len(parts) - 1 - num_dense
        if num_cat < 1:
            return None
    if len(parts) != 1 + num_dense + num_cat:
        return None
    try:
        label = float(parts[0])
    except ValueError:
        return None
    dense = np.zeros(num_dense, dtype=np.float32)
    for i, raw in enumerate(parts[1 : 1 + num_dense]):
        if raw:
            try:
                dense[i] = np.log1p(max(0.0, float(raw)))
            except ValueError:
                pass
    return label, dense, parts[1 + num_dense :]


def criteo_group(
    table_rows: Sequence[int], dim: int = 128, *, hot_fraction: float = 0.05
) -> TableGroup:
    """One embedding table per categorical feature column."""
    return TableGroup(
        [
            TableSpec(f"cat{i}", int(r), dim, hot_fraction)
            for i, r in enumerate(table_rows)
        ]
    )


def ingest_criteo_tsv(
    tsv: Union[str, IO[str], Iterable[str]],
    out_path: str,
    *,
    table_rows: Sequence[int],
    dim: int = 128,
    batch_size: int = 2048,
    num_dense: int = CRITEO_NUM_DENSE,
    table_columns: Optional[Sequence[int]] = None,
    max_batches: Optional[int] = None,
    batches_per_shard: int = 256,
    provenance: Optional[dict] = None,
) -> int:
    """Hash a Criteo-style TSV into the trace format at ``out_path``.

    ``table_rows[t]`` is the row space of the table backing categorical
    column ``table_columns[t]`` (default: column ``t``). A trailing
    partial batch is dropped (every record in the format is full-batch).
    Returns the number of batches written."""
    cols = list(table_columns) if table_columns is not None else list(
        range(len(table_rows))
    )
    if len(cols) != len(table_rows):
        raise ValueError("table_columns must align with table_rows")
    group = criteo_group(table_rows, dim)
    num_cat_needed = max(cols) + 1
    lines: Iterator[str]
    close_me = None
    if isinstance(tsv, str):
        close_me = open(tsv)
        lines = iter(close_me)
    else:
        lines = iter(tsv)
    prov = {
        "generator": "criteo_tsv",
        "num_dense": num_dense,
        "table_columns": cols,
        **(provenance or {}),
    }
    writer = TraceWriter(
        out_path,
        group,
        batch_size=batch_size,
        lookups_per_table=1,
        num_dense_features=num_dense,
        batches_per_shard=batches_per_shard,
        provenance=prov,
    )
    n_batches = 0
    try:
        while max_batches is None or n_batches < max_batches:
            ids = np.zeros((batch_size, group.num_tables, 1), dtype=np.int64)
            dense = np.zeros((batch_size, num_dense), dtype=np.float32)
            label = np.zeros(batch_size, dtype=np.float32)
            filled = 0
            # accept the standard 26-column layout or a narrower file that
            # exactly covers the requested columns (tests, trimmed logs)
            valid_cats = {CRITEO_NUM_CAT, num_cat_needed}
            for line in lines:
                parsed = parse_criteo_line(line, num_dense, None)
                if parsed is None:
                    continue
                lab, den, cats = parsed
                if len(cats) not in valid_cats or len(cats) < num_cat_needed:
                    continue
                for t, c in enumerate(cols):
                    ids[filled, t, 0] = hash_feature(cats[c], table_rows[t])
                dense[filled] = den
                label[filled] = lab
                filled += 1
                if filled == batch_size:
                    break
            if filled < batch_size:
                break  # trailing partial batch dropped
            writer.append(ids, dense, label)
            n_batches += 1
    finally:
        writer.close()
        if close_me is not None:
            close_me.close()
    return n_batches
