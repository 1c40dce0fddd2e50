"""TraceRecorder: snapshot any (ids, batch) generator into the trace format.

Port of ``repro/traces/recorder.py`` (numpy only): the same stream gives
the same trace bytes in both packages.

Works with every workload source in the repo — the stationary Zipf
generators (`repro_torch.data.synthetic`), the non-stationary scenario
generators (`repro_torch.traces.scenarios`), or a live training stream
(``tee`` records while the pipeline consumes). The recorded trace replays bit-identically
through :class:`~repro_torch.traces.replay.TraceReplayStream`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.table_group import TableGroup
from repro_torch.traces.format import TraceWriter


class TraceRecorder:
    """Records (global_ids, payload) items for one :class:`TableGroup`.

    The batch shape (B, L, D) is derived from the first item, so any
    generator compatible with the group can be snapshotted without
    declaring its shape up front.
    """

    def __init__(
        self,
        path: str,
        group: TableGroup,
        *,
        batches_per_shard: int = 256,
        provenance: Optional[Dict[str, Any]] = None,
    ):
        self.path = path
        self.group = group
        self.batches_per_shard = batches_per_shard
        self.provenance = dict(provenance or {})
        self._writer: Optional[TraceWriter] = None

    # -- internals ----------------------------------------------------------
    def _localize(self, gids: np.ndarray, payload: dict) -> np.ndarray:
        """Per-table LOCAL (B, T, L) ids: prefer the payload's
        ``sparse_ids`` (already local), else subtract the fused offsets."""
        sp = payload.get("sparse_ids") if isinstance(payload, dict) else None
        if sp is not None and np.ndim(sp) == 3:
            return np.asarray(sp, dtype=np.int64)
        gids = np.asarray(gids, dtype=np.int64)
        if gids.ndim != 3 or gids.shape[1] != self.group.num_tables:
            raise ValueError(
                f"cannot localize ids of shape {gids.shape} for "
                f"{self.group.num_tables} tables"
            )
        return gids - self.group.offsets[:-1][None, :, None]

    def _ensure_writer(self, local: np.ndarray, payload: dict) -> TraceWriter:
        if self._writer is None:
            b, _, lookups = local.shape
            dense = payload.get("dense") if isinstance(payload, dict) else None
            d = int(np.asarray(dense).shape[1]) if dense is not None else 0
            self._writer = TraceWriter(
                self.path,
                self.group,
                batch_size=b,
                lookups_per_table=lookups,
                num_dense_features=d,
                batches_per_shard=self.batches_per_shard,
                provenance=self.provenance,
            )
        return self._writer

    def _append(self, gids: np.ndarray, payload: Any) -> None:
        local = self._localize(gids, payload)
        w = self._ensure_writer(local, payload)
        b = w.meta.batch_size
        d = w.meta.num_dense_features
        if isinstance(payload, dict) and payload.get("dense") is not None:
            dense = np.asarray(payload["dense"], dtype=np.float32)
        else:
            dense = np.zeros((b, d), dtype=np.float32)
        if isinstance(payload, dict) and payload.get("label") is not None:
            label = np.asarray(payload["label"], dtype=np.float32)
        else:
            label = np.zeros((b,), dtype=np.float32)
        w.append(local, dense, label)

    # -- API ----------------------------------------------------------------
    def record(
        self,
        stream: Iterator[Tuple[np.ndarray, Any]],
        steps: Optional[int] = None,
    ) -> int:
        """Consume ``stream`` (up to ``steps`` batches) into the trace and
        finalize it. Returns the number of batches recorded."""
        n = 0
        for gids, payload in stream:
            self._append(gids, payload)
            n += 1
            if steps is not None and n >= steps:
                break
        self.close()
        return n

    def tee(
        self, stream: Iterator[Tuple[np.ndarray, Any]]
    ) -> Iterator[Tuple[np.ndarray, Any]]:
        """Yield the stream unchanged while recording it — snapshot a live
        training run's workload without a second pass. The trace finalizes
        when the stream ends (or call :meth:`close` at a known boundary)."""
        try:
            for gids, payload in stream:
                self._append(gids, payload)
                yield gids, payload
        finally:
            self.close()

    @property
    def num_batches(self) -> int:
        return self._writer.num_batches if self._writer else 0

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


def record_trace(
    path: str,
    group: TableGroup,
    stream: Iterator[Tuple[np.ndarray, Any]],
    *,
    steps: Optional[int] = None,
    provenance: Optional[Dict[str, Any]] = None,
    batches_per_shard: int = 256,
) -> int:
    """One-shot convenience: snapshot ``stream`` into ``path``."""
    rec = TraceRecorder(
        path, group, batches_per_shard=batches_per_shard, provenance=provenance
    )
    return rec.record(stream, steps)


def record_serving_trace(
    path: str,
    group: TableGroup,
    stream: Iterator[Tuple[np.ndarray, Any]],
    *,
    steps: Optional[int] = None,
    provenance: Optional[Dict[str, Any]] = None,
    batches_per_shard: int = 256,
) -> int:
    """Snapshot a SERVING trace: the id stream only. Payloads are stripped
    to their ids before recording (a lookup request has no label and will
    never produce a gradient), so the on-disk record carries zero dense
    features and the trace replays as pure (ids, {"sparse_ids"}) items for
    the read-only serving runtimes. Provenance is tagged ``kind=serving``
    so benchmarks can refuse to train on a label-free trace."""
    prov = {"kind": "serving", **dict(provenance or {})}

    def strip(items):
        for gids, payload in items:
            sp = payload.get("sparse_ids") if isinstance(payload, dict) else None
            yield gids, ({"sparse_ids": sp} if sp is not None else {})

    rec = TraceRecorder(
        path, group, batches_per_shard=batches_per_shard, provenance=prov
    )
    return rec.record(strip(stream), steps)
