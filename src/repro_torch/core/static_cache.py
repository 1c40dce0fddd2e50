"""Baseline embedding-cache designs the paper compares against (§III/VI).

Port of ``repro/core/static_cache.py``:

* ``NoCacheBaseline``     — hybrid CPU-GPU without caching [Tensor Casting
  baseline, Fig. 4(a)]: every gather and every gradient scatter hits the
  slow host tier.
* ``StaticCacheBaseline`` — Yin et al. [12], Fig. 4(b): the top-N
  most-frequently-accessed rows are pinned in device memory for the whole
  training run (no eviction). Hits train on-device; misses gather from and
  scatter-update to the host tier.

Both run the SAME [Train] computation as ScratchPipe (``train_fn``, with
its in-place storage update), so end-to-end training math is identical;
only row placement differs. Both satisfy the EmbeddingCacheRuntime protocol
(run / run_one_cycle / flush_to_host / stats / traffic). The static cache
takes a replica ``precision`` (fp16/int8 pinned region and transient miss
tail, dequantized on the scatter back to the fp32 host masters). Both take
``tracer=``/``metrics=`` (``repro_torch.obs``): one ``step`` span per
cycle, ``cache.*`` counters and lazy traffic gauges, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core.host_table import HostEmbeddingTable, HostTraffic
from repro_torch.core.pipeline import StepStats, _map_rows
from repro_torch.core.plan import pad_rows
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.runtime import register_runtime
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_SPAN, resolve as obs_resolve


class _BaselineObs:
    """Opt-in telemetry shared by the unpipelined baselines. Both run one
    whole step per cycle on the calling thread, so one ``step`` span plus
    the post-step counter batch covers them; traffic gauges read the byte
    counters at snapshot time."""

    def _init_obs(self, tracer, metrics, runtime_name: str) -> None:
        self._tracer, self._metrics = obs_resolve(tracer, metrics)
        self._mc = None
        m = self._metrics
        if m is None:
            return
        lbl = {"runtime": runtime_name}
        self._mc = {k: m.counter(f"cache.{k}", **lbl)
                    for k in ("cycles", "lookups", "unique", "hits", "misses")}
        m.gauge("traffic.pcie.h2d_bytes", fn=lambda: self.pcie.written, **lbl)
        m.gauge("traffic.pcie.d2h_bytes", fn=lambda: self.pcie.read, **lbl)
        m.gauge("traffic.hbm.read_bytes", fn=lambda: self.hbm.read, **lbl)
        m.gauge("traffic.hbm.written_bytes", fn=lambda: self.hbm.written, **lbl)
        m.gauge("traffic.host.read_bytes", fn=lambda: self.host.traffic.read, **lbl)
        m.gauge("traffic.host.written_bytes", fn=lambda: self.host.traffic.written, **lbl)

    def _step(self, step: int, ids, batch) -> StepStats:
        t = self._tracer
        with NULL_SPAN if t is None else t.span("step", "train"):
            st = self._step_body(step, ids, batch)
        mc = self._mc
        if mc is not None:
            mc["cycles"].inc()
            mc["lookups"].inc(st.n_lookups)
            mc["unique"].inc(st.n_unique)
            mc["hits"].inc(st.n_hits)
            mc["misses"].inc(st.n_miss)
        return st


class NoCacheBaseline(_BaselineObs):
    """All embedding work on the host tier; the device only does the MLPs.

    ``train_fn(storage, slots, batch)`` is reused by presenting the
    *gathered batch rows themselves* as a dense mini-storage on the device
    (slot i = i-th unique row), so compute is identical; the updated rows
    are scattered back to the host.
    """

    def __init__(self, host_table: HostEmbeddingTable, train_fn, *, tracer=None,
                 metrics=None, device="cuda"):
        self.device = resolve_device(device)
        self.host = host_table
        self.train_fn = train_fn
        self.pcie = HostTraffic()
        self.hbm = HostTraffic()  # stays zero: device holds no embedding rows
        self._stats: List[StepStats] = []
        self._init_obs(tracer, metrics, "nocache")

    def _step_body(self, step: int, ids, batch) -> StepStats:
        ids = np.asarray(ids)
        flat = ids.ravel()
        uniq, inv = np.unique(flat, return_inverse=True)
        rows = self.host.gather(uniq)  # host gather (memory-bound)
        # pow-2 padded transient region, as the reference (zero rows past
        # ``uniq.size`` are never addressed by ``slots``)
        storage = torch.from_numpy(pad_rows(rows)).to(self.device)
        self.pcie.written += rows.nbytes
        slots = inv.reshape(ids.shape)
        storage, aux = self.train_fn(storage, slots, batch)
        new_rows = storage[: uniq.size].cpu().numpy()
        self.pcie.read += new_rows.nbytes
        # host-side scatter of trained rows (gradient path on slow tier)
        self.host.scatter(uniq, new_rows)
        st = StepStats(
            step=step,
            n_lookups=int(flat.size),
            n_unique=int(uniq.size),
            n_hits=0,
            n_miss=int(uniq.size),
            n_evict=0,
            aux=aux,
        )
        self._stats.append(st)
        return st

    def run(self, stream, lookahead_fn=None) -> List[StepStats]:
        return [
            self._step(step, ids, batch)
            for step, (ids, batch) in enumerate(stream, 1)
        ]

    def run_one_cycle(self, ids, batch, lookahead_fn=None) -> Optional[StepStats]:
        return self._step(len(self._stats) + 1, ids, batch)

    def flush_to_host(self):
        pass  # nothing device-resident

    def traffic(self) -> dict:
        return {"host": self.host.traffic, "pcie": self.pcie, "hbm": self.hbm}

    @property
    def stats(self):
        return self._stats


class StaticCacheBaseline(_BaselineObs):
    """Yin et al. static top-N cache. ``hot_ids`` (GLOBAL row ids, e.g.
    per-table top-N from ``data.synthetic.hot_ids_for_group``) are pinned
    on the device for the whole run.

    ``precision`` quantizes the pinned region AND the per-step transient
    miss tail (core/quantize.py), so both hold the bytes a ScratchPipe
    scratchpad of that precision would; pair it with a trainer of the same
    precision. Missed rows' trained values dequantize on the scatter back
    to the fp32 host master."""

    def __init__(
        self,
        host_table: HostEmbeddingTable,
        hot_ids: np.ndarray,
        train_fn,
        *,
        precision: str = "fp32",
        tracer=None,
        metrics=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.host = host_table
        self.train_fn = train_fn
        self.precision = qz.check_precision(precision)
        self._row_bytes = qz.row_bytes(
            host_table.dim, self.precision, host_table.data.dtype.itemsize
        )
        self.pcie = HostTraffic()
        self.hbm = HostTraffic()  # pinned-region traffic ([Train] on hits)
        self.hot_ids = np.asarray(np.sort(hot_ids), dtype=np.int64)
        self.id_to_slot = np.full(host_table.rows, -1, dtype=np.int64)
        self.id_to_slot[self.hot_ids] = np.arange(self.hot_ids.size)
        self.storage = self._to_device(
            qz.quantize_rows_np(host_table.gather(self.hot_ids), self.precision)
        )
        host_table.traffic.reset()  # preload is not steady-state traffic
        self._stats: List[StepStats] = []
        self._init_obs(tracer, metrics, "static")

    def _step_body(self, step: int, ids, batch) -> StepStats:
        ids = np.asarray(ids)
        flat = ids.ravel()
        uniq = np.unique(flat)
        slots_u = self.id_to_slot[uniq]
        miss_ids = uniq[slots_u < 0]
        n_hit_lookups = int(np.sum(self.id_to_slot[flat] >= 0))
        n_hits = int(uniq.size - miss_ids.size)

        # Misses: gather from host, append to a transient device region
        # behind the pinned area (fresh every step — no insertion), pow-2
        # padded as the reference pads it. Under a reduced precision the
        # tail rows cross h2d quantized, like the pinned region.
        miss_rows = qz.quantize_rows_np(self.host.gather(miss_ids), self.precision)
        self.pcie.written += miss_ids.size * self._row_bytes
        if miss_ids.size:
            tail = self._to_device(_map_rows(pad_rows, miss_rows))
            if isinstance(self.storage, QuantStorage):
                ext = QuantStorage(*(torch.cat([a, b], dim=0)
                                     for a, b in zip(self.storage, tail)))
            else:
                ext = torch.cat([self.storage, tail], dim=0)
        else:
            ext = self.storage
        # temporarily map misses into the transient tail (reverted in the
        # finally, so an exception in train_fn leaves no tail slot mapped)
        try:
            self.id_to_slot[miss_ids] = self.hot_ids.size + np.arange(miss_ids.size)
            slots = self.id_to_slot[flat].reshape(ids.shape)
        finally:
            self.id_to_slot[miss_ids] = -1

        ext, aux = self.train_fn(ext, slots, batch)
        # hit rows stay on the device; missed rows' trained values scatter
        # back to the host tier (the slow bwd path, Fig. 4(b) right),
        # dequantized into the fp32 master under a reduced precision
        n_pin = self.hot_ids.size
        self.storage = _map_rows(lambda t: t[:n_pin], ext)
        if miss_ids.size:
            upd = _map_rows(lambda t: t[n_pin : n_pin + miss_ids.size].cpu().numpy(), ext)
            self.pcie.read += miss_ids.size * self._row_bytes
            self.host.scatter(miss_ids, qz.dequantize_rows_np(upd, self.precision))
        # device-tier bytes: bag gathers over all lookups + read-mod-write
        # of the pinned hit rows
        row_b = self._row_bytes
        self.hbm.read += (2 * n_hits + int(flat.size)) * row_b
        self.hbm.written += n_hits * row_b

        st = StepStats(
            step=step,
            n_lookups=int(flat.size),
            n_unique=int(uniq.size),
            n_hits=n_hits,
            n_miss=int(miss_ids.size),
            n_evict=0,
            hit_lookups=n_hit_lookups,
            aux=aux,
        )
        self._stats.append(st)
        return st

    def run(self, stream, lookahead_fn=None) -> List[StepStats]:
        return [
            self._step(step, ids, batch)
            for step, (ids, batch) in enumerate(stream, 1)
        ]

    def run_one_cycle(self, ids, batch, lookahead_fn=None) -> Optional[StepStats]:
        return self._step(len(self._stats) + 1, ids, batch)

    def _to_device(self, rows):
        """Host rows (an int8 pair: a QuantStorage) -> tensors on the device."""
        if isinstance(rows, tuple):
            return QuantStorage(*(torch.from_numpy(r).to(self.device) for r in rows))
        return torch.from_numpy(rows).to(self.device)

    def flush_to_host(self):
        vals = _map_rows(lambda t: t.cpu().numpy(), self.storage)
        self.host.scatter(self.hot_ids, qz.dequantize_rows_np(vals, self.precision))

    def traffic(self) -> dict:
        return {"host": self.host.traffic, "pcie": self.pcie, "hbm": self.hbm}

    @property
    def stats(self):
        return self._stats


def _reject_unsupported(name: str, kw: dict) -> None:
    extra = {k: v for k, v in kw.items() if v is not None}
    if extra:
        raise TypeError(
            f"runtime {name!r} does not support {sorted(extra)}; it has no "
            "scratchpad to budget (slot kwargs apply to the dynamic caches)"
        )


@register_runtime("nocache")
def _make_nocache(host_table, train_fn, *, device="cuda", **kw) -> NoCacheBaseline:
    obs_kw = {k: kw.pop(k, None) for k in ("tracer", "metrics")}
    _reject_unsupported("nocache", kw)
    return NoCacheBaseline(host_table, train_fn, device=device, **obs_kw)


@register_runtime("static")
def _make_static(host_table, train_fn, *, hot_ids, device="cuda", **kw) -> StaticCacheBaseline:
    obs_kw = {k: kw.pop(k, None) for k in ("tracer", "metrics")}
    precision = kw.pop("precision", None) or "fp32"
    _reject_unsupported("static", kw)
    return StaticCacheBaseline(
        host_table, hot_ids, train_fn, precision=precision, device=device, **obs_kw
    )
