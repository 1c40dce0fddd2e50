"""The port's trace subsystem (``repro_torch.traces``) against the JAX
package's (``repro.traces``), on the CPU.

  * Format: the same batches written by either package's writer give
    byte-identical shard files and ``manifest.json`` (synthetic training
    batches, scenario streams, serving traces, several shards, tables of
    different rows, Criteo-TSV ingestion); each package's reader reads the
    other's traces; ``TraceReader.batch`` returns fresh arrays that outlive
    the reader.
  * Replay: the port's ``TraceReplayStream`` delivers the reference
    writer's batches bit for bit, with and without prefetch, after
    ``seek`` and after ``resume``; the cases of tests/test_traces.py
    (record -> replay, prefetch transparency, mid-trace resume, peek,
    ``stop``, ``tee``, manifest checks) and the seven of
    tests/test_replay_prefetch.py (exactly-once decode, close and seek
    during a decode) hold for the port.
  * Profiling: ``profile_hot_ids``, ``hot_ids_from_trace`` and
    ``derive_pad_buckets`` equal the reference's.
  * A recorded trace drives the port's runtimes to the reference's
    StepStats.
"""
from __future__ import annotations

import dataclasses
import filecmp
import os
import threading
import time
from collections import Counter

import numpy as np
import pytest

from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.table_group import TableGroup as JGroup
from repro.core.table_group import TableSpec as JSpec
from repro.data import synthetic as jsyn
from repro.traces import criteo as jcriteo
from repro.traces import format as jformat
from repro.traces import profiling as jprof
from repro.traces import recorder as jrec
from repro.traces import scenarios as jsc
from repro.traces.replay import TraceReplayStream as JReplay
from repro_torch import traces as ttraces
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.core.table_group import TableSpec as TSpec
from repro_torch.data import synthetic as tsyn
from repro_torch.data.lookahead import LookaheadStream as TLookahead
from repro_torch.traces import criteo as tcriteo
from repro_torch.traces import format as tformat
from repro_torch.traces import profiling as tprof
from repro_torch.traces import recorder as trec
from repro_torch.traces import scenarios as tsc
from repro_torch.traces.replay import TraceReplayStream as TReplay

SEED = 3


def groups(rows=(600, 250), dim=8, precision="fp32"):
    """The same table layout in both packages."""
    names = [f"t{i}" for i in range(len(rows))]
    return (JGroup([JSpec(n, r, dim, 0.05, precision) for n, r in zip(names, rows)]),
            TGroup([TSpec(n, r, dim, 0.05, precision) for n, r in zip(names, rows)]))


def synthetic(syn, steps=14, seed=SEED, batch=4, lookups=3):
    tc = syn.TraceConfig(num_tables=2, rows_per_table=300, lookups_per_table=lookups,
                         batch_size=batch, seed=seed)
    return syn.dlrm_batches(tc, steps)


def assert_items_equal(a, b):
    (g1, p1), (g2, p2) = a, b
    np.testing.assert_array_equal(g1, g2)
    assert g1.dtype == g2.dtype == np.int64
    for k in ("sparse_ids", "dense", "label"):
        assert p1[k].dtype == p2[k].dtype, k
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)


def assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "manifest.json" in names and any(n.startswith("shard-") for n in names)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


# --------------------------------------------------------------------------- #
# format: byte-identical both ways, each reads the other's
# --------------------------------------------------------------------------- #
def _write_synthetic(pkg, path, group, bps):
    rec = jrec if pkg == "ref" else trec
    syn = jsyn if pkg == "ref" else tsyn
    return rec.record_trace(path, group, synthetic(syn), batches_per_shard=bps,
                            provenance={"generator": "synthetic", "seed": SEED})


def _write_scenario(pkg, path, group, bps):
    rec, sc = (jrec, jsc) if pkg == "ref" else (trec, tsc)
    stream = sc.scenario_batches("drift", group, 9, batch_size=4, lookups_per_table=3,
                                 seed=SEED)
    return rec.record_trace(path, group, stream, batches_per_shard=bps)


def _write_serving(pkg, path, group, bps):
    rec, sc = (jrec, jsc) if pkg == "ref" else (trec, tsc)
    stream = sc.scenario_batches("inference_mix", group, 11, batch_size=4,
                                 lookups_per_table=3, seed=SEED)
    return rec.record_serving_trace(path, group, stream, steps=10,
                                    batches_per_shard=bps,
                                    provenance={"scenario": "inference_mix"})


def _criteo_lines(n=40, seed=0, num_cat=26):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = str(int(rng.integers(0, 2)))
        dense = [str(int(rng.integers(0, 500))) if rng.random() > 0.2 else ""
                 for _ in range(13)]
        cats = [f"{int(rng.integers(0, 2 ** 32)):08x}" if rng.random() > 0.1 else ""
                for _ in range(num_cat)]
        out.append("\t".join([label] + dense + cats) + "\n")
    return out


def _write_criteo(pkg, path, group, bps):
    lines = _criteo_lines()
    lines.insert(2, "malformed\tline\n")
    mod = jcriteo if pkg == "ref" else tcriteo
    return mod.ingest_criteo_tsv(iter(lines), path, table_rows=[70, 40, 90], batch_size=8,
                                 batches_per_shard=bps)


WRITERS = {
    "synthetic": (_write_synthetic, (300, 300), 256),
    "synthetic-5-per-shard": (_write_synthetic, (300, 300), 5),
    "scenario-drift-rows-differ": (_write_scenario, (600, 250), 4),
    "serving-int8": (_write_serving, (400, 400), 3),
    "criteo": (_write_criteo, None, 2),
}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_writers_byte_identical_and_cross_readable(tmp_path, case):
    write, rows, bps = WRITERS[case]
    prec = "int8" if "int8" in case else "fp32"
    jg, tg = groups(rows or (70, 40, 90), precision=prec)
    j_path, t_path = str(tmp_path / "ref"), str(tmp_path / "port")
    n_j, n_t = write("ref", j_path, jg, bps), write("port", t_path, tg, bps)
    assert n_j == n_t > 0
    assert_same_files(j_path, t_path)
    # each package reads the other's trace: the same items, the same meta
    j_read, t_read = jformat.TraceReader(t_path), tformat.TraceReader(j_path)
    assert dataclasses.asdict(j_read.meta) == dataclasses.asdict(t_read.meta)
    assert j_read.group.tables == tuple(JSpec(**dataclasses.asdict(s))
                                         for s in t_read.group.tables)
    for i in range(n_t):
        assert_items_equal(j_read.batch(i), t_read.batch(i))
        np.testing.assert_array_equal(j_read.global_ids(i), t_read.global_ids(i))


def test_batch_returns_fresh_arrays_that_outlive_the_reader(tmp_path):
    _, tg = groups((300, 300))
    path = str(tmp_path / "t")
    trec.record_trace(path, tg, synthetic(tsyn, steps=3), batches_per_shard=2)
    reader = tformat.TraceReader(path)
    items = [reader.batch(i) for i in range(3)]
    reader.close()
    for gids, payload in items:
        for a in (gids, payload["sparse_ids"], payload["dense"], payload["label"]):
            assert a.flags.writeable and a.flags.owndata and a.flags.c_contiguous
            assert not isinstance(a, np.memmap) and a.base is None
    gids, payload = items[0]
    payload["dense"][:] = 0.0  # mutating a delivered batch leaves the trace as it was
    np.testing.assert_array_equal(tformat.TraceReader(path).batch(0)[1]["label"],
                                  payload["label"])
    assert tformat.TraceReader(path).batch(0)[1]["dense"].any()


def test_manifest_and_validation(tmp_path):
    _, tg = groups((300, 300))
    path = str(tmp_path / "t")
    trec.record_trace(path, tg, synthetic(tsyn, steps=4),
                      provenance={"generator": "unit"})
    reader = tformat.TraceReader(path)
    m = reader.meta
    assert m.provenance["generator"] == "unit"
    assert [t.name for t in m.tables] == ["t0", "t1"]
    assert (m.batch_size, m.lookups_per_table, m.num_dense_features) == (4, 3, 13)
    assert reader.group.rows == tg.rows and isinstance(reader.group, TGroup)
    with pytest.raises(IndexError):
        reader.batch(4)
    with pytest.raises(FileNotFoundError):
        tformat.TraceReader(str(tmp_path / "nope"))
    w = tformat.TraceWriter(str(tmp_path / "w"), tg, batch_size=2, lookups_per_table=1,
                            num_dense_features=0)
    with pytest.raises(ValueError, match="rows"):
        w.append(np.array([[[0], [300]], [[0], [0]]]), np.zeros((2, 0)), np.zeros(2))
    with pytest.raises(ValueError, match="negative"):
        w.append(np.array([[[-1], [0]], [[0], [0]]]), np.zeros((2, 0)), np.zeros(2))
    w.close()


# --------------------------------------------------------------------------- #
# replay: the reference writer's batches, bit for bit
# --------------------------------------------------------------------------- #
@pytest.fixture
def ref_trace(tmp_path):
    """14 synthetic batches written by the reference, in shards of 5; and
    the generator's own items."""
    jg, _ = groups((300, 300))
    path = str(tmp_path / "ref")
    jrec.record_trace(path, jg, synthetic(jsyn), batches_per_shard=5)
    return path, list(synthetic(tsyn))


@pytest.mark.parametrize("prefetch", [0, 4])
def test_replay_of_reference_trace_bit_identical(ref_trace, prefetch):
    path, items = ref_trace
    with TReplay(path, prefetch=prefetch) as rs:
        got = list(rs)
        assert rs.exhausted and rs.consumed == 14
    assert len(got) == len(items) == 14
    for a, b in zip(items, got):
        assert_items_equal(a, b)
    with JReplay(path, prefetch=prefetch) as rs:
        for a, b in zip(rs, got):
            assert_items_equal(a, b)


def test_replay_seek_and_resume_match_reference(ref_trace):
    path, items = ref_trace
    t, j = TReplay(path, prefetch=3), JReplay(path, prefetch=3)
    try:
        for _ in range(4):
            assert_items_equal(next(t), next(j))
        t.seek(9), j.seek(9)
        for _ in range(2):
            assert_items_equal(next(t), items[t.consumed - 1])
            assert_items_equal(next(j), items[j.consumed - 1])
        assert t.state_dict() == j.state_dict() == {"consumed": 11, "num_batches": 14}
        t.seek(2), j.seek(2)
        assert [a.tolist() for a in t.peek_ids(3)] == [a.tolist() for a in j.peek_ids(3)]
        state = t.state_dict()
    finally:
        t.close(), j.close()
    resumed = TReplay.resume(path, state, prefetch=2)
    j_resumed = JReplay.resume(path, state, prefetch=2)
    rest, j_rest = list(resumed), list(j_resumed)
    assert len(rest) == len(j_rest) == 12
    for a, b, c in zip(items[2:], rest, j_rest):
        assert_items_equal(a, b)
        assert_items_equal(b, c)
    resumed.close(), j_resumed.close()


def test_record_replay_bit_identical(tmp_path):
    _, tg = groups((300, 300))
    path = str(tmp_path / "t")
    n = trec.record_trace(path, tg, synthetic(tsyn), batches_per_shard=5)
    assert n == 14
    ref = list(synthetic(tsyn))
    with TReplay(path, prefetch=4) as rs:
        got = list(rs)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert_items_equal(a, b)


def test_replay_prefetch_transparent(ref_trace):
    path, _ = ref_trace
    with TReplay(path, prefetch=0) as sync, TReplay(path, prefetch=6) as pre:
        for a, b in zip(sync, pre):
            assert_items_equal(a, b)


def test_replay_resume_mid_trace(ref_trace):
    path, full = ref_trace
    rs = TReplay(path, prefetch=3)
    for _ in range(6):
        next(rs)
    state = rs.state_dict()
    rs.close()
    assert state["consumed"] == 6
    resumed = TReplay.resume(path, state)
    rest = list(resumed)
    assert len(rest) == len(full) - 6 and resumed.exhausted
    for a, b in zip(full[6:], rest):
        assert_items_equal(a, b)
    resumed.close()
    limited = TReplay(path, stop=9, prefetch=0)
    for _ in range(4):
        next(limited)
    resumed2 = TReplay.resume(path, limited.state_dict())
    assert resumed2.num_batches == 9
    rest2 = list(resumed2)
    assert len(rest2) == 5 and resumed2.exhausted
    for a, b in zip(full[4:9], rest2):
        assert_items_equal(a, b)
    limited.close(), resumed2.close()


def test_replay_peek_does_not_consume(ref_trace):
    path, ref = ref_trace
    rs = TReplay(path, prefetch=2)
    peek = rs.peek_ids(3)
    assert len(peek) == 3 and rs.consumed == 0
    for i in range(3):
        np.testing.assert_array_equal(peek[i], ref[i][0])
    _, tg = groups((300, 300))
    per_table = rs.peek_table_ids(2, tg)
    for i in range(2):
        for t in range(2):
            want = ref[i][1]["sparse_ids"][:, t, :].ravel()
            np.testing.assert_array_equal(per_table[i][t], want)
    np.testing.assert_array_equal(next(rs)[0], ref[0][0])
    rs.seek(12)
    assert len(rs.peek_ids(5)) == 2 and not rs.exhausted
    next(rs), next(rs)
    assert rs.peek_ids(5) == [] and rs.exhausted
    with pytest.raises(StopIteration):
        next(rs)
    rs.close()


def test_replay_stop_limits_steps(ref_trace):
    path, ref = ref_trace
    with TReplay(path, stop=5, prefetch=2) as rs:
        assert rs.num_batches == 5
        got = list(rs)
        assert len(got) == 5 and rs.exhausted
    for a, b in zip(ref[:5], got):
        assert_items_equal(a, b)
    with TReplay(path, stop=99) as rs:
        assert rs.num_batches == 14
    with TReplay(path, start=2, stop=4, prefetch=0) as rs:
        assert len(rs.peek_ids(10)) == 2
    with pytest.raises(ValueError, match="out of range"):
        TReplay(path, start=15)


def test_recorder_tee_records_while_consuming(tmp_path):
    _, tg = groups((300, 300))
    path = str(tmp_path / "t")
    rec = trec.TraceRecorder(path, tg)
    seen = [ids.copy() for ids, _ in rec.tee(synthetic(tsyn, steps=7))]
    assert rec.num_batches == 7
    reader = tformat.TraceReader(path)
    assert reader.num_batches == 7
    for i in range(7):
        np.testing.assert_array_equal(reader.global_ids(i), seen[i])


def test_record_serving_trace_strips_payload(tmp_path):
    _, tg = groups((400, 400))
    stream = tsc.scenario_batches("drift", tg, 6, batch_size=4, lookups_per_table=3,
                                  seed=SEED)
    path = str(tmp_path / "serve")
    assert trec.record_serving_trace(path, tg, stream, steps=6,
                                     provenance={"scenario": "drift"}) == 6
    reader = tformat.TraceReader(path)
    assert reader.meta.num_dense_features == 0
    prov = reader.meta.provenance
    assert prov["kind"] == "serving" and prov["scenario"] == "drift"
    gids, payload = reader.batch(0)
    assert payload["sparse_ids"].shape == (4, 2, 3) and payload["dense"].shape == (4, 0)
    np.testing.assert_array_equal(tg.globalize(payload["sparse_ids"]), gids)


def test_replay_tracer_is_item_12(ref_trace):
    """Item 12's tracer is ported: decodes are spanned on the thread that
    decodes them — the prefetch thread, or the consumer without one."""
    from repro_torch.obs import Tracer

    tr = Tracer()
    stream = TReplay(ref_trace[0], tracer=tr)
    n = sum(1 for _ in stream)
    stream.close()
    totals = tr.totals()
    assert n > 0 and ("trace-prefetch", "trace.decode") in totals
    tr2 = Tracer()
    assert sum(1 for _ in TReplay(ref_trace[0], prefetch=0, tracer=tr2)) == n
    assert set(tr2.totals()) == {("MainThread", "trace.decode_sync")}


# --------------------------------------------------------------------------- #
# the prefetch thread (tests/test_replay_prefetch.py, against the port)
# --------------------------------------------------------------------------- #
class CountingReader:
    """Position-addressed reader that counts decodes per position."""

    def __init__(self, n: int = 24, delay: float = 0.0):
        self.num_batches = n
        self.delay = delay
        self.calls: Counter = Counter()
        self._lock = threading.Lock()
        self.group = None

    def _payload(self, i: int):
        ids = np.full((2, 1, 3), i, dtype=np.int64)
        return ids, {"dense": np.zeros((2, 1), np.float32), "pos": i}

    def batch(self, i: int):
        with self._lock:
            self.calls[i] += 1
        if self.delay:
            time.sleep(self.delay)
        return self._payload(i)

    def global_ids(self, i: int):
        return self._payload(i)[0]


class GatedReader(CountingReader):
    """Reader whose decode blocks until released."""

    def __init__(self, n: int = 24):
        super().__init__(n)
        self.started = threading.Event()
        self.release = threading.Event()
        self.gate_on: set = set(range(n))

    def batch(self, i: int):
        with self._lock:
            self.calls[i] += 1
        if i in self.gate_on:
            self.started.set()
            assert self.release.wait(timeout=10.0), "test deadlock"
        return self._payload(i)


def _drain(stream, n):
    return [payload["pos"] for _, payload in (next(stream) for _ in range(n))]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_exactly_once_decode(prefetch):
    reader = CountingReader(n=24)
    with TReplay(reader, prefetch=prefetch) as s:
        seq = _drain(s, 24)
        with pytest.raises(StopIteration):
            next(s)
    assert seq == list(range(24))
    assert reader.calls == Counter({i: 1 for i in range(24)})


def test_exactly_once_decode_fast_consumer():
    reader = CountingReader(n=16, delay=0.01)
    with TReplay(reader, prefetch=8) as s:
        seq = _drain(s, 16)
    assert seq == list(range(16))
    assert not {i: c for i, c in reader.calls.items() if c != 1}
    assert len(reader.calls) == 16


def test_exactly_once_decode_slow_consumer():
    reader = CountingReader(n=12)
    with TReplay(reader, prefetch=4) as s:
        out = []
        for _ in range(12):
            time.sleep(0.002)
            out.append(next(s)[1]["pos"])
    assert out == list(range(12))
    assert reader.calls == Counter({i: 1 for i in range(12)})


def test_close_during_decode_raises_then_reaps():
    reader = GatedReader(n=8)
    s = TReplay(reader, prefetch=2)
    assert reader.started.wait(timeout=10.0)
    with pytest.raises(TimeoutError):
        s.close(timeout=0.05)
    thread = s._thread
    assert thread is not None and thread.is_alive()
    reader.release.set()
    s.close(timeout=10.0)
    assert s._thread is None and not thread.is_alive()


def test_close_result_discarded_not_cached():
    reader = GatedReader(n=8)
    s = TReplay(reader, prefetch=2)
    assert reader.started.wait(timeout=10.0)
    with s._cv:
        s._stop = True
        s._cv.notify_all()
    reader.release.set()
    s.close(timeout=10.0)
    assert s._cache == {}


def test_seek_during_decode_invalidates():
    reader = GatedReader(n=16)
    reader.gate_on = {0}
    s = TReplay(reader, prefetch=2)
    try:
        assert reader.started.wait(timeout=10.0)
        s.seek(5)
        reader.release.set()
        assert _drain(s, 4) == [5, 6, 7, 8]
        assert 0 not in s._cache and s.consumed == 9
    finally:
        reader.release.set()
        s.close(timeout=10.0)


def test_seek_back_during_decode_no_stale_cache():
    reader = GatedReader(n=16)
    reader.gate_on = {3}
    s = TReplay(reader, start=3, prefetch=2)
    try:
        assert reader.started.wait(timeout=10.0)
        s.seek(3)
        reader.gate_on = set()
        reader.release.set()
        assert _drain(s, 3) == [3, 4, 5]
    finally:
        reader.release.set()
        s.close(timeout=10.0)


# --------------------------------------------------------------------------- #
# profiling
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fraction,n", [(0.05, 20), (0.2, 3), (1.0, 8)])
def test_profile_hot_ids_equal_reference(fraction, n):
    jg, tg = groups((1000, 300))
    stream = list(tsc.scenario_batches("flash_crowd", tg, n, batch_size=16,
                                       lookups_per_table=4, seed=SEED))
    got = tprof.profile_hot_ids(stream, tg, fraction)  # (ids, payload) items
    want = jprof.profile_hot_ids([ids for ids, _ in stream], jg, fraction)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="observed no lookups"):
        tprof.profile_hot_ids([], tg, fraction)


@pytest.mark.parametrize("profile_batches", [1, 5, 40])
def test_hot_ids_from_trace_equal_reference(ref_trace, profile_batches):
    path, _ = ref_trace
    got = tprof.hot_ids_from_trace(path, 0.1, profile_batches=profile_batches)
    want = jprof.hot_ids_from_trace(path, 0.1, profile_batches=profile_batches)
    np.testing.assert_array_equal(got, want)
    reader = tformat.TraceReader(path)
    np.testing.assert_array_equal(
        tprof.hot_ids_from_trace(reader, 0.1, profile_batches=profile_batches), want)


@pytest.mark.parametrize("num_slots,windows,kw", [
    (1000, (3, 2), {}),
    (300, (3, 2), {"profile_batches": 12}),  # the scratchpad evicts
    (200, (0, 0), {"quantiles": (0.25, 0.75), "align": 4, "max_buckets": 2}),
])
def test_derive_pad_buckets_equal_reference(tmp_path, num_slots, windows, kw):
    jg, _ = groups((500, 500))
    path = str(tmp_path / "drift")
    jrec.record_trace(path, jg, jsc.scenario_batches(
        "drift", jg, 16, batch_size=8, lookups_per_table=3, seed=SEED, drift_rate=0.02))
    pw, fw = windows
    got = tprof.derive_pad_buckets(path, num_slots, past_window=pw, future_window=fw, **kw)
    want = jprof.derive_pad_buckets(path, num_slots, past_window=pw, future_window=fw, **kw)
    assert got == want and len(got) > 0


# --------------------------------------------------------------------------- #
# Criteo ingestion
# --------------------------------------------------------------------------- #
def test_criteo_hash_and_parse_equal_reference():
    rng = np.random.default_rng(1)
    raws = ["", "0a1b2c3d", "not-hex!", "x" * 40, "ffffffff"] + [
        f"{int(v):08x}" for v in rng.integers(0, 2 ** 32, 50)]
    for raw in raws:
        for rows in (1, 37, 1000, 10_000_000):
            h = tcriteo.hash_feature(raw, rows)
            assert h == jcriteo.hash_feature(raw, rows) and 0 <= h < rows
    for line in _criteo_lines(10, seed=2) + ["bad\tline\n", "x" + "\t" * 39 + "\n"]:
        got, want = tcriteo.parse_criteo_line(line), jcriteo.parse_criteo_line(line)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0] and got[2] == want[2]
            np.testing.assert_array_equal(got[1], want[1])
    g = tcriteo.criteo_group([70, 40], 16)
    assert g.rows == (70, 40) and g.dim == 16


def test_criteo_ingest_deterministic_and_in_range(tmp_path):
    lines = _criteo_lines()
    lines.insert(2, "malformed\tline\n")
    rows = [70, 40, 90]
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    n1 = tcriteo.ingest_criteo_tsv(iter(lines), p1, table_rows=rows, batch_size=8)
    n2 = tcriteo.ingest_criteo_tsv(iter(lines), p2, table_rows=rows, batch_size=8)
    assert n1 == n2 == 5
    assert_same_files(p1, p2)
    r1 = tformat.TraceReader(p1)
    assert r1.meta.lookups_per_table == 1 and r1.group.num_tables == 3
    for i in range(n1):
        local = r1.local_ids(i)
        for t, nrows in enumerate(rows):
            assert 0 <= local[:, t, 0].min() and local[:, t, 0].max() < nrows
    _, payload = r1.batch(0)
    assert set(np.unique(payload["label"])) <= {0.0, 1.0}
    assert payload["dense"].min() >= 0.0
    tsv = tmp_path / "day.tsv"  # a file path, and a narrower column subset
    tsv.write_text("".join(_criteo_lines(20, seed=4)))
    assert tcriteo.ingest_criteo_tsv(str(tsv), str(tmp_path / "c"), table_rows=[50, 60],
                                     table_columns=[3, 7], batch_size=4) == 5


# --------------------------------------------------------------------------- #
# a recorded trace drives the port's runtimes as it drives the reference's
# --------------------------------------------------------------------------- #
def _stats(stats):
    drop = ("aux", "stage_times")
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in drop} for s in stats]


@pytest.mark.parametrize("design", ["scratchpipe", "static"])
def test_recorded_drift_trace_drives_port_runtimes_as_reference(tmp_path, design):
    """A recorded drift trace through the port's runtime and the
    reference's: the same StepStats; scratchpipe hits every lookup at
    [Train], a prefix-profiled static cache decays."""
    jg, _ = groups((2000, 2000))
    path = str(tmp_path / "drift")
    steps = 30
    jrec.record_trace(path, jg, jsc.scenario_batches(
        "drift", jg, steps, batch_size=32, lookups_per_table=4, seed=7, drift_rate=0.008))
    noop = lambda storage, slots, batch: (storage, None)  # noqa: E731
    if design == "static":
        kw = {"hot_ids": tprof.hot_ids_from_trace(path, 0.10, profile_batches=5)}
        j_kw = {"hot_ids": jprof.hot_ids_from_trace(path, 0.10, profile_batches=5)}
    else:
        slots = max(400, jg.window_floor(32 * 4) * 2)
        kw = j_kw = {"num_slots": slots}
    t_pipe = t_make_runtime(design, THost(4000, 8, seed=0), noop, device="cpu", **kw)
    j_pipe = j_make_runtime(design, JHost(4000, 8, seed=0), noop, **j_kw)
    with TReplay(path) as t_s, JReplay(path) as j_s:
        t_stats = t_pipe.run(t_s, lookahead_fn=t_s.peek_ids)
        j_stats = j_pipe.run(j_s, lookahead_fn=j_s.peek_ids)
    assert len(t_stats) == steps and _stats(t_stats) == _stats(j_stats)
    if design == "scratchpipe":
        assert all(s.hit_lookups == s.n_lookups for s in t_stats)
    else:
        rate = [s.hit_lookups / max(s.n_lookups, 1) for s in t_stats]
        assert np.mean(rate[:8]) - np.mean(rate[-8:]) > 0.15


def test_criteo_trace_replays_through_port_pipeline(tmp_path):
    """A hashed click-log trace (lookups = 1) drives the port's ScratchPipe
    to the reference's StepStats."""
    from repro.core.pipeline import ScratchPipe as JPipe
    from repro_torch.core.pipeline import ScratchPipe as TPipe

    path = str(tmp_path / "c")
    tcriteo.ingest_criteo_tsv(iter(_criteo_lines(70, seed=5)), path,
                              table_rows=[120, 120], batch_size=8)
    reader = tformat.TraceReader(path)
    noop = lambda s, sl, b: (s, None)  # noqa: E731
    slots = 2 * reader.group.window_floor(8)
    t_pipe = TPipe(THost(240, 128, seed=0), slots, noop, device="cpu")
    j_pipe = JPipe(JHost(240, 128, seed=0), slots, noop)
    with TReplay(reader) as t_s, JReplay(path) as j_s:
        t_stats = t_pipe.run(t_s, lookahead_fn=t_s.peek_ids)
        j_stats = j_pipe.run(j_s, lookahead_fn=j_s.peek_ids)
    assert len(t_stats) == reader.num_batches == 8
    assert _stats(t_stats) == _stats(j_stats)
    assert all(s.hit_lookups == s.n_lookups for s in t_stats)


def test_lookahead_and_replay_streams_agree(ref_trace):
    """The replay stream and a LookaheadStream over the generator expose
    the same look-ahead surface, step by step."""
    path, items = ref_trace
    la = TLookahead(iter(items))
    with TReplay(path, prefetch=2) as rs:
        while not (la.exhausted and rs.exhausted):
            a, b = la.peek_ids(3), rs.peek_ids(3)
            assert [x.tolist() for x in a] == [x.tolist() for x in b]
            if not b:
                break
            assert_items_equal(next(la), next(rs))
            assert la.consumed == rs.consumed


def test_package_exports():
    for name in ("TraceMeta", "TraceReader", "TraceWriter", "TraceRecorder",
                 "TraceReplayStream", "record_trace", "record_serving_trace",
                 "scenario_batches", "available_scenarios", "SCENARIOS",
                 "profile_hot_ids", "hot_ids_from_trace", "derive_pad_buckets"):
        assert hasattr(ttraces, name), name
    assert ttraces.available_scenarios() == jsc.available_scenarios()
