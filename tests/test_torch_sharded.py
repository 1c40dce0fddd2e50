"""The port's sharded runtime (``core/sharded_pipeline.py:
ShardedScratchPipe``, ``make_runtime("sharded", ...)``) on the CPU, against
the JAX package's.

The [Train] of these tests is the reference tests' counting step: +1.0 on
each unique touched slot of each shard, so every result is an exact
integer count and the port is held BITWISE to the reference:

  * tests/test_sharded_pipeline.py: N shards equal the single-manager
    runtime, the exact counts and the reference's sharded run; bucketing is
    a partition of the batch's ids, equal to the reference's;
  * ``test_multi_table_dlrm_sharded_from_group`` of tests/test_table_group.py:
    one manager per table of a heterogeneous group;
  * the ``sharded`` cells of tests/test_device_planner.py and
    tests/test_fastpath.py on recorded drift and flash_crowd traces: every
    planner x executor combination gives the reference's host/sync flushed
    table, per-shard storages, StepStats and byte counters;
  * ``run_one_cycle``/``drain_one_cycle`` driving equals ``run``;
  * mixed per-table precisions (tests/test_precision_parity.py): each
    manager's storage has its table's format and budget; with a [Train] that
    changes nothing, each flushed row equals the numpy quantize-then-
    dequantize of its host row where it was loaded, and rows never loaded
    stay as they were;
  * the deferred global [Train] runs on the calling thread under
    ``overlapped``; item 12's options raise with their ROADMAP pointer.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.sharded_pipeline import ShardedScratchPipe as JSharded
from repro.core.table_group import TableGroup as JGroup
from repro.core.table_group import TableSpec as JSpec
from repro.data.lookahead import LookaheadStream as JStream
from repro.traces import TraceReplayStream as JReplay
from repro_torch.core import quantize as tqz
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TScratchPipe
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.sharded_pipeline import ShardedScratchPipe as TSharded
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.core.table_group import TableSpec as TSpec
from repro_torch.data.lookahead import LookaheadStream as TStream
from repro_torch.data.synthetic import dlrm_batches_group
from repro_torch.kernels import ops as tops
from repro_torch.traces import TraceReplayStream, record_trace, scenario_batches

#: (planner, executor)
OPTIONS = [("host", "sync"), ("device", "sync"), ("host", "overlapped"),
           ("device", "overlapped")]
GROUP4 = [("users", 90, 4, 0.2), ("items", 60, 4, 0.3), ("cats", 25, 4, 0.5),
          ("geo", 40, 4, 0.25)]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _plain_stats(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items()
             if k not in ("aux", "stage_times", "by_table")} for s in stats]


def t_single_train(storage, slots, batch):
    """Single manager: +1 to every unique touched slot, in place."""
    u = torch.unique(torch.as_tensor(slots).reshape(-1).long())
    storage[u] += 1.0
    return storage, {"touched": int(u.numel())}


def t_sharded_train(storages, slots_all, batch):
    """The same +1 per shard (the global [Train]), in place."""
    touched = 0
    for storage, slots in zip(storages, slots_all):
        s = torch.as_tensor(slots).reshape(-1).long()
        if s.numel():
            u = torch.unique(s)
            storage[u] += 1.0
            touched += int(u.numel())
    return storages, {"touched": touched}


def j_sharded_train(storages, slots_all, batch):
    out, touched = [], 0
    for storage, slots in zip(storages, slots_all):
        slots = np.asarray(slots)
        if slots.size:
            u = np.unique(slots.ravel())
            storage = storage.at[jnp.asarray(u)].add(1.0)
            touched += u.size
        out.append(storage)
    return out, {"touched": touched}


def _zeroed(Host, rows, dim):
    host = Host(rows, dim, seed=1)
    host.data[:] = 0.0
    return host


def _exact_counts(batches, rows, dim):
    want = np.zeros((rows, dim), np.float32)
    for b in batches:
        want[np.unique(b)] += 1.0
    return want


# ---------------------------------------------------------------------------
# tests/test_sharded_pipeline.py
# ---------------------------------------------------------------------------
def test_sharded_equals_single_and_reference():
    rows, dim, n_shards, steps = 240, 4, 3, 25
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, rows, size=14) for _ in range(steps)]

    host1 = _zeroed(THost, rows, dim)
    pipe1 = TScratchPipe(host1, 120, t_single_train, device="cpu")
    s1 = TStream(iter([(b, {}) for b in batches]))
    stats1 = pipe1.run(s1, lookahead_fn=s1.peek_ids)
    pipe1.flush_to_host()

    host2 = _zeroed(THost, rows, dim)
    pipe2 = TSharded(host2, 80, n_shards, t_sharded_train, device="cpu")
    stats2 = pipe2.run(iter([(b, {}) for b in batches]))
    pipe2.flush_to_host()

    host3 = _zeroed(JHost, rows, dim)
    pipe3 = JSharded(host3, 80, n_shards, j_sharded_train)
    stats3 = pipe3.run(iter([(b, {}) for b in batches]))
    pipe3.flush_to_host()

    assert len(stats1) == len(stats2) == steps
    np.testing.assert_array_equal(host2.data, host1.data)
    np.testing.assert_array_equal(host1.data, _exact_counts(batches, rows, dim))
    np.testing.assert_array_equal(host2.data, host3.data)
    assert sum(s.aux["touched"] for s in stats1) == sum(
        s.aux["touched"] for s in stats2 if s.aux)
    assert _plain_stats(stats2) == _plain_stats(stats3)
    for a, b in zip(pipe2.pipes, pipe3.pipes):
        np.testing.assert_array_equal(np.asarray(a.storage), np.asarray(b.storage))
    assert {k: dataclasses.asdict(v) for k, v in pipe2.traffic().items()} == {
        k: dataclasses.asdict(v) for k, v in pipe3.traffic().items()}


def test_sharded_bucketing_is_partition():
    host = THost(120, 4, seed=0)
    pipe = TSharded(host, 40, 4, lambda s, sl, b: (list(s), None), device="cpu")
    ids = np.arange(0, 120, 7)
    buckets = pipe._bucket(ids)
    recon = np.sort(np.concatenate([b + i * 30 for i, b in enumerate(buckets)]))
    np.testing.assert_array_equal(recon, np.sort(ids))
    ref = JSharded(JHost(120, 4, seed=0), 40, 4, lambda s, sl, b: (list(s), None))
    for a, b in zip(buckets, ref._bucket(ids)):
        np.testing.assert_array_equal(a, b)
    # the shard tables are views of the caller's table: write-backs land there
    assert all(np.shares_memory(p.host.data, host.data) for p in pipe.pipes)
    assert pipe.rows_per_shard == 30


def test_multi_table_dlrm_sharded_from_group():
    """Per-table shard managers (§VI-G) over a heterogeneous TableGroup."""
    steps = 20
    rng = np.random.default_rng(2)
    g = TGroup([TSpec(*s) for s in GROUP4])
    batches = [np.concatenate([g.to_global(t, rng.integers(0, g.tables[t].rows, size=4))
                               for t in range(4)]) for _ in range(steps)]
    host = _zeroed(THost, g.total_rows, g.dim)
    pipe = t_make_runtime("sharded", host, t_sharded_train, num_slots=120, table_group=g,
                          device="cpu")
    assert pipe.num_shards == 4 and [p.num_slots for p in pipe.pipes] == g.slot_budgets(120)
    stats = pipe.run(iter([(b, {}) for b in batches]))
    pipe.flush_to_host()
    assert len(stats) == steps
    np.testing.assert_array_equal(host.data, _exact_counts(batches, g.total_rows, g.dim))
    jhost = _zeroed(JHost, g.total_rows, g.dim)
    jpipe = j_make_runtime("sharded", jhost, j_sharded_train, num_slots=120,
                           table_group=JGroup([JSpec(*s) for s in GROUP4]))
    jstats = jpipe.run(iter([(b, {}) for b in batches]))
    jpipe.flush_to_host()
    np.testing.assert_array_equal(host.data, jhost.data)
    assert _plain_stats(stats) == _plain_stats(jstats)


# ---------------------------------------------------------------------------
# the sharded cells of tests/test_device_planner.py and tests/test_fastpath.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["drift", "flash_crowd"])
def recorded_trace(request, tmp_path_factory):
    group = TGroup([TSpec("a", 400, 8), TSpec("b", 200, 8)])
    path = str(tmp_path_factory.mktemp("sharded") / request.param)
    n = record_trace(path, group, scenario_batches(
        request.param, group, 30, batch_size=4, lookups_per_table=3, seed=11))
    assert n == 30
    return path, group


def _trace_run(pkg, path, group, **kw):
    """The sharded counting run over a recorded trace (num_slots 240, one
    manager per table): (flushed table, per-shard storages, stats, traffic)."""
    if pkg == "ref":
        host = JHost(group.total_rows, group.dim, seed=1)
        tg = JGroup([JSpec(t.name, t.rows, t.dim) for t in group.tables])
        rt = j_make_runtime("sharded", host, j_sharded_train, num_slots=240,
                            table_group=tg, **kw)
        replay = JReplay
    else:
        host = THost(group.total_rows, group.dim, seed=1)
        rt = t_make_runtime("sharded", host, t_sharded_train, num_slots=240,
                            table_group=group, device="cpu", **kw)
        replay = TraceReplayStream
    with replay(path, prefetch=0) as stream:
        stats = rt.run(stream, lookahead_fn=stream.peek_ids)
    rt.flush_to_host()
    traffic = {k: (t.read, t.written) for k, t in rt.traffic().items()}
    storages = [np.array(p.storage, copy=True) for p in rt.pipes]
    rt.close()
    return host.data.copy(), storages, stats, traffic


@pytest.mark.parametrize("planner,executor", OPTIONS)
def test_sharded_matches_reference(recorded_trace, planner, executor):
    path, group = recorded_trace
    j = _trace_run("ref", path, group, planner="host", executor="sync")
    t = _trace_run("port", path, group, planner=planner, executor=executor)
    np.testing.assert_array_equal(t[0], j[0])
    assert len(t[1]) == len(j[1]) == 2
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    assert _plain_stats(t[2]) == _plain_stats(j[2])
    assert t[3] == j[3]


@pytest.mark.parametrize("planner", ["host", "device"])
def test_incremental_driving_matches_run(recorded_trace, planner):
    """``run_one_cycle`` per batch with the stream's look-ahead, then
    ``drain_one_cycle`` until empty: the result of ``run``."""
    path, group = recorded_trace
    want = _trace_run("port", path, group, planner=planner)
    host = THost(group.total_rows, group.dim, seed=1)
    rt = TSharded.from_group(host, 240, group, t_sharded_train, planner=planner,
                             device="cpu")
    stats = []
    with TraceReplayStream(path, prefetch=0) as stream:
        for ids, batch in stream:
            st = rt.run_one_cycle(ids, batch, stream.peek_ids)
            if st is not None:
                stats.append(st)
    while any(p._window for p in rt.pipes):
        st = rt.drain_one_cycle()
        if st is not None:
            stats.append(st)
    rt.flush_to_host()
    np.testing.assert_array_equal(host.data, want[0])
    assert _plain_stats(stats) == _plain_stats(want[2])


def test_global_train_runs_on_the_calling_thread():
    g = TGroup([TSpec(*s) for s in GROUP4])
    seen = []

    def train(storages, slots_all, batch):
        seen.append(threading.current_thread() is threading.main_thread())
        return t_sharded_train(storages, slots_all, batch)

    host = _zeroed(THost, g.total_rows, g.dim)
    rt = TSharded.from_group(host, 120, g, train, executor="overlapped",
                             planner="device", device="cpu")
    batches = list(dlrm_batches_group(g, 12, batch_size=4, lookups_per_table=2, seed=3))
    stream = TStream(iter(batches))
    stats = rt.run(stream, lookahead_fn=stream.peek_ids)
    rt.flush_to_host()
    rt.close()
    assert len(stats) == 12 and len(seen) == 12 and all(seen)
    np.testing.assert_array_equal(
        host.data, _exact_counts([b for b, _ in batches], g.total_rows, g.dim))


def test_not_ported_options_name_item_12():
    """Item 12's options are ported: they build, pass through to every
    shard, and the state round-trips (shard<i>_ keys)."""
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.runtime import SupervisePolicy

    host = THost(40, 4)
    noop = lambda s, sl, b: (list(s), None)  # noqa: E731
    tr, m = Tracer(), MetricsRegistry()
    rt = TSharded(host, 20, 2, noop, executor="overlapped", supervise=SupervisePolicy(),
                  tracer=tr, metrics=m, device="cpu")
    assert all(p._sv is not None and p._tracer is tr and p._metrics is m for p in rt.pipes)
    for b in (np.arange(0, 40, 3), np.arange(1, 40, 5)):
        rt.run_one_cycle(b, {})
    st = rt.state_arrays()
    assert {k.split("_", 1)[0] for k in st} == {"shard0", "shard1"}
    rt.close()
    rt2 = TSharded(THost(40, 4, seed=5), 20, 2, noop, device="cpu")
    rt2.load_state_arrays(st)
    np.testing.assert_array_equal(rt2.pipes[0].host.data, host.data[:20])
    assert len(rt2.pipes[1]._window) == 2
    with pytest.raises(KeyError, match="shard 0"):
        rt2.load_state_arrays({})


# ---------------------------------------------------------------------------
# mixed per-table precisions (tests/test_precision_parity.py)
# ---------------------------------------------------------------------------
def test_sharded_realizes_mixed_precisions():
    group = TGroup([TSpec("a", 400, 8, precision="int8"),
                    TSpec("b", 200, 8, precision="fp16")])
    host = THost(group.total_rows, 8, seed=1)
    pipe = TSharded.from_group(host, 120, group, lambda s, sl, b: (s, None), device="cpu")
    assert pipe.precisions == ("int8", "fp16")
    assert isinstance(pipe.pipes[0].storage, tqz.QuantStorage)
    assert pipe.pipes[1].storage.dtype == torch.float16
    budgets = group.slot_budgets(120)
    assert pipe.pipes[0].num_slots == budgets[0] * 4
    assert pipe.pipes[1].num_slots == budgets[1] * 2
    jgroup = JGroup([JSpec("a", 400, 8, precision="int8"),
                     JSpec("b", 200, 8, precision="fp16")])
    jpipe = JSharded.from_group(JHost(600, 8, seed=1), 120, jgroup,
                                lambda s, sl, b: (s, None))
    assert [p.num_slots for p in jpipe.pipes] == [p.num_slots for p in pipe.pipes]
    pipe.close()


@pytest.mark.parametrize("precisions", [("int8", "fp16", "fp32"), ("fp32", "int8", "fp16")])
def test_mixed_precision_shards_flush_their_quantized_rows(precisions):
    """A [Train] that changes nothing: a loaded row comes back as the
    quantize-then-dequantize of its master (under eviction pressure, rows
    are written back and loaded again), a row never loaded stays as it was;
    the per-shard stats and bytes equal the reference's."""
    specs = [("a", 2000, 8), ("b", 800, 8), ("c", 400, 8)]
    group = TGroup([TSpec(n, r, d, precision=p) for (n, r, d), p in zip(specs, precisions)])
    batches = list(dlrm_batches_group(group, 16, batch_size=4, lookups_per_table=3,
                                      seed=5))
    host = THost(group.total_rows, 8, seed=2)
    master = host.data.copy()
    noop = lambda s, sl, b: (s, None)  # noqa: E731
    # nominal budgets that hold each table's 6-batch window (72 rows) exactly
    budgets = [72 // tqz.SLOT_MULTIPLIER[p] for p in precisions]
    rt = t_make_runtime("sharded", host, noop, num_slots=0, table_group=group,
                        slot_budgets=budgets, device="cpu")
    assert [p.num_slots for p in rt.pipes] == [72, 72, 72]
    stream = TStream(iter(batches))
    rt.run(stream, lookahead_fn=stream.peek_ids)
    traffic = {k: dataclasses.asdict(v) for k, v in rt.traffic().items()}
    rt.flush_to_host()
    assert all(sum(s.n_evict for s in p.stats) > 0 for p in rt.pipes)
    loaded = np.zeros(group.total_rows, bool)
    loaded[np.unique(np.concatenate([b.ravel() for b, _ in batches]))] = True
    for t, prec in enumerate(precisions):
        sl = group.row_slice(t)
        want = tqz.dequantize_rows_np(tqz.quantize_rows_np(master[sl], prec), prec)
        want = np.where(loaded[sl][:, None], want, master[sl])
        np.testing.assert_array_equal(host.data[sl], want, err_msg=prec)
    jgroup = JGroup([JSpec(n, r, d, precision=p) for (n, r, d), p in zip(specs, precisions)])
    jrt = j_make_runtime("sharded", JHost(group.total_rows, 8, seed=2), noop, num_slots=0,
                         table_group=jgroup, slot_budgets=budgets)
    js = JStream(iter(batches))
    jrt.run(js, lookahead_fn=js.peek_ids)
    for a, b in zip(rt.pipes, jrt.pipes):
        assert _plain_stats(a.stats) == _plain_stats(b.stats)
    assert traffic == {k: dataclasses.asdict(v) for k, v in jrt.traffic().items()}
