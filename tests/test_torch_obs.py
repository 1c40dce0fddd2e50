"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``), on the CPU — tests/test_obs.py O1-O7, ported:

  O1  registry: instrument dedup by (kind, name, labels), counter/gauge/
      histogram snapshots, the JSONL export valid under both packages'
      validators;
  O2  tracer: spans recorded on the EXECUTING thread; the Chrome export is
      valid with >= 3 threads; ``totals()`` attributes wall-clock to the
      (thread, span) that did the work; dangling spans are balanced;
  O3  opt-in is structural: without tracer/metrics a runtime holds none;
  O4  bit parity: ``executor="overlapped"`` WITH tracing and metrics is
      bitwise equal to untraced ``executor="sync"`` — at fp32 (both
      packages), and at fp16/int8 (the port; the reference's traced gather
      drops the quantize there and its int8 run raises); the set of span
      names per thread role equals the reference's;
  O5  counters: ``cache.*`` equal the StepStats sums (per-table cells
      included) and the reference's snapshot of the same run (names,
      labels, values of ``cache.*`` and ``traffic.*``);
  O6  serving: ``serve.*`` counters equal the replay's (requests, latency
      histogram count, emergency accounting vs StepStats.aux) and the
      reference's; bags bitwise equal to the oracle with telemetry on;
  O7  both packages' validators reject the same corrupt artifacts;

plus the baselines' ``step`` spans and counters, the sharded runtime's
per-shard cells, the device planner's ``plan.materialize`` span on the d2h
thread, and the launchers' ``--metrics-out``/``--trace-out`` artifacts,
which pass both packages' validators (``python -m repro_torch.obs.check``).
"""
import json
import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.pipeline import ScratchPipe as JPipe
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.serving_cache import NoCacheServer as JNoCacheServer
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.core.table_group import TableGroup as JGroup
from repro.data.lookahead import LookaheadStream as JStream
from repro.obs import check as jcheck
from repro.serving import replay_serving as j_replay
from repro.traces.scenarios import scenario_batches as j_scenario_batches
from repro_torch import obs
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TPipe
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.serving_cache import NoCacheServer as TNoCacheServer
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.core.sharded_pipeline import ShardedScratchPipe as TSharded
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.data.lookahead import LookaheadStream as TStream
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.obs import check as tcheck
from repro_torch.obs.check import validate_chrome_trace
from repro_torch.serving import replay_serving as t_replay

DIM = 8
VALIDATORS = {"port": tcheck, "reference": jcheck}


def j_count_train(storage, slots, batch):
    """[Train] = +1 per unique touched slot: integer-exact parity oracle."""
    uniq = jnp.unique(jnp.asarray(slots).ravel(), size=slots.size, fill_value=-1)
    ok = uniq >= 0
    add = jnp.zeros_like(storage).at[jnp.where(ok, uniq, 0)].add(
        jnp.where(ok, 1.0, 0.0)[:, None])
    return storage + add, {}


def t_count_train(storage, slots, batch):
    """The same +1 in the port, in place (a reduced-precision storage
    keeps its rows: the count reaches them only at fp32)."""
    if isinstance(storage, torch.Tensor) and storage.dtype == torch.float32:
        u = torch.unique(torch.as_tensor(np.asarray(slots)).reshape(-1).long())
        storage[u] += 1.0
    return storage, {}


def group_batches(scenario, steps=20, seed=7):
    group = JGroup.uniform(2, 400, DIM)
    batches = [g for g, _ in j_scenario_batches(scenario, group, steps, batch_size=4,
                                                 lookups_per_table=3, seed=seed)]
    return batches


def run_pipe(pkg, batches, precision="fp32", slots=96, **kw):
    """A counting run over a 2 x 400-row group from a zeroed table."""
    ref = pkg == "ref"
    group = (JGroup if ref else TGroup).uniform(2, 400, DIM)
    if precision != "fp32":
        group = group.with_precision(precision)
    host = (JHost if ref else THost)(group.total_rows, DIM, seed=1)
    host.data[:] = 0.0
    if not ref:
        kw["device"] = "cpu"
    pipe = (JPipe if ref else TPipe)(
        host, slots, j_count_train if ref else t_count_train, table_group=group,
        past_window=3, future_window=2, **kw)
    stream = (JStream if ref else TStream)(iter([(b, {}) for b in batches]))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.close()
    pipe.flush_to_host()
    return host.data.copy(), stats, pipe


def _role(thread_name: str) -> str:
    """A pool thread's role: its name without the worker index."""
    return re.sub(r"_\d+$", "", thread_name)


def spans_by_role(tracer):
    out = {}
    for tname, span in tracer.totals():
        out.setdefault(_role(tname), set()).add(span)
    return out


def snapshot(m, prefixes=("cache.", "traffic.", "serve.")):
    """{(kind, name, labels): value} of the cells under ``prefixes``
    (histograms by count)."""
    out = {}
    for r in m.snapshot():
        if r["name"].startswith(prefixes):
            v = r["count"] if r["kind"] == "histogram" else r["value"]
            out[(r["kind"], r["name"], tuple(sorted(r["labels"].items())))] = v
    return out


# ---------------------------------------------------------------------------
# O1: metrics registry
# ---------------------------------------------------------------------------
def test_registry_dedup_and_counter():
    m = obs.MetricsRegistry()
    a = m.counter("cache.hits", runtime="x")
    b = m.counter("cache.hits", runtime="x")
    c = m.counter("cache.hits", runtime="y")
    assert a is b and a is not c
    a.inc()
    a.inc(4)
    assert a.value == 5 and c.value == 0
    assert len(m) == 2


def test_gauge_probe_and_histogram():
    m = obs.MetricsRegistry()
    box = {"v": 0}
    m.gauge("probe", fn=lambda: box["v"])
    h = m.histogram("lat", unit="us")
    for v in (1, 2, 4, 100, 1000):
        h.observe(v)
    box["v"] = 42
    snap = {r["name"]: r for r in m.snapshot()}
    assert snap["probe"]["value"] == 42  # evaluated at snapshot time
    assert snap["lat"]["count"] == 5
    assert snap["lat"]["min"] == 1 and snap["lat"]["max"] == 1000
    assert snap["lat"]["p50"] <= snap["lat"]["p99"]
    # the reference's histogram buckets the same values the same way
    jh = jobs.MetricsRegistry().histogram("lat", unit="us")
    for v in (1, 2, 4, 100, 1000):
        jh.observe(v)
    assert jh.snapshot() == snap["lat"]
    # a probe that raises must not break the snapshot
    m.gauge("bad", fn=lambda: 1 / 0)
    bad = {r["name"]: r for r in m.snapshot()}["bad"]
    assert bad["value"] is None and "error" in bad


@pytest.mark.parametrize("validator", sorted(VALIDATORS))
def test_metrics_jsonl_schema(tmp_path, validator):
    m = obs.MetricsRegistry()
    m.counter("c").inc(3)
    m.gauge("g").set(1.5)
    m.histogram("h").observe(10)
    path = str(tmp_path / "m.jsonl")
    m.write_jsonl(path, provenance={"mode": "test"})
    assert VALIDATORS[validator].validate_metrics_jsonl(path) == []
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["schema"] == "obs_metrics/v1" == jobs.metrics.SCHEMA
    assert lines[0]["kind"] == "meta"
    assert lines[0]["provenance"] == {"mode": "test"}
    assert lines[0]["num_metrics"] == 3 == len(lines) - 1


# ---------------------------------------------------------------------------
# O2: tracer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("validator", sorted(VALIDATORS))
def test_chrome_trace_multithread(tmp_path, validator):
    tr = obs.Tracer()

    def worker(name):
        with tr.span(name, cat="host"):
            pass

    with tr.span("main_stage"):
        t1 = threading.Thread(target=worker, args=("w1",), name="worker-1")
        t2 = threading.Thread(target=worker, args=("w2",), name="worker-2")
        t1.start(), t2.start()
        t1.join(), t2.join()
    tr.instant("marker")
    path = str(tmp_path / "t.json")
    assert tr.export_chrome(path) > 0
    assert VALIDATORS[validator].validate_chrome_trace(path, min_threads=3) == []
    doc = json.load(open(path))
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"worker-1", "worker-2"} <= names
    totals = tr.totals()
    assert ("worker-1", "w1") in totals and ("worker-2", "w2") in totals


def test_dangling_span_balanced(tmp_path):
    tr = obs.Tracer()
    s = tr.span("never_closed")
    s.__enter__()  # a thread that died mid-span
    path = str(tmp_path / "d.json")
    tr.export_chrome(path)
    assert validate_chrome_trace(path) == []
    assert jcheck.validate_chrome_trace(path) == []


def test_wrap_attributes_to_executing_thread():
    tr = obs.Tracer()
    fn = tr.wrap("work", lambda x: x + 1, cat="host")
    out = {}
    t = threading.Thread(target=lambda: out.update(r=fn(1)), name="exec-thread")
    t.start()
    t.join()
    assert out["r"] == 2
    assert ("exec-thread", "work") in tr.totals()


# ---------------------------------------------------------------------------
# O3: opt-out is structural
# ---------------------------------------------------------------------------
def test_metrics_off_default_structure():
    _, _, pipe = run_pipe("port", group_batches("drift", steps=4))
    assert pipe._tracer is None and pipe._mc is None and pipe._sv is None
    assert pipe._gather_fn.__name__ != "_traced"


def test_install_resolve_precedence():
    g = obs.MetricsRegistry()
    local = obs.MetricsRegistry()
    obs.install(None, g)
    try:
        assert obs.resolve(None, None) == (None, g)
        assert obs.resolve(None, local) == (None, local)  # explicit wins
        _, _, pipe = run_pipe("port", group_batches("drift", steps=4))
        assert pipe._metrics is g  # the global install, resolved at construction
    finally:
        obs.install(None, None)
    assert obs.resolve(None, None) == (None, None)


# ---------------------------------------------------------------------------
# O4: bit parity under tracing, and the span names per thread
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["drift", "flash_crowd"])
def test_traced_overlapped_parity(scenario):
    batches = group_batches(scenario)
    want, want_stats, _ = run_pipe("port", batches, executor="sync")
    tr, m = obs.Tracer(), obs.MetricsRegistry()
    got, got_stats, _ = run_pipe("port", batches, executor="overlapped", tracer=tr,
                                 metrics=m)
    np.testing.assert_array_equal(got, want)
    assert [s.n_hits for s in got_stats] == [s.n_hits for s in want_stats]
    assert [s.n_evict for s in got_stats] == [s.n_evict for s in want_stats]
    # the same run through the reference: equal tables, and the same span
    # names on the same thread roles
    jtr = jobs.Tracer()
    jtable, _, _ = run_pipe("ref", batches, executor="overlapped", tracer=jtr,
                            metrics=jobs.MetricsRegistry())
    np.testing.assert_array_equal(got, jtable)
    roles = spans_by_role(tr)
    assert roles == spans_by_role(jtr)
    assert roles["scratchpipe-host"] == {"collect.gather", "insert.writeback"}
    assert roles["scratchpipe-d2h"] == {"exchange.d2h"}
    assert {"plan", "collect", "exchange", "insert_host", "insert_fill",
            "train"} <= roles["MainThread"]


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_traced_reduced_precision_overlapped_bitwise(precision):
    """The traced gather is the precision's own (quantizing) one, so a
    traced overlapped fp16/int8 run is bitwise equal to the untraced one
    (the reference's traced gather is the raw host gather: its int8 run
    raises, its fp16 run ships fp32 rows)."""
    batches = group_batches("drift")
    want, want_stats, want_pipe = run_pipe("port", batches, precision=precision,
                                           slots=48, executor="sync")
    tr = obs.Tracer()
    got, got_stats, pipe = run_pipe("port", batches, precision=precision, slots=48,
                                    executor="overlapped", tracer=tr,
                                    metrics=obs.MetricsRegistry())
    assert sum(s.n_evict for s in got_stats) > 0
    assert [(s.n_hits, s.n_miss, s.n_evict) for s in got_stats] == [
        (s.n_hits, s.n_miss, s.n_evict) for s in want_stats]
    np.testing.assert_array_equal(got, want)
    for a, b in zip((pipe.storage if precision == "int8" else [pipe.storage]),
                    (want_pipe.storage if precision == "int8" else [want_pipe.storage])):
        assert torch.equal(a, b)
    assert ("scratchpipe-host_0", "collect.gather") in tr.totals()


def test_device_planner_materialize_span_on_d2h():
    batches = group_batches("drift")
    want, _, _ = run_pipe("port", batches, executor="sync")
    tr = obs.Tracer()
    got, _, pipe = run_pipe("port", batches, executor="overlapped", planner="device",
                            tracer=tr)
    np.testing.assert_array_equal(got, want)
    roles = spans_by_role(tr)
    assert roles["scratchpipe-d2h"] == {"exchange.d2h", "plan.materialize"}


# ---------------------------------------------------------------------------
# O5: counter correctness vs StepStats and the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", ["drift", "flash_crowd"])
def test_counters_match_stepstats(scenario):
    batches = group_batches(scenario)
    m = obs.MetricsRegistry()
    _, stats, pipe = run_pipe("port", batches, metrics=m)
    lbl = {"runtime": "scratchpipe"}
    assert m.counter("cache.cycles", **lbl).value == len(stats)
    assert m.counter("cache.lookups", **lbl).value == sum(s.n_lookups for s in stats)
    assert m.counter("cache.unique", **lbl).value == sum(s.n_unique for s in stats)
    assert m.counter("cache.hits", **lbl).value == sum(s.n_hits for s in stats)
    assert m.counter("cache.misses", **lbl).value == sum(s.n_miss for s in stats)
    assert m.counter("cache.evicts", **lbl).value == sum(s.n_evict for s in stats)
    for i, t in enumerate(pipe.table_group.tables):
        assert m.counter("cache.hits", table=t.name, **lbl).value == sum(
            int(s.by_table["hits"][i]) for s in stats)
        assert m.counter("cache.misses", table=t.name, **lbl).value == sum(
            int(s.by_table["misses"][i]) for s in stats)
    snap = {(r["name"], r["labels"].get("runtime")): r for r in m.snapshot()}
    assert snap[("traffic.host.read_bytes", "scratchpipe")]["value"] > 0
    # the reference's snapshot of the same run: the same cells, the same values
    jm = jobs.MetricsRegistry()
    run_pipe("ref", batches, metrics=jm)
    assert snapshot(m) == snapshot(jm)


@pytest.mark.parametrize("runtime", ["nocache", "static"])
def test_baseline_step_spans_and_counters(runtime):
    batches = group_batches("drift", steps=8)
    hot = np.arange(0, 800, 4)
    snaps = {}
    for pkg in ("port", "ref"):
        ref = pkg == "ref"
        m, tr = (jobs if ref else obs).MetricsRegistry(), (jobs if ref else obs).Tracer()
        host = (JHost if ref else THost)(800, DIM, seed=1)
        kw = {"hot_ids": hot} if runtime == "static" else {}
        if not ref:
            kw["device"] = "cpu"
        make = j_make_runtime if ref else t_make_runtime
        rt = make(runtime, host, j_count_train if ref else t_count_train, tracer=tr,
                  metrics=m, **kw)
        stats = rt.run(iter([(b, {}) for b in batches]))
        assert m.counter("cache.cycles", runtime=runtime).value == len(stats) == 8
        assert {s for _, s in tr.totals()} == {"step"}
        snaps[pkg] = snapshot(m)
    assert snaps["port"] == snaps["ref"]


def test_sharded_per_shard_cells():
    rows, shards = 240, 3
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, rows, size=14) for _ in range(10)]
    m, tr = obs.MetricsRegistry(), obs.Tracer()
    host = THost(rows, 4, seed=1)
    rt = TSharded(host, 80, shards, lambda s, sl, b: (list(s), {}), tracer=tr, metrics=m,
                  executor="overlapped", device="cpu")
    stats = rt.run(iter([(b, {}) for b in batches]))
    rt.close()
    for i in range(shards):
        c = m.counter("cache.cycles", runtime="scratchpipe", shard=str(i))
        assert c.value == len(rt.pipes[i].stats) == len(stats)
    assert spans_by_role(tr)["scratchpipe-host"] == {"collect.gather"}


# ---------------------------------------------------------------------------
# O6: serving counters
# ---------------------------------------------------------------------------
def test_serving_counters_and_latency():
    batches = group_batches("flash_crowd", steps=16)
    snaps = {}
    for pkg in ("port", "ref"):
        ref = pkg == "ref"
        group = (JGroup if ref else TGroup).uniform(2, 400, DIM)
        m, tr = (jobs if ref else obs).MetricsRegistry(), (jobs if ref else obs).Tracer()
        kw = {} if ref else {"device": "cpu"}
        host = (JHost if ref else THost)(group.total_rows, DIM, seed=2)
        srv = (JServer if ref else TServer)(host, 96, window=2, table_group=group,
                                            tracer=tr, metrics=m, **kw)
        res = (j_replay if ref else t_replay)(srv, batches, depth=1)
        lbl = {"runtime": "scratchpipe-serve"}
        assert m.counter("serve.requests", **lbl).value == res["served"] == len(batches)
        hist = {r["name"]: r for r in m.snapshot() if r["kind"] == "histogram"}
        assert hist["serve.latency_us"]["count"] == res["served"]
        assert {"serve", "serve.plan", "serve.advance"} <= {s for _, s in tr.totals()}
        snaps[pkg] = snapshot(m)
    # oracle emergency accounting from an untelemetried replay
    group = TGroup.uniform(2, 400, DIM)
    srv2 = TServer(THost(group.total_rows, DIM, seed=2), 96, window=2, table_group=group,
                   device="cpu")
    emergencies = []
    for b in batches:
        srv2.enqueue(b)
        _, st, _ = srv2.serve_next()
        emergencies.append(st.aux.get("emergency", 0))
    lbl = {"runtime": "scratchpipe-serve"}
    assert snaps["port"][("counter", "serve.emergency_rows", tuple(lbl.items()))] == sum(
        emergencies)
    assert snaps["port"][("counter", "serve.emergency_serves", tuple(lbl.items()))] == sum(
        1 for e in emergencies if e)
    assert snaps["port"] == snaps["ref"]


def test_serving_parity_with_telemetry():
    batches = group_batches("drift", steps=12)
    group = TGroup.uniform(2, 400, DIM)
    oracle = t_replay(TNoCacheServer(THost(group.total_rows, DIM, seed=2), device="cpu"),
                      batches, depth=0, collect_bags=True)["bags"]
    m, tr = obs.MetricsRegistry(), obs.Tracer()
    srv = TServer(THost(group.total_rows, DIM, seed=2), 128, window=2, table_group=group,
                  tracer=tr, metrics=m, device="cpu")
    bags = t_replay(srv, batches, depth=2, collect_bags=True)["bags"]
    for i, (a, b) in enumerate(zip(bags, oracle)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
    jbags = j_replay(JNoCacheServer(JHost(group.total_rows, DIM, seed=2)), batches,
                     depth=0, collect_bags=True)["bags"]
    for a, b in zip(bags, jbags):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# O7: validators reject corruption — both packages', the same files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("validator", sorted(VALIDATORS))
def test_validators_reject_bad_artifacts(tmp_path, validator):
    v = VALIDATORS[validator]
    bad_trace = tmp_path / "bad.json"
    bad_trace.write_text("{not json")
    assert v.validate_chrome_trace(str(bad_trace)) != []
    # unbalanced + non-monotone events
    evil = {"traceEvents": [
        {"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 10.0},
        {"ph": "E", "pid": 1, "tid": 1, "ts": 5.0},
        {"ph": "E", "pid": 1, "tid": 1, "ts": 6.0},
    ]}
    evil_path = tmp_path / "evil.json"
    evil_path.write_text(json.dumps(evil))
    assert v.validate_chrome_trace(str(evil_path)) != []
    bad_metrics = tmp_path / "bad.jsonl"
    bad_metrics.write_text('{"kind": "counter", "name": "x"}\n')
    assert v.validate_metrics_jsonl(str(bad_metrics)) != []
    # the two packages name the same problems
    other = VALIDATORS["reference" if validator == "port" else "port"]
    for f in (bad_trace, evil_path):
        assert v.validate_chrome_trace(str(f)) == other.validate_chrome_trace(str(f))
    assert v.validate_metrics_jsonl(str(bad_metrics)) == other.validate_metrics_jsonl(
        str(bad_metrics))


# ---------------------------------------------------------------------------
# the launchers' artifacts, checked by both packages
# ---------------------------------------------------------------------------
def test_train_launcher_artifacts_pass_both_validators(tmp_path, capsys):
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "10", "--device",
                  "cpu", "--executor", "overlapped", "--planner", "device",
                  "--trace-out", t, "--metrics-out", m])
    out = capsys.readouterr().out
    assert f"metrics snapshot -> {m}" in out and f"chrome trace -> {t}" in out
    assert obs.get_tracer() is None and obs.get_metrics() is None  # cleared
    for v in VALIDATORS.values():
        assert v.validate_chrome_trace(t, min_threads=3) == []
        assert v.validate_metrics_jsonl(m) == []
    assert tcheck.main(["--trace", t, "--metrics", m, "--min-threads", "3"]) == 0
    head = json.loads(open(m).readline())
    assert head["provenance"]["executor"] == "overlapped"
    cycles = [json.loads(line) for line in open(m)
              if '"cache.cycles"' in line][0]["value"]
    assert cycles == 10


def test_serve_launcher_artifacts(tmp_path, capsys):
    t, m = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    res = tserve.main(["--embedding", "--device", "cpu", "--steps", "12", "--tables", "2",
                       "--rows", "2000", "--dim", "16", "--batch", "8", "--lookups", "4",
                       "--depth", "2", "--trace-out", t, "--metrics-out", m])
    for v in VALIDATORS.values():
        assert v.validate_chrome_trace(t) == []
        assert v.validate_metrics_jsonl(m) == []
    requests = [json.loads(line) for line in open(m) if '"serve.requests"' in line]
    assert requests[0]["value"] == res["served"] == 12
    assert tcheck.main(["--metrics", str(tmp_path / "missing.jsonl")]) == 1
