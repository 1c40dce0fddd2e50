"""Serving recovery in the port, against itself and against the reference,
on the CPU (tests/test_recovery.py:248-393 and tests/test_chaos.py:287-331,
ported):

  * a server checkpointed mid-queue (requests queued at every pipeline
    stage) and restored into a fresh server serves bags bitwise equal to the
    uninterrupted server's, with the same StepStats, at fp32 and int8;
  * warm start from a TRAINING checkpoint (``ScratchPipe.state_arrays()``,
    host and device planner, fp32/fp16/int8; the sharded layout): every
    extracted row lands, serving them is an immediate full hit, and fp32
    bags equal the host rows and the ``nocache-serve`` oracle's bitwise;
    warm-started from the reference's training checkpoint, the port's
    server and the reference's preload the same rows and serve the same
    bags and StepStats; a non-empty server is refused;
  * fetch faults: a killed prefetch is retried (``serve.fetch_failures`` 1,
    ``serve.failsafe`` 0); exhausted retries fall through to the emergency
    path (both counters 2); the bags equal a clean run's and the
    reference's, and every fill (retry, emergency, warm start) runs on the
    thread that drives the server, the front end's worker;
  * ACROSS PACKAGES: a reference server's mid-queue state carried into the
    port (``convert.load_reference_server_state``) and a port server's into
    the reference (``convert.server_state_to_reference``), each continuing
    with bags equal and StepStats exact;
  * ``launch/serve.py --warm-start`` on a checkpoint of
    ``launch/train.py --supervise`` prints the reference launcher's
    ``warm start:`` line and its ``hit_rate=`` line.
"""
import contextlib
import dataclasses
import io
import sys
import threading

import jax
import numpy as np
import pytest

from repro.chaos import ChaosInjector as JInjector
from repro.chaos import ChaosPlan as JPlan
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.pipeline import ScratchPipe as JPipe
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.core.serving_cache import resident_set_from_state as j_resident_set
from repro.core.table_group import TableGroup as JGroup
from repro.obs import MetricsRegistry as JMetrics
from repro_torch import convert
from repro_torch.chaos import ChaosInjector, ChaosPlan
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import serving_cache as tsc
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TPipe
from repro_torch.core.serving_cache import NoCacheServer as TNoCache
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.core.serving_cache import resident_set_from_state
from repro_torch.core.sharded_pipeline import ShardedScratchPipe as TSharded
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.obs import MetricsRegistry
from repro_torch.serving.frontend import EmbeddingServer

ROWS, DIM, SLOTS = 256, 8, 64


def _server(pkg="port", metrics=False, **kw):
    if pkg == "port":
        m = MetricsRegistry() if metrics else None
        return TServer(THost(ROWS, DIM, seed=1), SLOTS, window=2, device="cpu",
                       metrics=m, **kw)
    m = JMetrics() if metrics else None
    return JServer(JHost(ROWS, DIM, seed=1), SLOTS, window=2, metrics=m, **kw)


def _group(pkg, precision="fp32"):
    g = (TGroup if pkg == "port" else JGroup).uniform(2, ROWS // 2, DIM)
    return g.with_precision(precision)


def _requests(n=12, seed=0, shape=(2, 1, 4)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ROWS, size=shape) for _ in range(n)]


def _serve_all(server, reqs):
    out = []
    for r in reqs:
        server.enqueue(r)
        if server.pending > server.queue_depth:
            out.append(server.serve_next()[:2])
    while server.pending:
        out.append(server.serve_next()[:2])
    return out


def _same(got, want):
    assert len(got) == len(want)
    for i, ((a, sa), (b, sb)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"serve {i}")
        assert dataclasses.asdict(sa) == dataclasses.asdict(sb), f"stats of serve {i}"


def _counter(server, name):
    return server._mc[name].value


@pytest.fixture(autouse=True)
def _no_launches():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# --------------------------------------------------------------------------- #
# mid-queue snapshots
# --------------------------------------------------------------------------- #
def _midqueue(a, b, reqs, k=6):
    for i, r in enumerate(reqs[:k]):
        a.enqueue(r, tag=i)
        b.enqueue(r, tag=i)
        if a.pending > a.queue_depth:
            a.serve_next()
            b.serve_next()
    assert b._queue and any(e.stage >= 1 for e in b._queue), "not mid-queue"
    assert len({e.stage for e in b._queue}) >= 2  # entries at two stages at least


def _tails(a, c, reqs, k=6):
    tail_a, tail_c = [], []
    for r in reqs[k:]:
        a.enqueue(r)
        c.enqueue(r)
        tail_a.append(a.serve_next())
        tail_c.append(c.serve_next())
    while a.pending:
        tail_a.append(a.serve_next())
        tail_c.append(c.serve_next())
    assert len(tail_a) == len(tail_c) >= 8
    return tail_a, tail_c


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_serving_midqueue_checkpoint_parity(tmp_path, precision):
    """Checkpoint a server with requests queued at every pipeline stage,
    through the port's CheckpointManager; restore into a fresh server;
    every later bag and StepStats equal to the uninterrupted server's, the
    queued tags carried."""
    reqs = _requests()
    mk = lambda: _server(table_group=_group("port", precision))  # noqa: E731
    a, b = mk(), mk()
    _midqueue(a, b, reqs)
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(0, {}, host_arrays=b.state_arrays(), blocking=True)
    assert "queue" in cm.manifest()["host"]

    c = mk()
    c.load_state_arrays({n: cm.restore_host(n) for n in cm.manifest()["host"]})
    assert [e.tag for e in c._queue] == [e.tag for e in b._queue]
    assert [e.stage for e in c._queue] == [e.stage for e in b._queue]
    tail_a, tail_c = _tails(a, c, reqs)
    for (x, sx, tx), (y, sy, ty) in zip(tail_a, tail_c):
        np.testing.assert_array_equal(x, y)
        assert dataclasses.asdict(sx) == dataclasses.asdict(sy) and tx == ty
    assert c._step == a._step


def test_load_refuses_a_snapshot_of_another_shape():
    snap = _server().state_arrays()
    with pytest.raises(ValueError, match="does not fit"):
        _server(table_group=_group("port", "int8")).load_state_arrays(snap)
    small = TServer(THost(ROWS, DIM, seed=1), SLOTS // 2, window=2, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        small.load_state_arrays(snap)


# --------------------------------------------------------------------------- #
# carried across packages, both ways, mid-queue
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_reference_state_into_the_port(precision):
    reqs = _requests(seed=3)
    j_a = _server("ref", table_group=_group("ref", precision))
    j_b = _server("ref", table_group=_group("ref", precision))
    _midqueue(j_a, j_b, reqs)
    t = _server(table_group=_group("port", precision))
    convert.load_reference_server_state(t, j_b.state_arrays())
    assert t.host.data is not j_b.host.data
    tail_j, tail_t = _tails(j_a, t, reqs)
    _same([x[:2] for x in tail_t], [x[:2] for x in tail_j])


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_port_state_into_the_reference(precision):
    reqs = _requests(seed=4)
    t_a = _server(table_group=_group("port", precision))
    t_b = _server(table_group=_group("port", precision))
    _midqueue(t_a, t_b, reqs)
    arrays = convert.server_state_to_reference(t_b)
    assert arrays["host_table"] is not t_b.host.data
    j = _server("ref", table_group=_group("ref", precision))
    j.load_state_arrays(arrays)
    tail_t, tail_j = _tails(t_a, j, reqs)
    _same([x[:2] for x in tail_j], [x[:2] for x in tail_t])


# --------------------------------------------------------------------------- #
# warm start from a training checkpoint
# --------------------------------------------------------------------------- #
def _null_train_fn(storage, slots, batch):
    return storage, 0.0


def _train_some(pipe, steps=8, seed=0, tables=1):
    """A few cycles of (B, T, L) global-id batches, per-table ranges."""
    rng = np.random.default_rng(seed)
    per = ROWS // tables
    for _ in range(steps):
        ids = np.stack([rng.integers(t * per, (t + 1) * per, size=(2, 4))
                        for t in range(tables)], axis=1)
        pipe.run_one_cycle(ids, None)
    return pipe


@pytest.mark.parametrize("planner,precision", [
    ("host", "fp32"), ("device", "fp32"), ("host", "int8"), ("host", "fp16"),
    ("device", "int8"),
])
def test_warm_start_from_training_checkpoint(planner, precision):
    """A cold port replica preloads a port training runtime's resident set:
    every row lands, serving them is an immediate full hit whose fp32 bags
    equal the host rows' sums and nocache-serve's bitwise."""
    group = _group("port", precision)
    pipe = TPipe(THost(ROWS, DIM, seed=1), SLOTS, _null_train_fn, planner=planner,
                 table_group=group, device="cpu")
    _train_some(pipe, tables=2)
    pipe.flush_to_host()
    arrays = pipe.state_arrays()

    ids_r, rows_r, use_r = resident_set_from_state(arrays)
    assert ids_r.size > 0 and rows_r.shape == (ids_r.size, DIM)
    assert rows_r.dtype == np.float32 and use_r.dtype == np.int64

    srv = _server(table_group=group)
    n = srv.warm_start_from_arrays(arrays)
    assert n == ids_r.size
    slots = srv.planner.hitmap[ids_r]
    assert (slots >= 0).all() and srv._landed[slots].all()

    req = ids_r[: min(8, ids_r.size)].reshape(1, 1, -1)
    srv.enqueue(req)
    bags, st, _ = srv.serve_next()
    ref = srv.host.data[req.ravel()].reshape(1, 1, req.shape[-1], DIM).sum(axis=2)
    if precision == "fp32":
        np.testing.assert_array_equal(bags, ref)
        oracle = TNoCache(THost(ROWS, DIM, data=srv.host.data.copy()), device="cpu")
        oracle.enqueue(req)
        np.testing.assert_array_equal(bags, oracle.serve_next()[0])
    else:
        np.testing.assert_allclose(bags, ref, rtol=0.2, atol=0.5)
    assert st.n_hits == len(np.unique(req)) and st.n_miss == 0


@pytest.mark.parametrize("planner,precision", [
    ("host", "fp32"), ("device", "fp32"), ("host", "int8"), ("device", "fp16"),
])
def test_warm_start_from_a_reference_checkpoint(planner, precision):
    """Both packages' servers warm-started from one reference training
    checkpoint preload the same rows, then serve the same bags and
    StepStats; ``resident_set_from_state`` equals the reference's."""
    pipe = JPipe(JHost(ROWS, DIM, seed=1), SLOTS, _null_train_fn, planner=planner,
                 table_group=_group("ref", precision))
    _train_some(pipe, tables=2)
    pipe.flush_to_host()
    arrays = jax.tree.map(np.asarray, pipe.state_arrays())
    for a, b in zip(resident_set_from_state(arrays), j_resident_set(arrays)):
        np.testing.assert_array_equal(a, b)

    t = _server(table_group=_group("port", precision))
    j = _server("ref", table_group=_group("ref", precision))
    assert t.warm_start_from_arrays(dict(arrays)) == j.warm_start_from_arrays(dict(arrays))
    np.testing.assert_array_equal(t._landed, j._landed)
    reqs = _requests(10, seed=5)
    _same(_serve_all(t, reqs), _serve_all(j, reqs))


def test_warm_start_sharded_layout():
    """``shard{i}_`` checkpoints of the sharded runtime give GLOBAL ids with
    the right rows, capped at the server's slots."""
    host = THost(ROWS, DIM, seed=1)
    pipe = TSharded(host, 32, 2, lambda s, sl, b: (list(s), None), device="cpu")
    _train_some(pipe)
    pipe.flush_to_host()
    arrays = pipe.state_arrays()
    assert "shard1_host_table" in arrays

    ids_r, rows_r, _use = resident_set_from_state(arrays)
    assert ids_r.size > 0 and ids_r.max() >= ROWS // 2  # shard 1's rows, offset
    np.testing.assert_array_equal(rows_r, host.data[ids_r])
    srv = _server()
    assert srv.warm_start_from_arrays(arrays) == min(ids_r.size, SLOTS)
    np.testing.assert_array_equal(srv.host.data, host.data)


def test_warm_start_refuses_nonempty_server():
    pipe = TPipe(THost(ROWS, DIM, seed=1), SLOTS, _null_train_fn, device="cpu")
    _train_some(pipe)
    arrays = pipe.state_arrays()
    srv = _server()
    srv.enqueue(np.arange(4).reshape(1, 1, 4))
    with pytest.raises(RuntimeError, match="non-empty"):
        srv.warm_start_from_arrays(arrays)
    with pytest.raises(ValueError, match="host table"):
        TServer(THost(ROWS // 2, DIM, seed=1), SLOTS, device="cpu").warm_start_from_arrays(
            arrays)


# --------------------------------------------------------------------------- #
# fetch faults: retry, then the failsafe
# --------------------------------------------------------------------------- #
def test_serving_fetch_kill_retried():
    """One killed prefetch with fetch_retries=1: the retry lands the rows, no
    failsafe; bags equal the uninjected server's and the reference's."""
    reqs = _requests(10)
    clean = _serve_all(_server(metrics=True), reqs)
    srv = _server(metrics=True, fetch_retries=1)
    inj = ChaosInjector(ChaosPlan.parse("kill-fetch@2"), seed=0).attach_server(srv)
    got = _serve_all(srv, reqs)
    assert len(inj.fired) == 1
    assert _counter(srv, "fetch_failures") == 1 and _counter(srv, "failsafe") == 0
    _same(got, clean)

    j = _server("ref", metrics=True, fetch_retries=1)
    JInjector(JPlan.parse("kill-fetch@2"), seed=0).attach_server(j)
    _same(got, _serve_all(j, reqs))


def test_serving_fetch_exhaustion_falls_back_to_failsafe():
    """Retries exhausted: the entries are completed by the emergency path at
    serve time, never wrong; the StepStats are the reference's under the
    same faults."""
    reqs = _requests(10)
    clean = _serve_all(_server(metrics=True), reqs)
    srv = _server(metrics=True, fetch_retries=0)
    inj = ChaosInjector(ChaosPlan.parse("fail-fetch@2;fail-fetch@4"), seed=0)
    inj.attach_server(srv)
    got = _serve_all(srv, reqs)
    assert len(inj.fired) == 2
    assert _counter(srv, "fetch_failures") == 2 and _counter(srv, "failsafe") == 2
    for (x, _), (y, _) in zip(got, clean):
        np.testing.assert_array_equal(x, y)
    assert sum(st.aux["emergency"] for _, st in got) > sum(
        st.aux["emergency"] for _, st in clean)
    host = THost(ROWS, DIM, seed=1)
    for (x, _), r in zip(got, reqs):
        np.testing.assert_allclose(x, host.data[r.ravel()].reshape(r.shape + (DIM,)).sum(2),
                                   rtol=1e-5, atol=1e-5)

    j = _server("ref", metrics=True, fetch_retries=0)
    JInjector(JPlan.parse("fail-fetch@2;fail-fetch@4"), seed=0).attach_server(j)
    _same(got, _serve_all(j, reqs))


def test_corruption_rides_the_plan_clock():
    """corrupt-row on a server: the guard goes on at attach, the rows flip
    on the N-th plan call, and a guarded read raises."""
    from repro_torch.core.host_table import RowCorruptionError

    srv = _server()
    inj = ChaosInjector(ChaosPlan.parse("corrupt-row@2:3"), seed=0).attach_server(srv)
    with pytest.raises(RowCorruptionError):
        _serve_all(srv, _requests(6))
    assert len(inj.corrupted) == 3


def test_every_fill_on_the_serving_thread(monkeypatch):
    """With a warm start, a retried fetch and exhausted ones, every fill
    (insert, emergency, warm start) runs on the thread that drives the
    server: a thread of its own, then the front end's worker; the
    bags equal the clean run's."""
    reqs = [r[:1] for r in _requests(16, seed=6)]
    pipe = TPipe(THost(ROWS, DIM, seed=1), SLOTS, _null_train_fn, device="cpu")
    _train_some(pipe)
    pipe.flush_to_host()
    arrays = pipe.state_arrays()
    oracle = TNoCache(THost(ROWS, DIM, data=arrays["host_table"].copy()), device="cpu")
    clean = _serve_all(oracle, reqs)  # over the checkpoint's table, as served
    fills = []
    real = tsc.sp.fill

    def spy(storage, slots, rows):
        fills.append(threading.current_thread().name)
        return real(storage, slots, rows)

    monkeypatch.setattr(tsc.sp, "fill", spy)

    def drive(srv, out):
        srv.warm_start_from_arrays(arrays)
        ChaosInjector(ChaosPlan.parse("kill-fetch@1;fail-fetch@3;fail-fetch@4"),
                      seed=0).attach_server(srv)
        out.extend(_serve_all(srv, reqs))

    srv, got = _server(metrics=True, fetch_retries=1), []
    t = threading.Thread(target=drive, args=(srv, got), name="serving-loop")
    t.start()
    t.join()
    assert len(got) == len(reqs) and set(fills) == {"serving-loop"} and len(fills) > 3
    assert _counter(srv, "fetch_failures") == 3 and _counter(srv, "failsafe") == 1
    for (g, _), (c, _) in zip(got, clean):
        np.testing.assert_array_equal(g, c)

    fills.clear()
    srv = _server(metrics=True, fetch_retries=0)
    srv.warm_start_from_arrays(arrays)  # before the worker exists: the caller's
    ChaosInjector(ChaosPlan.parse("fail-fetch@1"), seed=0).attach_server(srv)
    with EmbeddingServer(srv, max_batch=1) as fe:
        futures = [fe.lookup(r[0]) for r in reqs]
        got = [f.result(timeout=60) for f in futures]
    assert fills[0] == threading.current_thread().name
    assert set(fills[1:]) == {"serving-frontend"}
    for g, (c, _) in zip(got, clean):
        np.testing.assert_array_equal(g, c[0])


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
SERVE_ARGV = ["--embedding", "--steps", "8", "--tables", "4", "--rows", "512", "--dim",
              "16", "--batch", "8", "--lookups", "4", "--depth", "2"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A supervised smoke training run's checkpoints (the port's)."""
    d = tmp_path_factory.mktemp("warm") / "ckpt"
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "8", "--device",
                     "cpu", "--supervise", "--ckpt-every", "4", "--ckpt-dir", str(d)])
    return str(d)


def _reference_launcher(argv, monkeypatch, capsys):
    from repro.launch import serve as jserve

    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return capsys.readouterr().out


def test_launcher_warm_start(ckpt_dir, capsys, monkeypatch):
    res = tserve.main(SERVE_ARGV + ["--device", "cpu", "--warm-start", ckpt_dir])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("warm start:"))
    n = int(line.split()[2])
    assert line == f"warm start: {n} rows preloaded from {ckpt_dir} (training step 8)"
    assert 0 < n <= res["backend"].num_slots
    ref_out = _reference_launcher(SERVE_ARGV + ["--warm-start", ckpt_dir], monkeypatch,
                                  capsys)
    for prefix in ("warm start:", "hit_rate="):
        mine = next(ln for ln in out.splitlines() if ln.startswith(prefix))
        theirs = next(ln for ln in ref_out.splitlines() if ln.startswith(prefix))
        assert mine == theirs


def test_launcher_warm_start_refusals(ckpt_dir, tmp_path):
    with pytest.raises(SystemExit, match="requires --design scratchpipe-serve"):
        tserve.main(SERVE_ARGV + ["--device", "cpu", "--design", "nocache-serve",
                                  "--warm-start", ckpt_dir])
    with pytest.raises(SystemExit, match="no checkpoints under"):
        tserve.main(SERVE_ARGV + ["--device", "cpu", "--warm-start",
                                  str(tmp_path / "empty")])
