"""Reduced-precision and static serving of the port (``device="cpu"``)
against the JAX package's.

  * ``scratchpipe-serve`` with fp16 and int8 replicas against the
    reference's ``ReadOnlyCacheServer(precision=, kernel="xla")`` at queue
    depths 0, 1 and 2, with room to spare and under eviction pressure: bags
    bitwise equal (the int8 products are exact — ``core/quantize.py`` keeps
    16 mantissa bits in the scale — and bags sum sequentially), every
    StepStats field and every traffic counter identical;
  * the card's oracle, on the CPU: the fp16/int8 server's fp32 bags equal
    ``nocache-serve``'s over a host table whose rows were quantized and
    dequantized the same way, bit for bit;
  * ``static-serve`` against the reference's ``StaticCacheServer``, bitwise,
    and against the port's own ``nocache-serve`` oracle;
  * the serving cases of tests/test_serving.py (eviction pressure, the
    hit-rate curve, no write-back), on recorded serving traces;
  * the launcher's ``--trace`` and ``--design static-serve`` print the
    reference launcher's lines.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import pytest

from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.core.serving_cache import StaticCacheServer as JStatic
from repro.core.table_group import TableGroup as JGroup
from repro.serving import replay_serving as j_replay
from repro.traces import scenarios as jsc
from repro_torch.core import quantize as tqz
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.runtime import available_runtimes, make_runtime
from repro_torch.core.serving_cache import NoCacheServer as TNoCache
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.core.serving_cache import StaticCacheServer as TStatic
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tlaunch
from repro_torch.serving import replay_serving as t_replay
from repro_torch.traces import format as tformat
from repro_torch.traces import recorder as trec
from repro_torch.traces import scenarios as tsc

SEED = 7
DIM = 16
WINDOW = 2
#: nominal fp32-row budgets: room to spare, and eviction pressure (each
#: precision's smallest budget the depth-2 window still fits)
ROOMY = 128
TIGHT = {"fp16": 32, "int8": 18}


def batches_for(scenario: str, steps: int = 14):
    group = JGroup.uniform(2, 400, DIM)
    return [g for g, _ in jsc.scenario_batches(
        scenario, group, steps, batch_size=4, lookups_per_table=3, seed=SEED)]


def assert_same_run(t_res, j_res, t_srv, j_srv):
    assert len(t_res["bags"]) == len(j_res["bags"]) > 0
    for i, (a, b) in enumerate(zip(t_res["bags"], j_res["bags"])):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f"bags of serve {i}")
    for i, (a, b) in enumerate(zip(t_res["stats"], j_res["stats"])):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), f"stats of serve {i}"
    for k in ("hit_rate", "hit_lookup_rate", "emergency_rate", "served", "warmup"):
        assert t_res[k] == j_res[k], k
    tt, jt = t_srv.traffic(), j_srv.traffic()
    assert set(tt) == set(jt)
    for k in jt:
        assert (tt[k].read, tt[k].written) == (jt[k].read, jt[k].written), k


@pytest.mark.parametrize("depth", [0, 1, WINDOW])
@pytest.mark.parametrize("budget", ["roomy", "tight"])
@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_reduced_precision_serving_matches_reference(precision, budget, depth):
    num_slots = ROOMY if budget == "roomy" else TIGHT[precision]
    batches = batches_for("flash_crowd")
    j_srv = JServer(JHost(800, DIM, seed=SEED), num_slots, window=WINDOW, kernel="xla",
                    table_group=JGroup.uniform(2, 400, DIM, precision=precision))
    t_srv = TServer(THost(800, DIM, seed=SEED), num_slots, window=WINDOW, device="cpu",
                    table_group=TGroup.uniform(2, 400, DIM, precision=precision))
    assert t_srv.precision == j_srv.precision == precision
    assert t_srv.num_slots == j_srv.num_slots == num_slots * tqz.SLOT_MULTIPLIER[precision]
    j_res = j_replay(j_srv, batches, depth=depth, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=depth, collect_bags=True)
    assert_same_run(t_res, j_res, t_srv, j_srv)
    evicted = sum(s.n_evict for s in t_res["stats"])
    assert (evicted > 0) == (budget == "tight"), evicted
    assert not any(tops.launch_counts().values())


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_precision_argument_matches_reference(precision):
    """``precision=`` without a table group, and with pad buckets and the
    lfu policy: the same run as the reference's."""
    batches = batches_for("drift", 12)
    kw = dict(window=WINDOW, precision=precision, pad_buckets=(16, 64), policy="lfu")
    j_srv = JServer(JHost(800, DIM, seed=SEED), 40, kernel="xla", **kw)
    t_srv = TServer(THost(800, DIM, seed=SEED), 40, device="cpu", **kw)
    j_res = j_replay(j_srv, batches, depth=1, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=1, collect_bags=True)
    assert_same_run(t_res, j_res, t_srv, j_srv)


def test_precision_resolution_and_storage():
    host = THost(800, DIM, seed=SEED)
    fp32 = TServer(host, 64, device="cpu")
    assert fp32.precision == "fp32" and fp32.num_slots == fp32.nominal_slots == 64
    for precision, mult in (("fp16", 2), ("int8", 4)):
        group = TGroup.uniform(2, 400, DIM, precision=precision)
        srv = TServer(host, 64, device="cpu", table_group=group)
        assert (srv.precision, srv.num_slots, srv.nominal_slots) == (precision, 64 * mult, 64)
        assert srv._row_bytes == tqz.row_bytes(DIM, precision)
        if precision == "int8":
            assert isinstance(srv.storage, QuantStorage)
            assert tuple(srv.storage.data.shape) == (256, DIM)
            assert tuple(srv.storage.scale.shape) == (256, 1)
        else:
            assert srv.storage.dtype.itemsize == 2 and tuple(srv.storage.shape) == (128, DIM)
        # the same precision twice is fine; a conflict is not
        TServer(host, 64, device="cpu", table_group=group, precision=precision)
        with pytest.raises(ValueError, match="conflicts"):
            TServer(host, 64, device="cpu", table_group=group, precision="fp32")
    with pytest.raises(ValueError, match="precision"):
        TServer(host, 64, device="cpu", precision="int4")
    with pytest.raises(ValueError, match="exceed"):
        TServer(host, 16, device="cpu", slot_budgets=[40, 40],
                table_group=TGroup.uniform(2, 400, DIM, precision="int8"))


class DequantizedHost(THost):
    """The oracle's host table: each gathered row quantized to
    ``precision`` and dequantized back (per row, as the fill does)."""

    def __init__(self, base: THost, precision: str):
        super().__init__(base.rows, base.dim, data=base.data)
        self.precision = precision

    def gather(self, ids):
        rows = super().gather(ids)
        return tqz.dequantize_rows_np(tqz.quantize_rows_np(rows, self.precision),
                                      self.precision)


@pytest.mark.parametrize("depth", [0, WINDOW])
@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_bags_equal_the_dequantized_oracle(precision, depth):
    """The card's exact oracle, held on the CPU too: nocache-serve's fp32
    bags over quantized-then-dequantized host rows."""
    batches = batches_for("inference_mix", 12)
    host = THost(800, DIM, seed=SEED)
    srv = TServer(host, TIGHT[precision], window=WINDOW, device="cpu",
                  table_group=TGroup.uniform(2, 400, DIM, precision=precision))
    res = t_replay(srv, batches, depth=depth, collect_bags=True)
    oracle = t_replay(TNoCache(DequantizedHost(host, precision), device="cpu"), batches,
                      collect_bags=True)
    fp32 = t_replay(TNoCache(host, device="cpu"), batches, collect_bags=True)
    differs = 0
    for a, b, c in zip(res["bags"], oracle["bags"], fp32["bags"]):
        np.testing.assert_array_equal(a, b)
        differs += int((a != c).any())
    assert differs > 0  # the replica really is reduced precision
    assert (res["hit_rate"] == 1.0) == (depth == WINDOW)


# --------------------------------------------------------------------------- #
# static-serve
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("depth", [0, 1, WINDOW])
@pytest.mark.parametrize("scenario", ["drift", "flash_crowd"])
def test_static_serve_matches_reference(scenario, depth):
    batches = batches_for(scenario)
    hot = np.unique(np.concatenate([b.ravel() for b in batches[:5]]))[:80]
    j_srv = JStatic(JHost(800, DIM, seed=SEED), hot, queue_depth=depth, kernel="xla")
    t_srv = TStatic(THost(800, DIM, seed=SEED), hot, queue_depth=depth, device="cpu")
    j_res = j_replay(j_srv, batches, depth=depth, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=depth, collect_bags=True)
    assert_same_run(t_res, j_res, t_srv, j_srv)
    assert 0 < sum(s.n_miss for s in t_res["stats"]) < sum(s.n_unique for s in t_res["stats"])


def test_static_serve_registered_and_read_only():
    assert {"nocache-serve", "static-serve", "scratchpipe-serve"} <= set(available_runtimes())
    host = THost(800, DIM, seed=SEED)
    with pytest.raises(TypeError, match="read-only"):
        make_runtime("static-serve", host, lambda *a: None, hot_ids=[1], device="cpu")
    srv = make_runtime("static-serve", host, None, hot_ids=np.array([5, 3, 9]),
                       device="cpu")
    assert isinstance(srv, TStatic) and srv.hot_ids.tolist() == [3, 5, 9]
    assert srv.storage.device.type == "cpu" and tuple(srv.storage.shape) == (3, DIM)
    assert host.traffic.read == 0  # the preload is not steady-state traffic
    empty = TStatic(host, np.array([], dtype=np.int64), device="cpu")
    bags = t_replay(empty, batches_for("drift", 3), collect_bags=True)["bags"]
    want = t_replay(TNoCache(host, device="cpu"), batches_for("drift", 3),
                    collect_bags=True)["bags"]
    for a, b in zip(bags, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# tests/test_serving.py's cases on recorded serving traces, against the port
# --------------------------------------------------------------------------- #
def record(tmp_path, scenario: str, steps: int = 20, precision: str = "fp32"):
    group = TGroup.uniform(2, 400, DIM, precision=precision)
    stream = tsc.scenario_batches(scenario, group, steps, batch_size=4,
                                  lookups_per_table=3, seed=SEED)
    path = str(tmp_path / scenario)
    trec.record_serving_trace(path, group, stream, steps=steps)
    reader = tformat.TraceReader(path)
    return reader.group, [reader.batch(i)[0] for i in range(reader.num_batches)], path


def make_host():
    return THost(800, DIM, seed=SEED)


def serve_all(backend, batches, depth):
    res = t_replay(backend, batches, depth=depth, collect_bags=True)
    return res["bags"], res


@pytest.mark.parametrize("scenario", ["drift", "flash_crowd"])
def test_static_serve_parity_with_oracle(tmp_path, scenario):
    group, batches, _ = record(tmp_path, scenario)
    oracle, _ = serve_all(TNoCache(make_host(), device="cpu"), batches, 0)
    hot = np.sort(np.unique(np.concatenate([b.ravel() for b in batches[:5]]))[:80])
    bags, _ = serve_all(TStatic(make_host(), hot, device="cpu"), batches, 0)
    for i, (a, b) in enumerate(zip(bags, oracle)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_parity_under_eviction_pressure(tmp_path, precision):
    group, batches, _ = record(tmp_path, "flash_crowd", steps=30, precision=precision)
    assert group.uniform_precision() == precision
    floor = (WINDOW + 2) * 4 * 3  # rows: the same at every precision
    nominal = 2 * floor // tqz.SLOT_MULTIPLIER[precision]
    srv = TServer(make_host(), nominal, window=WINDOW, table_group=group, device="cpu")
    host = make_host() if precision == "fp32" else DequantizedHost(make_host(), precision)
    oracle, _ = serve_all(TNoCache(host, device="cpu"), batches, 0)
    bags, res = serve_all(srv, batches, 1)
    for i, (a, b) in enumerate(zip(bags, oracle)):
        np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")
    assert sum(s.n_evict for s in res["stats"]) > 0


def test_hit_rate_saturates_at_window_depth(tmp_path):
    group, batches, _ = record(tmp_path, "drift", steps=24, precision="int8")
    rates = {}
    for depth in (0, WINDOW, WINDOW + 2):
        srv = TServer(make_host(), 64, window=WINDOW, table_group=group, device="cpu")
        _, res = serve_all(srv, batches, depth)
        rates[depth] = res["hit_rate"]
        assert res["served"] == len(batches)
    assert rates[WINDOW] == rates[WINDOW + 2] == 1.0 and rates[0] < 1.0


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_serving_never_writes_back(tmp_path, precision):
    group, batches, _ = record(tmp_path, "drift", steps=10, precision=precision)
    host = make_host()
    before = host.data.copy()
    srv = TServer(host, 64, window=WINDOW, table_group=group, device="cpu")
    serve_all(srv, batches, WINDOW)
    srv.flush_to_host()
    np.testing.assert_array_equal(host.data, before)
    assert host.traffic.written == 0


# --------------------------------------------------------------------------- #
# the launcher: --trace and --design static-serve
# --------------------------------------------------------------------------- #
def _reference_lines(monkeypatch, capsys, argv):
    from repro.launch import serve as jlaunch

    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jlaunch.main()
    return capsys.readouterr().out.splitlines()


def _pick(lines):
    keep = ("serving ", "hit_rate=")
    return [ln for ln in lines if ln.startswith(keep)]


@pytest.mark.parametrize("design,precision,depth", [
    ("scratchpipe-serve", "fp32", 2),
    ("scratchpipe-serve", "fp16", 0),
    ("scratchpipe-serve", "int8", 1),
    ("static-serve", "int8", 0),
    ("nocache-serve", "fp32", 2),
])
def test_launcher_trace_prints_reference_lines(tmp_path, monkeypatch, capsys, design,
                                               precision, depth):
    _, _, path = record(tmp_path, "flash_crowd", steps=12, precision=precision)
    argv = ["--embedding", "--trace", path, "--design", design, "--depth", str(depth),
            "--steps", "10", "--batch", "4", "--lookups", "3", "--cache-frac", "0.05"]
    ref = _reference_lines(monkeypatch, capsys, argv)
    res = tlaunch.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out.splitlines()
    assert _pick(port) == _pick(ref) and len(_pick(port)) == 2
    assert _pick(port)[0] == (f"serving trace {path} (10 batches) through {design} at "
                              f"queue depth {depth}")
    assert any(ln.startswith("served 10 micro-batches") for ln in port)
    backend = res["backend"]
    if design == "scratchpipe-serve":
        assert backend.precision == precision
    assert res["served"] == 10


def test_launcher_reuses_a_given_host_table(tmp_path):
    group, batches, path = record(tmp_path, "drift", steps=6, precision="fp16")
    args = tlaunch.build_parser().parse_args(
        ["--embedding", "--trace", path, "--device", "cpu", "--batch", "4",
         "--lookups", "3"])
    host = make_host()
    res = tlaunch.run_embedding(args, collect_bags=True, host=host)
    assert res["backend"].host is host and res["backend"].precision == "fp16"
    oracle = t_replay(TNoCache(DequantizedHost(host, "fp16"), device="cpu"), batches,
                      collect_bags=True)
    for a, b in zip(res["bags"], oracle["bags"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="host table"):
        tlaunch.run_embedding(args, host=THost(10, DIM, seed=0))
