"""The port's serving path (``device="cpu"``) against the JAX package's.

``nocache-serve`` and ``scratchpipe-serve`` of repro_torch serve the same
request streams as repro's, whose kernels run both as ``kernel="xla"`` and
as ``kernel="pallas"`` (interpret mode), at queue depths 0, 1 and 2. The
bags must be bitwise equal, and every StepStats field and every traffic
byte counter identical. Also: state carried across from a reference server
(``repro_torch.convert``), the fill kernel's unique-slot precondition on
real plans, and the launcher's output against the reference launcher's.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.serving_cache import NoCacheServer as JNoCache
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.core.table_group import TableGroup as JGroup
from repro.serving import replay_serving as j_replay
from repro.traces.scenarios import scenario_batches
from repro_torch import convert
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.runtime import available_runtimes, make_runtime
from repro_torch.core.serving_cache import NoCacheServer as TNoCache
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.kernels import ops as tops
from repro_torch.serving import replay_serving as t_replay

SEED = 7
DIM = 8
WINDOW = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batches_for(scenario: str, steps: int = 12):
    group = JGroup.uniform(2, 400, DIM)
    return [g for g, _ in scenario_batches(
        scenario, group, steps, batch_size=4, lookups_per_table=3, seed=SEED)]


def jax_server(design, kernel, num_slots):
    host = JHost(800, DIM, seed=SEED)
    if design == "nocache":
        return JNoCache(host, kernel=kernel)
    return JServer(host, num_slots, window=WINDOW, kernel=kernel,
                   table_group=JGroup.uniform(2, 400, DIM))


def port_server(design, num_slots):
    host = THost(800, DIM, seed=SEED)
    if design == "nocache":
        return TNoCache(host, device="cpu")
    return TServer(host, num_slots, window=WINDOW, device="cpu",
                   table_group=TGroup.uniform(2, 400, DIM))


def assert_same_run(t_res, j_res, t_srv, j_srv):
    assert len(t_res["bags"]) == len(j_res["bags"])
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


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("depth", [0, 1, WINDOW])
@pytest.mark.parametrize("design,num_slots,scenario", [
    ("nocache", None, "inference_mix"),
    ("scratchpipe", 128, "inference_mix"),
    ("scratchpipe", 56, "flash_crowd"),  # eviction pressure: re-plans
])
def test_serving_matches_reference(kernel, depth, design, num_slots, scenario):
    batches = batches_for(scenario)
    j_srv = jax_server(design, kernel, num_slots)
    t_srv = port_server(design, num_slots)
    j_res = j_replay(j_srv, batches, depth=depth, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=depth, collect_bags=True)
    assert_same_run(t_res, j_res, t_srv, j_srv)
    assert not any(tops.launch_counts().values()), tops.launch_counts()


@pytest.mark.parametrize("policy,pad_buckets,budgets", [
    ("lfu", None, None),
    ("lru", (16, 64), None),
    ("random", None, [40, 40]),
])
def test_server_options_match_reference(policy, pad_buckets, budgets):
    batches = batches_for("flash_crowd", 14)
    kw = dict(window=WINDOW, policy=policy, pad_buckets=pad_buckets,
              slot_budgets=budgets)
    j_srv = JServer(JHost(800, DIM, seed=SEED), 80, kernel="xla",
                    table_group=JGroup.uniform(2, 400, DIM), **kw)
    t_srv = TServer(THost(800, DIM, seed=SEED), 80, device="cpu",
                    table_group=TGroup.uniform(2, 400, DIM), **kw)
    j_res = j_replay(j_srv, batches, depth=1, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=1, collect_bags=True)
    assert_same_run(t_res, j_res, t_srv, j_srv)


def test_hit_rate_saturates_at_window_depth():
    batches = batches_for("drift", 24)
    rates = {}
    for depth in (0, WINDOW):
        res = t_replay(port_server("scratchpipe", 256), batches, depth=depth)
        rates[depth] = res["hit_rate"]
    assert rates[WINDOW] == 1.0 and rates[0] < 1.0


def test_fills_have_unique_valid_slots(monkeypatch):
    """The CUDA fill kernel's precondition, held on real plans under
    eviction pressure and emergency re-plans: within one fill call the
    valid (non-sentinel) slots are unique."""
    calls = []
    real_fill = tops.fill

    def spy(storage, fill_slots, rows):
        s = fill_slots.numpy()
        valid = s[s < storage.shape[0]]
        calls.append(valid.size)
        assert np.unique(valid).size == valid.size
        return real_fill(storage, fill_slots, rows)

    monkeypatch.setattr(tops, "fill", spy)
    t_replay(port_server("scratchpipe", 56), batches_for("flash_crowd", 20),
             depth=1)
    assert len(calls) > 5 and sum(calls) > 0


def test_registry_and_read_only_factories():
    assert {"nocache-serve", "scratchpipe-serve"} <= set(available_runtimes())
    host = THost(800, DIM, seed=SEED)
    with pytest.raises(TypeError, match="read-only"):
        make_runtime("scratchpipe-serve", host, lambda *a: None, num_slots=64,
                     device="cpu")
    srv = make_runtime("scratchpipe-serve", host, None, num_slots=128,
                       window=WINDOW, table_group=TGroup.uniform(2, 400, DIM),
                       device="cpu")
    assert isinstance(srv, TServer) and srv.storage.device.type == "cpu"
    srv.flush_to_host()
    assert set(srv.traffic()) == {"host", "pcie", "hbm"} and srv.stats == []
    int8 = TServer(host, 128, device="cpu",
                   table_group=TGroup.uniform(2, 400, DIM, precision="int8"))
    assert int8.precision == "int8" and int8.num_slots == 4 * 128


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_carry_reference_state_across(kernel):
    """Serve k micro-batches on the JAX server, carry its state into the
    port, then continue both on the same requests: identical bags and
    stats."""
    batches = batches_for("inference_mix", 14)
    k = 6
    j_srv = jax_server("scratchpipe", kernel, 96)
    j_replay(j_srv, batches[:k], depth=WINDOW)
    arrays = j_srv.state_arrays()
    assert "queue" not in arrays

    t_srv = TServer(convert.host_table_from_reference(arrays["host_table"]), 96,
                    window=WINDOW, device="cpu",
                    table_group=TGroup.uniform(2, 400, DIM))
    assert t_srv.host.data is not arrays["host_table"]
    convert.load_reference_server_state(t_srv, arrays)
    j_res = j_replay(j_srv, batches[k:], depth=WINDOW, collect_bags=True)
    t_res = t_replay(t_srv, batches[k:], depth=WINDOW, collect_bags=True)
    for i, (a, b) in enumerate(zip(t_res["bags"], j_res["bags"])):
        np.testing.assert_array_equal(a, b, err_msg=f"serve {k + i}")
    for a, b in zip(t_res["stats"], j_res["stats"]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_res["hit_rate"] == j_res["hit_rate"] == 1.0


def test_carry_across_refuses_a_busy_snapshot():
    batches = batches_for("inference_mix", 4)
    j_srv = jax_server("scratchpipe", "xla", 96)
    j_srv.enqueue(batches[0])
    t_srv = port_server("scratchpipe", 96)
    with pytest.raises(ValueError, match="queued"):
        convert.load_reference_server_state(t_srv, j_srv.state_arrays())


def _launch(module, extra):
    cmd = [sys.executable, "-m", module, "--embedding", "--steps", "10",
           "--tables", "2", "--rows", "600", "--dim", "8", "--batch", "4",
           "--lookups", "3", "--depth", "1", "--scenario", "drift", *extra]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def test_launcher_prints_reference_hit_rate_line():
    port = _launch("repro_torch.launch.serve", ["--device", "cpu"])
    ref = _launch("repro.launch.serve", [])
    pick = lambda lines, p: [ln for ln in lines if ln.startswith(p)]  # noqa: E731
    assert pick(port, "hit_rate=") == pick(ref, "hit_rate=")
    assert len(pick(port, "hit_rate=")) == 1
    assert pick(port, "serving ") == pick(ref, "serving ")
    assert pick(port, "served 10 micro-batches")
