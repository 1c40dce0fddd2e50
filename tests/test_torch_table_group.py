"""The port's multi-table training (``ScratchPipe(table_group=,
slot_budgets=, pad_buckets=)``, ``launch/train.py --tables/--adaptive-pad``)
on the CPU, against the JAX package's.

Inputs are made from numpy seeds and handed to both packages:

  * ``hetero_rows``, ``multi_table_config``, ``multi_table_smoke_config``
    and the batches of ``dlrm_batches_group`` are IDENTICAL to the
    reference's;
  * E1 of tests/test_table_group.py: a 1-table group is bitwise equal to no
    group (StepStats, storage, planner state, flushed table), and both equal
    the reference's run;
  * E2: an N-table run with per-table budgets equals N independent runs on
    the per-table streams (host regions, storage regions, per-table hits and
    misses), and equals the reference's N-table run: StepStats, ``by_table``,
    storage and table identical (the [Train] is an exact integer count);
  * E4: the heterogeneous DLRM on ``scratchpipe``, ``strawman``, ``nocache``
    and ``static``: StepStats, ``by_table`` and every traffic byte counter
    IDENTICAL to the reference's, losses within rtol 1e-5 and the flushed
    table within atol 1e-6 from the reference's MLP init; within the port,
    every planner x executor combination (split and fused) bitwise equal to
    host/sync; the registry and its ``TypeError``s;
  * the ``table_group`` cells of tests/test_device_planner.py on recorded
    drift and flash_crowd traces: host and device planner equal to the
    reference's host planner run;
  * ``pad_buckets``: a trace-derived set (``derive_pad_buckets``) changes no
    result, with either planner, split and fused;
  * a mixed-precision group is refused by the single-storage runtimes with
    the reference's words; an explicit ``precision=`` must agree with the
    group's;
  * the launcher: ``--smoke --tables 4`` prints the reference's
    ``runtime=``/``done:``/``traffic:`` figures with its StepStats and
    traffic; a heterogeneous trace replays bitwise equal to the generator's
    run; ``--adaptive-pad`` prints the reference's bucket set and trains
    bitwise equal to the run without it; without ``--trace`` it gives the
    reference's error.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_scratchpipe as jcfgs
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.pipeline import ScratchPipe as JScratchPipe
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.table_group import TableGroup as JGroup
from repro.core.table_group import TableSpec as JSpec
from repro.core.table_group import single_table as j_single_table
from repro.data import lookahead as jla
from repro.data import synthetic as jsyn
from repro.traces import derive_pad_buckets as j_derive_pad_buckets
from repro_torch import convert
from repro_torch.configs import dlrm_scratchpipe as tcfgs
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TScratchPipe
from repro_torch.core.runtime import available_runtimes
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.core.table_group import TableSpec as TSpec
from repro_torch.core.table_group import single_table
from repro_torch.data import lookahead as tla
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.traces import (
    TraceReplayStream,
    derive_pad_buckets,
    record_trace,
    scenario_batches,
)

LOSS_RTOL = 1e-5
TABLE_ATOL = 1e-6
#: (planner, executor) besides host/sync
OPTIONS = [("device", "sync"), ("host", "overlapped"), ("device", "overlapped")]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _plain_stats(stats):
    """StepStats minus aux, ``by_table`` as plain ints (the planners keep
    numpy arrays there)."""
    out = []
    for s in stats:
        d = {k: v for k, v in dataclasses.asdict(s).items()
             if k not in ("aux", "stage_times", "by_table")}
        if s.by_table is not None:
            d["by_table"] = {k: np.asarray(v).tolist() for k, v in s.by_table.items()}
        out.append(d)
    return out


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats])


def _mlps_np(mlps):
    return jax.tree.map(lambda a: np.array(a, copy=True), mlps)


def _group(pkg, specs):
    Group, Spec = (JGroup, JSpec) if pkg == "ref" else (TGroup, TSpec)
    return Group([Spec(*s) for s in specs])


GROUP4 = [("users", 90, 4, 0.2), ("items", 60, 4, 0.3), ("cats", 25, 4, 0.5),
          ("geo", 40, 4, 0.25)]


class TCounting:
    """[Train]: +1 to every unique touched slot, in place (exact integers)."""

    def train_fn(self, storage, slots, batch):
        u = torch.unique(torch.as_tensor(slots).reshape(-1).long())
        storage[u] += 1.0
        return storage, {}


class JCounting:
    """The reference's counting [Train] (tests/test_table_group.py)."""

    def train_fn(self, storage, slots, batch):
        uniq = jnp.unique(jnp.asarray(slots).ravel(), size=max(slots.size, 1),
                          fill_value=-1)
        ok = uniq >= 0
        add = jnp.zeros_like(storage).at[jnp.where(ok, uniq, 0)].add(
            jnp.where(ok, 1.0, 0.0)[:, None])
        return storage + add, {}


def _count_run(pkg, host_rows, dim, slots, batches, **kw):
    """A counting-[Train] ScratchPipe over ``batches`` from a zeroed table.
    Returns (stats, storage, flushed table, planner slot_to_id)."""
    if pkg == "ref":
        host = JHost(host_rows, dim, seed=1)
        host.data[:] = 0.0
        pipe = JScratchPipe(host, slots, JCounting().train_fn, **kw)
        la = jla
    else:
        host = THost(host_rows, dim, seed=1)
        host.data[:] = 0.0
        pipe = TScratchPipe(host, slots, TCounting().train_fn, device="cpu", **kw)
        la = tla
    stream = la.LookaheadStream(iter([(b, {}) for b in batches]))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    storage = np.array(pipe.storage, copy=True)
    slot_to_id = np.array(pipe.planner.slot_to_id, copy=True)
    pipe.flush_to_host()
    if hasattr(pipe, "close"):
        pipe.close()
    return stats, storage, host.data.copy(), slot_to_id


# ---------------------------------------------------------------------------
# configs and batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("multi_table_config", ()), ("multi_table_config", (8, 1_000_000)),
    ("multi_table_config", (5,)), ("multi_table_smoke_config", ()),
    ("multi_table_smoke_config", (6,)),
])
def test_multi_table_configs_match_reference(name, args):
    port = dataclasses.asdict(getattr(tcfgs, name)(*args))
    ref = dataclasses.asdict(getattr(jcfgs, name)(*args))
    ref.pop("kernel")  # the reference's xla/pallas axis
    assert port == ref
    assert tcfgs.hetero_rows(9, 300) == jcfgs.hetero_rows(9, 300)
    assert TGroup.from_config(getattr(tcfgs, name)(*args)).rows == JGroup.from_config(
        getattr(jcfgs, name)(*args)).rows


@pytest.mark.parametrize("locality", ["random", "medium", "high"])
@pytest.mark.parametrize("seed", [0, 7])
def test_dlrm_batches_group_identical(locality, seed):
    kw = dict(batch_size=8, lookups_per_table=3, locality=locality,
              num_dense_features=5, seed=seed)
    port = list(tsyn.dlrm_batches_group(_group("port", GROUP4), 4, **kw))
    ref = list(jsyn.dlrm_batches_group(_group("ref", GROUP4), 4, **kw))
    assert len(port) == len(ref) == 4
    for (pi, pb), (ri, rb) in zip(port, ref):
        assert pi.shape == (8, 4, 3) and pi.dtype == ri.dtype
        np.testing.assert_array_equal(pi, ri)
        for k in ("dense", "label", "sparse_ids"):
            assert pb[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(pb[k], rb[k])


# ---------------------------------------------------------------------------
# E1: a one-table group is the ungrouped runtime
# ---------------------------------------------------------------------------
def test_single_table_group_bitwise_equal_to_ungrouped():
    rows, slots, steps = 120, 64, 30
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, rows, size=9) for _ in range(steps)]
    a = _count_run("port", rows, 4, slots, batches)
    b = _count_run("port", rows, 4, slots, batches, table_group=single_table(rows, 4))
    j = _count_run("ref", rows, 4, slots, batches, table_group=j_single_table(rows, 4))
    assert len(a[0]) == steps and sum(s.n_evict for s in a[0]) > 0
    for got in (b, j):
        assert _plain_stats(got[0]) == _plain_stats(a[0])
        for x, y in zip(got[1:], a[1:]):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# E2: N tables with per-table budgets == N independent runs == the reference
# ---------------------------------------------------------------------------
def _e2_streams(steps=40):
    g = _group("port", GROUP4)
    rng = np.random.default_rng(11)
    sizes = (5, 4, 2, 3)
    per_table = [[rng.integers(0, g.tables[t].rows, size=sizes[t]) for _ in range(steps)]
                 for t in range(4)]
    fused = [np.concatenate([g.to_global(t, per_table[t][s]) for t in range(4)])
             for s in range(steps)]
    budgets = [min(g.tables[t].rows,
                   max(6 * max(np.unique(b).size for b in per_table[t]) + 4, 8))
               for t in range(4)]
    return g, per_table, fused, budgets


def test_multi_table_run_matches_independent_runs_and_reference():
    g, per_table, fused, budgets = _e2_streams()
    stats, storage, table, _ = _count_run("port", g.total_rows, g.dim, sum(budgets), fused,
                                          table_group=g, slot_budgets=budgets)
    lo = 0
    for t in range(4):
        st_t, stor_t, tab_t, _ = _count_run("port", g.tables[t].rows, g.dim, budgets[t],
                                            per_table[t])
        np.testing.assert_array_equal(table[g.row_slice(t)], tab_t)
        np.testing.assert_array_equal(storage[lo:lo + budgets[t]], stor_t)
        for s, st in enumerate(stats):
            assert int(st.by_table["hits"][t]) == st_t[s].n_hits, (t, s)
            assert int(st.by_table["misses"][t]) == st_t[s].n_miss, (t, s)
        lo += budgets[t]
    for st in stats:
        assert st.n_unique == sum(map(int, st.by_table["hits"])) + sum(
            map(int, st.by_table["misses"]))
    assert sum(s.n_evict for s in stats) > 0
    j = _count_run("ref", g.total_rows, g.dim, sum(budgets), fused,
                   table_group=_group("ref", GROUP4), slot_budgets=budgets)
    assert _plain_stats(stats) == _plain_stats(j[0])
    np.testing.assert_array_equal(storage, j[1])
    np.testing.assert_array_equal(table, j[2])


@pytest.mark.parametrize("planner,executor", OPTIONS)
def test_multi_table_counting_run_equal_across_planners_and_executors(planner, executor):
    """Within the port: the device planner (``(B, T, L)`` ids) and the
    overlapped executor give the host/sync run's stats, storage and table."""
    g = _group("port", [("a", 400, 4), ("b", 150, 4), ("c", 60, 4)])
    batches = list(tsyn.dlrm_batches_group(g, 24, batch_size=4, lookups_per_table=3,
                                           seed=2))
    ids = [b for b, _ in batches]
    budgets = [72, 72, 60]  # the §VI-D floor: 6 batches x 12 lookups per table
    base = _count_run("port", g.total_rows, g.dim, 204, ids, table_group=g,
                      slot_budgets=budgets)
    got = _count_run("port", g.total_rows, g.dim, 204, ids, table_group=g,
                     slot_budgets=budgets, planner=planner, executor=executor)
    assert sum(s.n_evict for s in base[0]) > 0
    assert _plain_stats(got[0]) == _plain_stats(base[0])
    for x, y in zip(got[1:], base[1:]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# E4: the heterogeneous DLRM on every runtime, against the reference
# ---------------------------------------------------------------------------
def _e4_run(pkg, design, mlps=None, fused=False, planner="host", executor="sync",
            pad_buckets=None):
    """24 steps of ``multi_table_smoke_config(4)`` (batch 8) on ``design``:
    (stats, traffic, flushed table, the MLP init)."""
    ref = pkg == "ref"
    cfg = (jcfgs if ref else tcfgs).multi_table_smoke_config(4)
    g = (JGroup if ref else TGroup).from_config(cfg)
    syn = jsyn if ref else tsyn
    host = (JHost if ref else THost)(g.total_rows, cfg.embed_dim, seed=1)
    if ref:
        trainer = JTrainer(cfg, jax.random.key(0), lr=0.05)
        mlps = _mlps_np(trainer.mlps)
        make, la, kw = j_make_runtime, jla, {}
    else:
        trainer = TTrainer(cfg, seed=0, lr=0.05, device="cpu")
        trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
        make, la, kw = t_make_runtime, tla, {"device": "cpu"}
    if design in ("scratchpipe", "strawman"):
        # §VI-D: every table's budget is its 6-batch window (<= 192 ids), so
        # the larger tables evict
        kw.update(num_slots=768, table_group=g, slot_budgets=[192] * 4,
                  planner=planner, executor=executor)
        if pad_buckets is not None:
            kw["pad_buckets"] = pad_buckets
        if fused:
            kw["fused_train_fn"] = trainer.fused_train_fn
    elif design == "static":
        kw["hot_ids"] = syn.hot_ids_for_group(g, 0.25, locality="medium")
    pipe = make(design, host, trainer.train_fn, **kw)
    stream = la.LookaheadStream(syn.dlrm_batches_group(
        g, 24, batch_size=8, lookups_per_table=cfg.lookups_per_table, locality="medium",
        seed=7))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    traffic = {k: dataclasses.asdict(v) for k, v in pipe.traffic().items()}
    if hasattr(pipe, "close"):
        pipe.close()
    return stats, traffic, host.data.copy(), mlps


@pytest.mark.parametrize("design", ["scratchpipe", "strawman", "nocache", "static"])
def test_multi_table_dlrm_matches_reference(design):
    j_stats, j_traffic, j_table, mlps = _e4_run("ref", design)
    t_stats, t_traffic, t_table, _ = _e4_run("port", design, mlps)
    assert len(t_stats) == 24 and np.isfinite(_losses(t_stats)).all()
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    if design in ("scratchpipe", "strawman"):
        assert all(s.by_table is not None for s in t_stats)
        assert sum(s.n_evict for s in t_stats) > 0
    assert t_traffic == j_traffic
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_table, j_table, rtol=0, atol=TABLE_ATOL)


@pytest.mark.parametrize("design,fused", [("scratchpipe", False), ("scratchpipe", True),
                                          ("strawman", False)])
def test_multi_table_dlrm_bitwise_equal_within_the_port(design, fused):
    mlps = _mlps_np(JTrainer(jcfgs.multi_table_smoke_config(4), jax.random.key(0),
                             lr=0.05).mlps)
    base = _e4_run("port", design, mlps)  # host/sync, split
    runs = [_e4_run("port", design, mlps, fused, p, e) for p, e in OPTIONS]
    if fused:
        runs.append(_e4_run("port", design, mlps, fused))
    for got in runs:
        assert _plain_stats(got[0]) == _plain_stats(base[0])
        assert got[1] == base[1]
        np.testing.assert_array_equal(_losses(got[0]), _losses(base[0]))
        np.testing.assert_array_equal(got[2], base[2])


def test_registry_covers_all_designs():
    names = available_runtimes()
    for want in ("nocache", "static", "scratchpipe", "strawman", "sharded"):
        assert want in names, names
    with pytest.raises(KeyError):
        t_make_runtime("bogus", None, None)
    # designs without a scratchpad reject (not ignore) slot kwargs
    with pytest.raises(TypeError):
        t_make_runtime("nocache", None, None, table_group=_group("port", GROUP4))
    with pytest.raises(TypeError):
        t_make_runtime("static", None, None, hot_ids=[0], slot_budgets=[4])
    with pytest.raises(TypeError, match="requires table_group"):
        t_make_runtime("sharded", THost(8, 4), None, num_slots=4, slot_budgets=[4],
                       device="cpu")


def test_group_checks_match_reference():
    """A group that does not cover the host table, budgets over the slots,
    a mixed-precision group and a conflicting ``precision=`` raise the
    reference's ValueErrors."""
    g = _group("port", GROUP4)
    noop = lambda s, slots, b: (s, {})  # noqa: E731
    host = THost(g.total_rows, 4, seed=0)
    with pytest.raises(ValueError, match="table_group covers"):
        TScratchPipe(THost(10, 4), 8, noop, table_group=g, device="cpu")
    with pytest.raises(ValueError, match="exceed num_slots"):
        TScratchPipe(host, 8, noop, table_group=g, slot_budgets=[4, 4, 4, 4],
                     device="cpu")
    mixed = TGroup([TSpec("a", 400, 4, precision="int8"),
                    TSpec("b", 200, 4, precision="fp16")])
    with pytest.raises(ValueError, match="mixed per-table precisions"):
        t_make_runtime("scratchpipe", THost(600, 4), noop, num_slots=240,
                       table_group=mixed, device="cpu")
    int8 = TGroup([TSpec("a", 400, 4, precision="int8"),
                   TSpec("b", 200, 4, precision="int8")])
    with pytest.raises(ValueError, match="conflicts"):
        t_make_runtime("scratchpipe", THost(600, 4), noop, num_slots=240,
                       table_group=int8, precision="fp16", device="cpu")
    # the group's precision is the runtime's, its budgets in int8 rows
    pipe = t_make_runtime("scratchpipe", THost(600, 4), noop, num_slots=60,
                          table_group=int8, device="cpu")
    assert pipe.precision == "int8" and pipe.num_slots == 240
    assert pipe.planner.slot_ranges == [(0, 160), (160, 240)]
    jpipe = j_make_runtime("scratchpipe", JHost(600, 4), noop, num_slots=60,
                           table_group=_group("ref", [("a", 400, 4, 0.05, "int8"),
                                                      ("b", 200, 4, 0.05, "int8")]))
    assert jpipe.planner.slot_ranges == pipe.planner.slot_ranges


# ---------------------------------------------------------------------------
# the table_group cells of tests/test_device_planner.py; pad_buckets
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["drift", "flash_crowd"])
def recorded_trace(request, tmp_path_factory):
    group = TGroup([TSpec("a", 400, 8), TSpec("b", 200, 8)])
    path = str(tmp_path_factory.mktemp("tg") / request.param)
    n = record_trace(path, group, scenario_batches(
        request.param, group, 30, batch_size=4, lookups_per_table=3, seed=11))
    assert n == 30
    return path, group


def _trace_run(pkg, path, group, **kw):
    """The reference tests' DLRM over a recorded trace (num_slots 240):
    (flushed table, storage, stats, traffic, losses)."""
    from repro.configs.base import DLRMConfig as JCfg
    from repro_torch.configs.base import DLRMConfig as TCfg

    ref = pkg == "ref"
    cfg = (JCfg if ref else TCfg)(
        name="dlrm-deviceplan", table_rows=tuple(group.rows), embed_dim=group.dim,
        lookups_per_table=3, batch_size=4, bottom_mlp=(16, group.dim), top_mlp=(16, 1))
    fused = kw.pop("fused", False)
    mlps = kw.pop("mlps", None)
    if ref:
        from repro.traces import TraceReplayStream as JReplay

        host = JHost(group.total_rows, group.dim, seed=1)
        trainer = JTrainer(cfg, jax.random.key(0), lr=0.05)
        mlps = _mlps_np(trainer.mlps)
        make, replay, tg = j_make_runtime, JReplay, JGroup(
            [JSpec(t.name, t.rows, t.dim) for t in group.tables])
    else:
        host = THost(group.total_rows, group.dim, seed=1)
        trainer = TTrainer(cfg, seed=0, lr=0.05, device="cpu")
        trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
        make, replay, tg = t_make_runtime, TraceReplayStream, group
        kw["device"] = "cpu"
    if kw.pop("grouped", False):
        kw["table_group"] = tg
    if fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    runtime = make("scratchpipe", host, trainer.train_fn, num_slots=240, **kw)
    with replay(path, prefetch=0) as stream:
        stats = runtime.run(stream, lookahead_fn=stream.peek_ids)
    runtime.flush_to_host()
    traffic = {k: (t.read, t.written) for k, t in runtime.traffic().items()}
    storage = np.array(runtime.storage, copy=True)
    if hasattr(runtime, "close"):
        runtime.close()
    return host.data.copy(), storage, stats, traffic, _losses(stats), mlps


def _assert_same(a, b, label, loss_rtol=None):
    """Bitwise equal (``loss_rtol=None``), or the port against the
    reference: stats and bytes identical, losses and table within the tiers."""
    assert _plain_stats(a[2]) == _plain_stats(b[2]), label
    assert a[3] == b[3], f"{label}: byte counters"
    if loss_rtol is None:
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"{label}: host table")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"{label}: storage")
        np.testing.assert_array_equal(a[4], b[4], err_msg=f"{label}: losses")
    else:
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=TABLE_ATOL,
                                   err_msg=f"{label}: host table")
        np.testing.assert_allclose(a[4], b[4], rtol=loss_rtol, err_msg=f"{label}: losses")


@pytest.mark.parametrize("planner", ["host", "device"])
def test_device_planner_multi_table_budgets_match_reference(recorded_trace, planner):
    path, group = recorded_trace
    j = _trace_run("ref", path, group, planner="host", grouped=True)
    t = _trace_run("port", path, group, planner=planner, grouped=True, mlps=j[5])
    _assert_same(t, j, f"multi-table {planner} vs the reference", loss_rtol=LOSS_RTOL)
    if planner == "device":
        h = _trace_run("port", path, group, planner="host", grouped=True, mlps=j[5])
        _assert_same(t, h, "multi-table device vs host")


@pytest.mark.parametrize("grouped", [False, True], ids=["one-range", "per-table"])
def test_pad_buckets_change_no_result(recorded_trace, grouped):
    """D5 of tests/test_device_planner.py: the derived bucket set equals
    the reference's, and a ``pad_buckets=`` run (host or device planner,
    split or fused under ``overlapped``) is bitwise equal to the pow-2 one."""
    path, group = recorded_trace
    buckets = derive_pad_buckets(path, 240)
    assert buckets == j_derive_pad_buckets(path, 240) and len(buckets) >= 1
    mlps = _trace_run("ref", path, group, planner="host")[5]
    base = _trace_run("port", path, group, planner="host", grouped=grouped, mlps=mlps)
    assert sum(s.n_evict for s in base[2]) > 0
    for kw in (dict(planner="host"), dict(planner="device"),
               dict(planner="device", executor="overlapped", fused=True)):
        got = _trace_run("port", path, group, grouped=grouped, mlps=mlps,
                         pad_buckets=buckets, **kw)
        _assert_same(got, base, f"pad_buckets {kw}")


def test_device_planner_pads_to_the_bucket_set():
    """The device planner's id operands take the smallest bucket that fits,
    and stay monotone (pow-2 past the largest bucket)."""
    from repro_torch.core.plan_device import DevicePlanner

    p = DevicePlanner(100, 40, device="cpu", pad_buckets=(24, 40))
    assert p._pad_to(10, "_ids_pad") == 24
    assert p._pad_to(30, "_ids_pad") == 40
    assert p._pad_to(12, "_ids_pad") == 40  # monotone
    assert p._pad_to(50, "_ids_pad") == 256  # beyond the set: pow-2, PAD_FLOOR


# ---------------------------------------------------------------------------
# the launcher: --tables, heterogeneous traces, --adaptive-pad
# ---------------------------------------------------------------------------
def _fields(lines):
    """(runtime line minus kernel=, plan_hit, traffic line)."""
    done = next(ln for ln in lines if ln.startswith("done: "))
    run = next(ln for ln in lines if ln.startswith("runtime="))
    return (" ".join(w for w in run.split() if not w.startswith("kernel=")),
            done.split("plan_hit=")[1].split()[0],
            next(ln for ln in lines if ln.startswith("traffic: ")))


def _reference_launch(monkeypatch, capsys, argv):
    """The reference launcher in-process: its printed lines, the runtime it
    built and its trainer's initial MLPs."""
    from repro.core import runtime as jruntime
    from repro.launch import train as jlaunch

    seen = {}
    real = jruntime.make_runtime

    def spy(name, host_table, train_fn, **kw):
        seen["mlps"] = _mlps_np(train_fn.__self__.mlps)
        seen["pipe"] = real(name, host_table, train_fn, **kw)
        return seen["pipe"]

    monkeypatch.setattr(jruntime, "make_runtime", spy)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "dlrm-scratchpipe", "--smoke",
                                      *argv])
    capsys.readouterr()
    jlaunch.main()
    monkeypatch.setattr(jruntime, "make_runtime", real)
    return capsys.readouterr().out.splitlines(), seen["pipe"], seen["mlps"]


def _port_launch(capsys, argv, mlps=None):
    args = tlaunch.build_parser().parse_args(
        ["--arch", "dlrm-scratchpipe", "--smoke", *argv, "--device", "cpu"])
    capsys.readouterr()
    res = tlaunch.train_dlrm(args, mlps=None if mlps is None
                             else convert.mlps_from_reference(mlps))
    if hasattr(res["pipe"], "close"):
        res["pipe"].close()
    return capsys.readouterr().out.splitlines(), res


@pytest.mark.parametrize("extra", [
    [], ["--fused", "--planner", "device", "--executor", "overlapped"],
    ["--runtime", "strawman"], ["--runtime", "nocache"], ["--runtime", "static"],
    ["--precision", "int8", "--rounding", "nearest"],
], ids=["scratchpipe", "device-overlapped-fused", "strawman", "nocache", "static",
        "int8-nearest"])
def test_launcher_tables_matches_reference(monkeypatch, capsys, extra):
    argv = ["--steps", "10", "--tables", "4", *extra]
    ref_lines, j_pipe, mlps = _reference_launch(monkeypatch, capsys, argv)
    port_lines, res = _port_launch(capsys, argv, mlps)
    assert _fields(port_lines) == _fields(ref_lines)
    assert "tables=4 rows=[1024, 512, 256, 128]" in _fields(port_lines)[0]
    assert _plain_stats(res["stats"]) == _plain_stats(j_pipe.stats)
    for tier, t in res["pipe"].traffic().items():
        assert dataclasses.asdict(t) == dataclasses.asdict(j_pipe.traffic()[tier]), tier
    rtol = 1e-4 if "int8" in extra else LOSS_RTOL
    np.testing.assert_allclose(res["losses"], _losses(j_pipe.stats), rtol=rtol)
    if extra in ([], ["--runtime", "strawman"]):
        pipe = res["pipe"]
        assert pipe.table_group is not None and pipe.planner.num_tables == 4


@pytest.fixture(scope="module")
def hetero_trace(tmp_path_factory):
    """12 steps of ``--smoke --tables 4`` recorded while training (the
    tables differ in rows), with that run's losses and flushed table."""
    path = str(tmp_path_factory.mktemp("hetero") / "t")
    args = tlaunch.build_parser().parse_args(
        ["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "12", "--tables", "4",
         "--device", "cpu", "--record-trace", path])
    res = tlaunch.train_dlrm(args)
    res["pipe"].flush_to_host()
    res["pipe"].close()
    return path, np.array(res["losses"]), res["host"].data.copy(), res["stats"]


@pytest.mark.parametrize("extra", [
    [], ["--adaptive-pad"],
    ["--fused", "--planner", "device", "--executor", "overlapped", "--adaptive-pad"],
], ids=["replay", "adaptive-pad", "device-overlapped-fused-adaptive-pad"])
def test_hetero_trace_replays_bitwise_equal_to_the_generator(hetero_trace, capsys, extra):
    path, losses, table, stats = hetero_trace
    lines, res = _port_launch(capsys, ["--steps", "12", "--trace", path, *extra])
    res["pipe"].flush_to_host()
    assert res["pipe"].table_group is not None
    assert (res["pipe"].pad_buckets is not None) == ("--adaptive-pad" in extra)
    assert len(res["losses"]) == 12 and np.isfinite(losses).all()
    np.testing.assert_array_equal(res["losses"], losses)
    np.testing.assert_array_equal(res["host"].data, table)
    assert _plain_stats(res["stats"]) == _plain_stats(stats)


def test_adaptive_pad_prints_the_reference_buckets(hetero_trace, monkeypatch, capsys):
    path = hetero_trace[0]
    argv = ["--steps", "12", "--trace", path, "--adaptive-pad"]
    ref_lines, j_pipe, mlps = _reference_launch(monkeypatch, capsys, argv)
    port_lines, res = _port_launch(capsys, argv, mlps)
    want = [ln for ln in ref_lines if ln.startswith("adaptive pad buckets: ")]
    assert len(want) == 1
    assert [ln for ln in port_lines if ln.startswith("adaptive pad buckets: ")] == want
    assert res["pipe"].pad_buckets == j_pipe.pad_buckets
    assert _fields(port_lines) == _fields(ref_lines)
    assert _plain_stats(res["stats"]) == _plain_stats(j_pipe.stats)
    np.testing.assert_allclose(res["losses"], _losses(j_pipe.stats), rtol=LOSS_RTOL)


def test_adaptive_pad_needs_a_trace(monkeypatch, capsys):
    from repro.launch import train as jlaunch

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "dlrm-scratchpipe", "--smoke",
                                      "--adaptive-pad"])
    with pytest.raises(SystemExit):
        jlaunch.main()
    want = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--device", "cpu",
                      "--adaptive-pad"])
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert "pass --trace" in want
    assert got.split("error: ")[1] == want.split("error: ")[1]
