"""The port's DLRM training path (``device="cpu"``) against the JAX package's.

At the smoke size (``smoke_config``: 4 tables x 512 rows, D=16, 4 lookups,
batch 32), with inputs made from numpy seeds:

  * configs, synthetic batches (ids, dense, label), hot-id profiles and the
    look-ahead stream are IDENTICAL to the reference's;
  * the DLRM MLP (``forward_from_bags``, ``bce_loss``), started from the
    reference's ``init_mlps`` through ``convert.mlps_from_reference``,
    agrees within rtol 1e-5 (torch's CPU matmuls are not XLA's: the sums
    are taken in another order); given identical bag gradients the storage
    update is BITWISE equal;
  * every runtime (``scratchpipe`` split and fused, ``strawman``,
    ``nocache``, ``static``) on the same batches: StepStats and every
    traffic byte counter IDENTICAL to the reference's; the 12-step loss
    trajectory within rtol 1e-5 and the flushed host table within atol
    1e-6 (the MLP differences above, carried through 12 SGD steps: 1.8e-7
    and 6e-8 measured) — also under eviction pressure, with a scratchpad
    smaller than the table; and within the port, all designs give
    BITWISE-equal losses and tables;
  * the hold-window properties P1-P4 of tests/test_scratchpipe_properties.py
    hold for the port's ScratchPipe;
  * the launcher prints the reference's ``done:``/``traffic:`` figures.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to deterministic fixed examples
    from _hypothesis_compat import given, settings, st

from repro.configs import dlrm_scratchpipe as jcfgs
from repro.core import scratchpad as jsp
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.dlrm_runtime import dlrm_train_step as j_train_step
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.table_group import TableGroup as JGroup
from repro.data import lookahead as jla
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro_torch import convert
from repro_torch.configs import dlrm_scratchpipe as tcfgs
from repro_torch.core import scratchpad as tsp
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.dlrm_runtime import dlrm_train_step as t_train_step
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TScratchPipe
from repro_torch.core.runtime import available_runtimes
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.data import lookahead as tla
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import dlrm as tdlrm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
LR = 0.05
STEPS = 12
LOSS_RTOL = 1e-5
TABLE_ATOL = 1e-6
MLP_RTOL = 1e-5


def _mlps_np(mlps):
    return jax.tree.map(lambda a: np.array(a, copy=True), mlps)


def _port_model(cfg, mlps_np):
    model = tdlrm.DLRM(cfg)
    model.load_state_dict(convert.mlps_from_reference(mlps_np))
    return model


# ---------------------------------------------------------------------------
# configs, data, look-ahead stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["config", "smoke_config"])
def test_configs_match_reference(name):
    port = dataclasses.asdict(getattr(tcfgs, name)())
    ref = dataclasses.asdict(getattr(jcfgs, name)())
    ref.pop("kernel")  # the reference's xla/pallas axis: the port dispatches by device
    assert port == ref
    assert tdlrm.interaction_dim(getattr(tcfgs, name)()) == jdlrm.interaction_dim(
        getattr(jcfgs, name)())


@pytest.mark.parametrize("locality", ["random", "medium", "high"])
@pytest.mark.parametrize("seed", [0, 5])
def test_dlrm_batches_identical(locality, seed):
    kw = dict(num_tables=3, rows_per_table=700, lookups_per_table=4,
              batch_size=16, locality=locality, seed=seed)
    port = list(tsyn.dlrm_batches(tsyn.TraceConfig(**kw), 5))
    ref = list(jsyn.dlrm_batches(jsyn.TraceConfig(**kw), 5))
    assert len(port) == len(ref) == 5
    for (pi, pb), (ri, rb) in zip(port, ref):
        np.testing.assert_array_equal(pi, ri)
        assert pi.dtype == ri.dtype
        for k in ("dense", "label", "sparse_ids"):
            np.testing.assert_array_equal(pb[k], rb[k])
            assert pb[k].dtype == rb[k].dtype


def test_hot_ids_and_access_counts_identical():
    tc = dict(num_tables=2, rows_per_table=300, lookups_per_table=3,
              batch_size=8, locality="high", seed=4)
    np.testing.assert_array_equal(
        tsyn.hot_ids_for_group(TGroup.uniform(3, 400, 8), 0.1, locality="medium"),
        jsyn.hot_ids_for_group(JGroup.uniform(3, 400, 8), 0.1, locality="medium"))
    np.testing.assert_array_equal(
        tsyn.access_counts(tsyn.TraceConfig(**tc), 4),
        jsyn.access_counts(jsyn.TraceConfig(**tc), 4))
    np.testing.assert_array_equal(
        tsyn.hot_ids_global(tsyn.TraceConfig(**tc), 0.05, steps=3),
        jsyn.hot_ids_global(jsyn.TraceConfig(**tc), 0.05, steps=3))


def test_lookahead_stream_matches_reference():
    items = [(np.array([i, i + 1]), {"k": i}) for i in range(5)]
    port, ref = tla.LookaheadStream(iter(items)), jla.LookaheadStream(iter(items))
    for s in (port, ref):
        s.trace = []
        s.trace.append([a.tolist() for a in s.peek_ids(2)])
        s.trace.append(next(s)[1])
        s.trace.append([a.tolist() for a in s.peek_ids(9)])
        s.trace.append((s.exhausted, s.consumed, s.state_dict()))
        s.trace.append([b for _, b in s])
        s.trace.append((s.exhausted, s.consumed))
    assert port.trace == ref.trace
    m_port = tla.make_stream(lambda: iter(items), skip=2)
    m_ref = jla.make_stream(lambda: iter(items), skip=2)
    assert next(m_port)[1] == next(m_ref)[1] and m_port.consumed == m_ref.consumed


# ---------------------------------------------------------------------------
# the DLRM MLP and the [Train] step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["smoke", "full_width"])
def test_forward_and_loss_match_reference(which):
    cfg_j = jcfgs.smoke_config() if which == "smoke" else jcfgs.config()
    cfg_t = tcfgs.smoke_config() if which == "smoke" else tcfgs.config()
    rng = np.random.default_rng(1)
    B = 8
    dense = rng.standard_normal((B, cfg_j.num_dense_features)).astype(np.float32)
    bags = (rng.standard_normal((B, cfg_j.num_tables, cfg_j.embed_dim)) * 0.3).astype(np.float32)
    label = (rng.random(B) < 0.5).astype(np.float32)
    mlps = _mlps_np(jdlrm.init_mlps(cfg_j, jax.random.key(3)))
    model = _port_model(cfg_t, mlps)
    want = np.array(jdlrm.forward_from_bags(mlps, jnp.asarray(dense), jnp.asarray(bags)))
    got = tdlrm.forward_from_bags(model, torch.from_numpy(dense), torch.from_numpy(bags))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=MLP_RTOL, atol=1e-6)
    want_loss = float(jdlrm.bce_loss(jnp.asarray(want), jnp.asarray(label)))
    got_loss = float(tdlrm.bce_loss(torch.from_numpy(want), torch.from_numpy(label)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=MLP_RTOL)


def test_init_follows_reference_distribution():
    cfg = tcfgs.config()
    model = tdlrm.DLRM(cfg, seed=0)
    for lin in list(model.bottom) + list(model.top):
        fan_in = lin.weight.shape[1]
        if lin.weight.numel() >= 4096:
            assert abs(lin.weight.std().item() / np.sqrt(2.0 / fan_in) - 1.0) < 0.05
        assert not lin.bias.any()
    a = [p.clone() for p in tdlrm.DLRM(cfg, seed=1).parameters()]
    b = list(tdlrm.DLRM(cfg, seed=1).parameters())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_mlps_from_reference_layout():
    cfg = jcfgs.smoke_config()
    mlps = _mlps_np(jdlrm.init_mlps(cfg, jax.random.key(0)))
    sd = convert.mlps_from_reference(mlps)
    assert set(sd) == set(tdlrm.DLRM(tcfgs.smoke_config()).state_dict())
    np.testing.assert_array_equal(sd["top.1.weight"].numpy(), mlps["top"][1]["w"].T)
    sd["bottom.0.bias"] += 1.0  # a copy, not a view of the reference's arrays
    assert not mlps["bottom"][0]["b"].any()


def test_storage_update_bitwise_given_bag_grads():
    rng = np.random.default_rng(2)
    N, D = 64, 16
    storage = rng.standard_normal((N, D)).astype(np.float32)
    slots = rng.integers(0, 20, (32, 4, 4)).astype(np.int32)
    g = (rng.standard_normal((32, 4, D)) * 1e-2).astype(np.float32)
    want = jsp.apply_grad(jnp.asarray(storage), jnp.asarray(slots), jnp.asarray(g), LR)
    got = tsp.apply_grad(torch.from_numpy(storage.copy()), torch.from_numpy(slots),
                         torch.from_numpy(g), LR)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_step_matches_reference():
    cfg_j, cfg_t = jcfgs.smoke_config(), tcfgs.smoke_config()
    rng = np.random.default_rng(4)
    N = 200
    storage = (rng.standard_normal((N, cfg_j.embed_dim)) * 0.25).astype(np.float32)
    slots = rng.integers(0, N, (32, cfg_j.num_tables, cfg_j.lookups_per_table)).astype(np.int32)
    dense = rng.standard_normal((32, 13)).astype(np.float32)
    label = (rng.random(32) < 0.5).astype(np.float32)
    mlps = _mlps_np(jdlrm.init_mlps(cfg_j, jax.random.key(1)))
    j_st, j_mlps, j_loss = j_train_step(jnp.asarray(storage), mlps, jnp.asarray(slots),
                                        jnp.asarray(dense), jnp.asarray(label), lr=LR)
    model = _port_model(cfg_t, mlps)
    t_st, t_loss = t_train_step(torch.from_numpy(storage.copy()), model,
                                torch.from_numpy(slots), torch.from_numpy(dense),
                                torch.from_numpy(label), LR)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=MLP_RTOL)
    np.testing.assert_allclose(t_st.numpy(), np.asarray(j_st), rtol=0, atol=TABLE_ATOL)
    sd = convert.mlps_from_reference(_mlps_np(j_mlps))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=MLP_RTOL, atol=1e-7,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the runtimes, end to end, against the reference
# ---------------------------------------------------------------------------
DESIGNS = [("scratchpipe", False), ("scratchpipe", True), ("strawman", False),
           ("strawman", True), ("nocache", False), ("static", False)]


def _runtime_kw(design, cfg, group):
    slots = max(2048, int(group.total_rows * cfg.cache_fraction))
    if design == "static":
        syn = jsyn if isinstance(group, JGroup) else tsyn
        return {"hot_ids": syn.hot_ids_for_group(group, cfg.cache_fraction)}
    if design == "nocache":
        return {}
    kw = {"num_slots": slots}
    if design == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    return kw


def _trace(cfg, syn):
    return syn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                           lookups_per_table=cfg.lookups_per_table,
                           batch_size=cfg.batch_size, seed=SEED)


@pytest.fixture(scope="module")
def reference_runs():
    """Each design once through the JAX package (kernel="xla"), plus the
    MLP init every run starts from."""
    cfg = jcfgs.smoke_config()
    out = {}
    for design, fused in DESIGNS:
        host = JHost(cfg.total_rows, cfg.embed_dim, seed=SEED)
        trainer = JTrainer(cfg, jax.random.key(SEED), lr=LR)
        out.setdefault("mlps", _mlps_np(trainer.mlps))
        kw = _runtime_kw(design, cfg, JGroup.from_config(cfg))
        if fused:
            kw["fused_train_fn"] = trainer.fused_train_fn
        pipe = j_make_runtime(design, host, trainer.train_fn, **kw)
        stream = jla.LookaheadStream(jsyn.dlrm_batches(_trace(cfg, jsyn), STEPS))
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        out[design, fused] = (stats, pipe.traffic(), host.data.copy())
    return out


def _port_run(design, fused, mlps):
    cfg = tcfgs.smoke_config()
    host = THost(cfg.total_rows, cfg.embed_dim, seed=SEED)
    trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
    trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
    kw = _runtime_kw(design, cfg, TGroup.from_config(cfg))
    if fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    pipe = t_make_runtime(design, host, trainer.train_fn, device="cpu", **kw)
    stream = tla.LookaheadStream(tsyn.dlrm_batches(_trace(cfg, tsyn), STEPS))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    return stats, pipe.traffic(), host.data.copy()


def _plain_stats(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in ("aux", "stage_times")}
            for s in stats]


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats])


@pytest.mark.parametrize("design,fused", DESIGNS)
def test_runtime_matches_reference(reference_runs, design, fused):
    j_stats, j_traffic, j_table = reference_runs[design, fused]
    t_stats, t_traffic, t_table = _port_run(design, fused, reference_runs["mlps"])
    assert len(t_stats) == STEPS
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    for tier in ("host", "pcie", "hbm"):
        assert dataclasses.asdict(t_traffic[tier]) == dataclasses.asdict(j_traffic[tier]), tier
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_table, j_table, rtol=0, atol=TABLE_ATOL)
    assert not any(tops.launch_counts().values())


@pytest.mark.parametrize("design,fused", [("scratchpipe", False), ("scratchpipe", True),
                                          ("strawman", False)])
def test_runtime_matches_reference_under_eviction(design, fused):
    """A scratchpad smaller than the table (2,400 slots for 16,384 rows), so
    [Collect] reads victims, [Exchange] copies them back and [Insert]
    writes them to the host every cycle: still identical StepStats and
    traffic, losses and tables within the tolerances above."""
    kw = dict(rows_per_table=4096)
    cfg_j = dataclasses.replace(jcfgs.smoke_config(), **kw)
    cfg_t = dataclasses.replace(tcfgs.smoke_config(), **kw)
    slots, steps = 2400, 12
    runs = []
    for cfg, host_cls, trainer, make, syn, la in (
            (cfg_j, JHost, JTrainer(cfg_j, jax.random.key(SEED), lr=LR), j_make_runtime,
             jsyn, jla),
            (cfg_t, THost, TTrainer(cfg_t, seed=SEED, lr=LR, device="cpu"), t_make_runtime,
             tsyn, tla)):
        if make is t_make_runtime:
            trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
            extra = {"device": "cpu"}
        else:
            mlps, extra = _mlps_np(trainer.mlps), {}
        host = host_cls(cfg.total_rows, cfg.embed_dim, seed=SEED)
        if fused:
            extra["fused_train_fn"] = trainer.fused_train_fn
        pipe = make(design, host, trainer.train_fn, num_slots=slots, **extra)
        stream = la.LookaheadStream(syn.dlrm_batches(_trace(cfg, syn), steps))
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        runs.append((stats, pipe.traffic(), host.data.copy()))
    (j_stats, j_traffic, j_table), (t_stats, t_traffic, t_table) = runs
    assert sum(s.n_evict for s in t_stats) > 500
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    for tier in ("host", "pcie", "hbm"):
        assert dataclasses.asdict(t_traffic[tier]) == dataclasses.asdict(j_traffic[tier]), tier
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_table, j_table, rtol=0, atol=TABLE_ATOL)


def test_designs_bitwise_equal_within_the_port(reference_runs):
    runs = {d: _port_run(*d, reference_runs["mlps"]) for d in DESIGNS}
    base_losses, base_table = _losses(runs[DESIGNS[0]][0]), runs[DESIGNS[0]][2]
    assert np.isfinite(base_losses).all()
    for d, (stats, _, table) in runs.items():
        np.testing.assert_array_equal(_losses(stats), base_losses, err_msg=str(d))
        np.testing.assert_array_equal(table, base_table, err_msg=str(d))


def test_training_registry_and_options():
    assert {"scratchpipe", "strawman", "nocache", "static", "sharded"} <= set(
        available_runtimes())
    host = THost(64, 4, seed=0)
    noop = lambda s, slots, b: (s, {})  # noqa: E731
    # supervision and telemetry are ported: the options build
    from repro_torch.obs import Tracer
    from repro_torch.runtime import SupervisePolicy, TrainSupervisor

    pipe = t_make_runtime("scratchpipe", host, noop, num_slots=16, device="cpu",
                          executor="overlapped", supervise=SupervisePolicy(),
                          tracer=Tracer())
    assert pipe._sv is not None and pipe._tracer is not None
    pipe.close()
    # the LM's step-function supervisor is ported with LM training (item 18)
    assert TrainSupervisor(None, None, None).nan_policy == "restore"
    # multi-table is ported: a table group splits the slots into per-table ranges
    pipe = t_make_runtime("scratchpipe", host, noop, num_slots=16, device="cpu",
                          table_group=TGroup.uniform(2, 32, 4), slot_budgets=[10, 6])
    assert pipe.planner.slot_ranges == [(0, 10), (10, 16)]
    assert list(pipe.planner.row_offsets) == [0, 32, 64]
    # the device planner and the overlapped executor are ported
    pipe = t_make_runtime("scratchpipe", host, noop, num_slots=16, device="cpu",
                          executor="overlapped", planner="device")
    assert pipe.executor == "overlapped" and type(pipe.planner).__name__ == "DevicePlanner"
    pipe.close()
    pipe = t_make_runtime("strawman", host, noop, num_slots=16, device="cpu")
    assert not pipe.pipelined and pipe.planner.past_window == 0
    # checkpointing is ported: the snapshot of an idle runtime
    st = pipe.state_arrays()
    assert st["host_table"] is host.data and "window" not in st
    assert st["storage"].shape == (16, 4) and st["traffic"].tolist() == [0] * 6
    with pytest.raises(TypeError, match="scratchpad"):
        t_make_runtime("nocache", host, noop, num_slots=16, device="cpu")
    # mixed precision is ported: int8 replicas hold 4x the rows of the budget
    pipe = t_make_runtime("scratchpipe", host, noop, num_slots=16, precision="int8",
                          device="cpu")
    assert pipe.num_slots == 64 and pipe.nominal_slots == 16
    assert TTrainer(tcfgs.smoke_config(), precision="int8", device="cpu").precision == "int8"


# ---------------------------------------------------------------------------
# hold window: P1-P4 of tests/test_scratchpipe_properties.py on the port
# ---------------------------------------------------------------------------
class SlotCountingTrainer:
    """Counts one update per unique row per batch via the slot mapping."""

    def train_fn(self, storage, slots, batch):
        uniq = torch.from_numpy(np.unique(np.asarray(slots))).long()
        storage[uniq] += 1.0
        return storage, {}


def run_pipe(batches, rows, slots, *, pipelined=True, past=3, future=2):
    host = THost(rows, 4, seed=1)
    host.data[:] = 0.0
    pipe = TScratchPipe(host, slots, SlotCountingTrainer().train_fn, pipelined=pipelined,
                        past_window=past, future_window=future, device="cpu")
    stream = tla.LookaheadStream(iter([(b, {}) for b in batches]))
    pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    return host.data[:, 0].copy()


def exact_counts(batches, rows):
    out = np.zeros(rows)
    for b in batches:
        np.add.at(out, np.unique(b), 1.0)
    return out


def _worst(batches):
    return max((sum(len(np.unique(b)) for b in batches[i:i + 6])
                for i in range(len(batches))), default=1)


@settings(max_examples=20, deadline=None)
@given(st.data())
def test_p1_pipelined_equals_sequential(data):
    rows = data.draw(st.integers(20, 120))
    n_batches = data.draw(st.integers(1, 25))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
    batches = [rng.integers(0, rows, size=rng.integers(1, 12)) for _ in range(n_batches)]
    got = run_pipe(batches, rows, min(rows, _worst(batches) + 4))
    np.testing.assert_array_equal(got, exact_counts(batches, rows))


def test_p2_future_window_is_necessary():
    """The reference's RAW-4 hazard trace: without the future window, b6's
    [Collect] reads id0 from the host before b5's [Insert] writes b0's
    update back."""
    batches = [np.array([i]) for i in (0, 1, 2, 3, 2, 4, 0, 7)]
    rows, slots = 10, 4
    want = exact_counts(batches, rows)
    np.testing.assert_array_equal(run_pipe(batches, rows, slots, past=3, future=2), want)
    bad = run_pipe(batches, rows, slots, past=3, future=0)
    assert not np.array_equal(bad, want)
    assert bad[0] == want[0] - 1  # id0 lost exactly b0's update


def test_p3_strawman_exact():
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 40, size=6) for _ in range(15)]
    got = run_pipe(batches, 40, 20, pipelined=False)
    np.testing.assert_array_equal(got, exact_counts(batches, 40))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_p4_worst_case_sizing_never_raises(seed):
    rng = np.random.default_rng(seed)
    rows = 200
    batches = [rng.integers(0, rows, size=10) for _ in range(20)]
    run_pipe(batches, rows, min(rows, _worst(batches)))  # must not raise


@pytest.mark.parametrize("pipelined", [True, False])
def test_incremental_driving_matches_run(pipelined):
    """run_one_cycle per batch (then drain_one_cycle until the window is
    empty) gives the same stats and table as run()."""
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 60, size=7) for _ in range(9)]
    want = run_pipe(batches, 60, 40, pipelined=pipelined)
    host = THost(60, 4, seed=1)
    host.data[:] = 0.0
    pipe = TScratchPipe(host, 40, SlotCountingTrainer().train_fn, pipelined=pipelined,
                        device="cpu")
    stream = tla.LookaheadStream(iter([(b, {}) for b in batches]))
    done = [pipe.run_one_cycle(ids, b, lookahead_fn=stream.peek_ids) for ids, b in stream]
    while pipe._window:
        done.append(pipe.drain_one_cycle())
    assert [s.step for s in done if s is not None] == list(range(1, 10))
    pipe.flush_to_host()
    np.testing.assert_array_equal(host.data[:, 0], want)


def test_hit_rate_reaches_one_when_cache_covers_table():
    rng = np.random.default_rng(1)
    rows = 30
    batches = [rng.integers(0, rows, size=8) for _ in range(30)]
    pipe = TScratchPipe(THost(rows, 4, seed=1), rows, SlotCountingTrainer().train_fn,
                        device="cpu")
    stream = tla.LookaheadStream(iter([(b, {}) for b in batches]))
    assert pipe.run(stream, lookahead_fn=stream.peek_ids)[-1].hit_rate == 1.0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch(module, extra):
    cmd = [sys.executable, "-m", module, "--arch", "dlrm-scratchpipe", "--smoke",
           "--steps", "10", *extra]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def _fields(lines):
    """(runtime line minus kernel=, plan_hit, traffic line, (loss a, loss b))."""
    done = next(ln for ln in lines if ln.startswith("done: "))
    run = next(ln for ln in lines if ln.startswith("runtime="))
    loss = done.split(" loss ")[1].split()[0].split("->")
    return (" ".join(w for w in run.split() if not w.startswith("kernel=")),
            done.split("plan_hit=")[1].split()[0],
            next(ln for ln in lines if ln.startswith("traffic: ")),
            tuple(float(x) for x in loss))


@pytest.mark.parametrize("runtime", ["scratchpipe", "nocache"])
def test_launcher_prints_reference_figures(runtime, capsys):
    ref = _fields(_launch("repro.launch.train", ["--runtime", runtime]))
    port = _fields(_launch("repro_torch.launch.train", ["--runtime", runtime, "--device", "cpu"]))
    assert port[:3] == ref[:3]
    # the same run in-process, from the reference's MLP init: the losses too
    args = tlaunch.build_parser().parse_args(
        ["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "10", "--runtime", runtime,
         "--device", "cpu"])
    mlps = _mlps_np(jdlrm.init_mlps(jcfgs.smoke_config(), jax.random.key(args.seed)))
    capsys.readouterr()
    res = tlaunch.train_dlrm(args, mlps=convert.mlps_from_reference(mlps))
    inproc = _fields(capsys.readouterr().out.splitlines())
    assert inproc[:3] == ref[:3]
    np.testing.assert_allclose([res["losses"][0], res["losses"][-1]], ref[3],
                               rtol=0, atol=1e-4 + 1e-4 * max(ref[3]))


def test_launcher_rejects_what_is_not_ported():
    for extra in (["--runtime", "sharded"],
                  ["--runtime", "nocache", "--precision", "fp16"],
                  ["--supervise", "--runtime", "nocache"],
                  ["--trace", "x"], ["--chaos", "kill-gather@"]):
        with pytest.raises(SystemExit):
            tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--device", "cpu", *extra])
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "llama3-8b", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the launcher's --trace, --record-trace and --scenario
# ---------------------------------------------------------------------------
def _reference_launch(monkeypatch, capsys, argv):
    """The reference launcher in-process: its printed lines, the runtime it
    built (for StepStats and traffic) and its trainer's initial MLPs."""
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


@pytest.fixture(scope="module")
def recorded_traces(tmp_path_factory):
    """10 smoke steps recorded while training, once by each launcher."""
    out = {}
    for pkg in ("ref", "port"):
        path = str(tmp_path_factory.mktemp("traces") / pkg)
        module = "repro.launch.train" if pkg == "ref" else "repro_torch.launch.train"
        extra = ["--record-trace", path] + (["--device", "cpu"] if pkg == "port" else [])
        lines = _launch(module, extra)
        assert f"recorded trace -> {path}" in lines
        out[pkg] = path
    return out


def test_record_trace_launchers_write_identical_bytes(recorded_traces):
    import filecmp

    a, b = recorded_traces["ref"], recorded_traces["port"]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False)


@pytest.mark.parametrize("extra,rtol", [
    (["--runtime", "scratchpipe"], LOSS_RTOL),
    (["--runtime", "scratchpipe", "--fused", "--planner", "device",
      "--executor", "overlapped"], LOSS_RTOL),
    (["--runtime", "static"], LOSS_RTOL),
    (["--runtime", "nocache"], LOSS_RTOL),
    (["--precision", "int8", "--rounding", "nearest"], 1e-4),
    (["--scenario", "drift"], LOSS_RTOL),
], ids=["scratchpipe", "device-overlapped-fused", "static", "nocache", "int8-nearest",
        "scenario-drift"])
def test_trace_launcher_matches_reference(recorded_traces, monkeypatch, capsys, extra,
                                          rtol):
    """Replaying the reference's recorded trace (or drawing a scenario):
    the port's launcher gives the reference's StepStats and traffic, the
    same runtime=/done:/traffic: figures, and losses within the MLP tier
    from the reference's MLP init."""
    src = [] if "--scenario" in extra else ["--trace", recorded_traces["ref"]]
    argv = ["--steps", "10", *src, *extra]
    ref_lines, j_pipe, mlps = _reference_launch(monkeypatch, capsys, argv)
    args = tlaunch.build_parser().parse_args(
        ["--arch", "dlrm-scratchpipe", "--smoke", *argv, "--device", "cpu"])
    res = tlaunch.train_dlrm(args, mlps=convert.mlps_from_reference(mlps))
    port_lines = capsys.readouterr().out.splitlines()
    if hasattr(res["pipe"], "close"):
        res["pipe"].close()
    assert _fields(port_lines)[:3] == _fields(ref_lines)[:3]
    want_src = "scenario:drift" if src == [] else f"trace:{recorded_traces['ref']}"
    assert f"source={want_src}" in _fields(port_lines)[0]
    assert len(res["stats"]) == 10
    assert _plain_stats(res["stats"]) == _plain_stats(j_pipe.stats)
    for tier, t in res["pipe"].traffic().items():
        assert dataclasses.asdict(t) == dataclasses.asdict(j_pipe.traffic()[tier]), tier
    np.testing.assert_allclose(res["losses"], _losses(j_pipe.stats), rtol=rtol)


@pytest.mark.parametrize("extra", [
    [],
    ["--fused", "--planner", "device", "--executor", "overlapped"],
    ["--runtime", "strawman"],
    ["--precision", "int8", "--fused"],
], ids=["scratchpipe", "device-overlapped-fused", "strawman", "int8-fused"])
def test_trace_replay_equals_generator_run(tmp_path, extra):
    """A trace recorded from the synthetic generator while training, then
    replayed: the losses and the flushed host table bitwise equal to the
    generator-driven run's (int8's stochastic rounding is seeded per step,
    so it replays too)."""
    path = str(tmp_path / "t")
    runs = []
    for src in (["--record-trace", path], ["--trace", path]):
        args = tlaunch.build_parser().parse_args(
            ["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "12", "--device", "cpu",
             *src, *extra])
        res = tlaunch.train_dlrm(args)
        res["pipe"].flush_to_host()
        if hasattr(res["pipe"], "close"):
            res["pipe"].close()
        runs.append((np.array(res["losses"]), res["host"].data.copy(), res["stats"]))
    (l0, t0, s0), (l1, t1, s1) = runs
    assert len(l0) == len(l1) == 12 and np.isfinite(l0).all()
    np.testing.assert_array_equal(l0, l1)
    np.testing.assert_array_equal(t0, t1)
    assert _plain_stats(s0) == _plain_stats(s1)


def test_trace_launcher_refuses(tmp_path, capsys):
    from repro_torch.core.table_group import TableGroup, TableSpec
    from repro_torch.traces import record_serving_trace, record_trace, scenario_batches

    def run(*extra):
        return tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "3",
                             "--device", "cpu", *extra])

    with pytest.raises(SystemExit):
        run("--trace", str(tmp_path / "none"))
    assert "not a recorded trace directory" in capsys.readouterr().err
    uniform = TableGroup.uniform(2, 64, 8)
    serving = str(tmp_path / "serving")
    record_serving_trace(serving, uniform, scenario_batches(
        "inference_mix", uniform, 3, batch_size=4, lookups_per_table=2, seed=0))
    with pytest.raises(SystemExit, match="no dense features"):
        run("--trace", serving)
    with pytest.raises(SystemExit):
        run("--trace", serving, "--scenario", "drift")
    assert "mutually exclusive" in capsys.readouterr().err
    hetero = TableGroup([TableSpec("a", 64, 8), TableSpec("b", 32, 8)])
    path = str(tmp_path / "hetero")
    record_trace(path, hetero, scenario_batches(
        "drift", hetero, 3, batch_size=4, lookups_per_table=2, seed=0))
    # tables that differ in rows train with per-table budgets (the §VI-D
    # floor of 6 x 4 x 2 lookups, capped at each table's rows)
    res = run("--trace", path)
    res["pipe"].close()
    assert len(res["stats"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["pipe"].planner.slot_ranges == [(0, 64), (64, 96)]
    assert all(st.by_table is not None for st in res["stats"])
