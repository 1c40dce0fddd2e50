"""Crash-consistent recovery in the port, against the reference, on the CPU
(tests/test_recovery.py, tests/test_checkpoint_ft.py and
tests/test_perf_flags_and_ft.py, ported):

  * a run killed mid-window and restored into a fresh runtime replays
    bitwise equal to one that never died — losses, plan decisions and every
    final state array — across planner x executor x replica precision, and
    its losses equal the reference's uninterrupted run within rtol 1e-5
    (fp32) / 1e-4 (fp16/int8), its StepStats identical;
  * the same for the sharded runtime (``shard<i>_`` keys);
  * ACROSS PACKAGES: at a mid-window cycle the port's ``state_arrays()``
    equals the reference's (counting trainer: every array, the window
    blob's entries included), and a reference checkpoint directory, read
    by the port's ``CheckpointManager`` and carried across with
    ``convert.pipe_state_from_reference``, continues in the port bitwise
    equal to the reference's uninterrupted run; the reference reads a port
    checkpoint the same way;
  * ``CheckpointManager``: roundtrip, async keep-k, a missing leaf, a
    background failure surfacing on the next save, fsync before rename;
  * ``EmbeddingTrainSupervisor`` with the DLRM trainer: a NaN step
    quarantined by restore, ``max_restarts``, a preemption checkpoint;
    ``TrainSupervisor`` (LM training) names its ROADMAP item.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.checkpoint.manager as t_manager
from repro.checkpoint import CheckpointManager as JCkpt
from repro.checkpoint.pack import unpack_blob as j_unpack
from repro.configs.base import DLRMConfig as JConfig
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.pipeline import ScratchPipe as JPipe
from repro.core.sharded_pipeline import ShardedScratchPipe as JSharded
from repro.core.table_group import TableGroup as JGroup
from repro.traces.format import TraceReader as JReader
from repro.traces.replay import TraceReplayStream as JReplay
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, unpack_blob
from repro_torch.configs.base import DLRMConfig as TConfig
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TPipe
from repro_torch.core.sharded_pipeline import ShardedScratchPipe as TSharded
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.data.lookahead import LookaheadStream as TStream
from repro_torch.runtime import (
    EmbeddingTrainSupervisor,
    FailureInjector,
    PreemptionHandler,
    SupervisePolicy,
    TrainSupervisor,
)
from repro_torch.traces import record_trace, scenario_batches
from repro_torch.traces.replay import TraceReplayStream as TReplay

SEED = 7
STEPS = 12
KILL_AT = 7  # admitted batches before the "crash" — mid-window by design
DENSE = 4
CFG_KW = dict(name="dlrm-recovery-test", num_tables=2, rows_per_table=300, embed_dim=8,
              lookups_per_table=2, batch_size=8, num_dense_features=DENSE,
              bottom_mlp=(16, 8), top_mlp=(16, 1))
SLOTS = 256
LOSS_RTOL = {"fp32": 1e-5, "fp16": 1e-4, "int8": 1e-4}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Recorded drift + flash_crowd training traces (ids + dense + labels),
    one path each, read by both packages."""
    root = tmp_path_factory.mktemp("recovery_traces")
    group = TGroup.from_config(TConfig(**CFG_KW))
    out = {}
    for scenario in ("drift", "flash_crowd"):
        path = str(root / scenario)
        record_trace(path, group, scenario_batches(
            scenario, group, STEPS, batch_size=CFG_KW["batch_size"],
            lookups_per_table=CFG_KW["lookups_per_table"], num_dense_features=DENSE,
            seed=SEED))
        out[scenario] = path
    return out


@pytest.fixture(scope="module")
def mlps():
    """The reference's MLP init, as numpy (the port trains from it too)."""
    tr = JTrainer(JConfig(**CFG_KW), jax.random.key(0), lr=0.05)
    return jax.tree.map(lambda a: np.array(a, copy=True), tr.mlps)


def fresh(executor, planner, precision, mlps):
    group = TGroup.from_config(TConfig(**CFG_KW)).with_precision(precision)
    host = THost(group.total_rows, CFG_KW["embed_dim"], seed=1)
    tr = TTrainer(TConfig(**CFG_KW), seed=0, lr=0.05, precision=precision,
                  rounding="nearest", device="cpu")
    tr.model.load_state_dict(convert.mlps_from_reference(mlps))
    kw = dict(planner=planner, table_group=group, executor=executor, device="cpu")
    if executor == "overlapped":
        kw["supervise"] = SupervisePolicy(backoff=0.0)
    return host, tr, TPipe(host, SLOTS, tr.train_fn, **kw)


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats], dtype=np.float64)


def _plan_seq(stats):
    return [(s.step, s.n_unique, s.n_hits, s.n_miss, s.n_evict) for s in stats]


def _assert_state_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"state key {k!r}")


def _assert_tree_equal(a, b, where="window"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, (int, float, str)):
        assert a == b, where
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)


@pytest.mark.parametrize(
    "scenario,executor,planner,precision",
    [
        ("drift", "sync", "host", "fp32"),
        ("drift", "overlapped", "host", "fp32"),
        ("drift", "sync", "device", "fp32"),
        ("drift", "overlapped", "device", "fp32"),
        ("drift", "sync", "host", "int8"),
        ("drift", "overlapped", "host", "fp16"),
        ("drift", "overlapped", "device", "int8"),
        ("flash_crowd", "overlapped", "host", "fp32"),
        ("flash_crowd", "sync", "device", "int8"),
    ],
)
def test_midwindow_kill_resume_parity(tmp_path, traces, mlps, scenario, executor,
                                      planner, precision):
    """Kill at admitted batch 7 with batches still IN FLIGHT, restore into
    a fresh runtime, finish the trace: bitwise equal to the uninterrupted
    run, and within the parity tiers of the reference's run."""
    path = traces[scenario]

    # A: uninterrupted
    host_a, tr_a, pipe_a = fresh(executor, planner, precision, mlps)
    sa = TReplay(path, stop=STEPS)
    stats_a = pipe_a.run(sa, lookahead_fn=sa.peek_ids)
    sa.close()
    pipe_a.flush_to_host()
    final_a = pipe_a.state_arrays()
    pipe_a.close()
    assert len(stats_a) == STEPS

    # B: admit KILL_AT batches, checkpoint MID-WINDOW, then "crash"
    host_b, tr_b, pipe_b = fresh(executor, planner, precision, mlps)
    sb = TReplay(path, stop=STEPS)
    it = iter(sb)
    for _ in range(KILL_AT):
        ids, batch = next(it)
        pipe_b.run_one_cycle(ids, batch, sb.peek_ids)
    sb.close()
    assert pipe_b._window, "checkpoint must land mid-window, not at a drain"
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(KILL_AT, {"mlps": tr_b.model.state_dict()}, host_arrays=pipe_b.state_arrays(),
            extra={"trainer_step": int(tr_b._step)}, blocking=True)
    stats_before_kill = list(pipe_b.stats)
    pipe_b.close()

    # C: a fresh runtime — restore and fast-forward the deterministic stream
    host_c, tr_c, pipe_c = fresh(executor, planner, precision, mlps)
    restored, _ = cm.restore({"mlps": tr_c.model.state_dict()})
    tr_c.model.load_state_dict(restored["mlps"])
    tr_c._step = int(cm.manifest()["extra"]["trainer_step"])
    pipe_c.load_state_arrays({n: cm.restore_host(n) for n in cm.manifest()["host"]})
    sc = TReplay(path, start=KILL_AT, stop=STEPS)
    for ids, batch in iter(sc):
        pipe_c.run_one_cycle(ids, batch, sc.peek_ids)
    sc.close()
    while pipe_c._window:
        pipe_c.drain_one_cycle()
    pipe_c.flush_to_host()
    final_c = pipe_c.state_arrays()
    stats_resumed = stats_before_kill + list(pipe_c.stats)
    pipe_c.close()

    np.testing.assert_array_equal(_losses(stats_resumed), _losses(stats_a))
    assert _plan_seq(stats_resumed) == _plan_seq(stats_a)
    np.testing.assert_array_equal(host_c.data, host_a.data)
    _assert_state_equal(final_c, final_a)

    # the reference's uninterrupted run on the same trace and MLP init
    jgroup = JGroup.from_config(JConfig(**CFG_KW)).with_precision(precision)
    jtr = JTrainer(JConfig(**CFG_KW), jax.random.key(0), lr=0.05, precision=precision,
                   rounding="nearest")
    jpipe = JPipe(JHost(jgroup.total_rows, CFG_KW["embed_dim"], seed=1), SLOTS,
                  jtr.train_fn, planner=planner, table_group=jgroup, executor=executor)
    js = JReplay(JReader(path), stop=STEPS)
    jstats = jpipe.run(js, lookahead_fn=js.peek_ids)
    jpipe.close()
    assert _plan_seq(stats_resumed) == _plan_seq(jstats)
    np.testing.assert_allclose(_losses(stats_resumed), _losses(jstats),
                               rtol=LOSS_RTOL[precision])


def t_sharded_train(storages, slots_all, batch):
    touched = 0
    for storage, slots in zip(storages, slots_all):
        s = torch.as_tensor(np.asarray(slots)).reshape(-1).long()
        if s.numel():
            u = torch.unique(s)
            storage[u] += 1.0
            touched += int(u.numel())
    return storages, {"loss": float(sum(float(s.sum()) for s in storages))}


@pytest.mark.parametrize("executor", ["sync", "overlapped"])
def test_sharded_midwindow_kill_resume_parity(tmp_path, executor):
    """ShardedScratchPipe: shard-indexed state keys round-trip mid-window;
    the flushed tables equal the reference's uninterrupted run."""
    rows, dim, shards = 240, 4, 3
    rng = np.random.default_rng(SEED)
    batches = [rng.integers(0, rows, size=14) for _ in range(STEPS)]
    kw = dict(executor=executor, device="cpu")
    if executor == "overlapped":
        kw["supervise"] = SupervisePolicy(backoff=0.0)

    def build():
        host = THost(rows, dim, seed=1)
        return host, TSharded(host, 80, shards, t_sharded_train, **kw)

    host_a, pipe_a = build()
    stats_a = pipe_a.run(iter([(b, {}) for b in batches]))
    pipe_a.flush_to_host()
    final_a = pipe_a.state_arrays()
    pipe_a.close()

    host_b, pipe_b = build()
    for b in batches[:KILL_AT]:
        pipe_b.run_one_cycle(b, {})
    assert pipe_b.pipes[-1]._window, "must checkpoint mid-window"
    cm = CheckpointManager(str(tmp_path / "ck"))
    cm.save(KILL_AT, {}, host_arrays=pipe_b.state_arrays(), blocking=True)
    stats_head = list(pipe_b.stats)
    pipe_b.close()

    host_c, pipe_c = build()
    pipe_c.load_state_arrays({n: cm.restore_host(n) for n in cm.manifest()["host"]})
    for b in batches[KILL_AT:]:
        pipe_c.run_one_cycle(b, {})
    while pipe_c.pipes[-1]._window:
        pipe_c.drain_one_cycle()
    pipe_c.flush_to_host()
    stats_resumed = stats_head + list(pipe_c.stats)
    final_c = pipe_c.state_arrays()
    pipe_c.close()

    np.testing.assert_array_equal(_losses(stats_resumed), _losses(stats_a))
    np.testing.assert_array_equal(host_c.data, host_a.data)
    _assert_state_equal(final_c, final_a)

    def j_train(storages, slots_all, batch):
        out = []
        for storage, slots in zip(storages, slots_all):
            slots = np.asarray(slots)
            out.append(storage if slots.size == 0
                       else storage.at[np.unique(slots.ravel())].add(1.0))
        return out, {"loss": float(sum(float(s.sum()) for s in out))}

    jhost = JHost(rows, dim, seed=1)
    jpipe = JSharded(jhost, 80, shards, j_train, executor=executor)
    jstats = jpipe.run(iter([(b, {}) for b in batches]))
    jpipe.flush_to_host()
    jpipe.close()
    np.testing.assert_array_equal(host_c.data, jhost.data)
    # the "loss" sums the storages: the two libraries' summation orders
    np.testing.assert_allclose(_losses(stats_resumed), _losses(jstats), rtol=1e-6)


# --------------------------------------------------------------------------- #
# across packages: the snapshot itself, and a reference checkpoint resumed
# --------------------------------------------------------------------------- #
def j_count_train(storage, slots, batch):
    if not isinstance(storage, jax.Array) or storage.dtype != jnp.float32:
        return storage, {}  # reduced precision: the rows stay as filled
    uniq = jnp.unique(jnp.asarray(slots).ravel(), size=slots.size, fill_value=-1)
    ok = uniq >= 0
    add = jnp.zeros_like(storage).at[jnp.where(ok, uniq, 0)].add(
        jnp.where(ok, 1.0, 0.0)[:, None])
    return storage + add, {}


def t_count_train(storage, slots, batch):
    if isinstance(storage, torch.Tensor) and storage.dtype == torch.float32:
        storage[torch.unique(torch.as_tensor(np.asarray(slots)).reshape(-1).long())] += 1.0
    return storage, {}


#: 80 rows (40 per table): the window's entries carry victims by the
#: kill cycle
COUNT_ROWS = 80


def _count_pipe(pkg, planner, precision, executor="sync"):
    ref = pkg == "ref"
    slots = COUNT_ROWS // {"fp32": 1, "fp16": 2, "int8": 4}[precision]
    group = (JGroup if ref else TGroup).uniform(2, 400, 8).with_precision(precision)
    host = (JHost if ref else THost)(group.total_rows, 8, seed=1)
    if precision == "fp32":
        host.data[:] = 0.0
    kw = dict(table_group=group, planner=planner, executor=executor)
    if not ref:
        kw["device"] = "cpu"
    return host, (JPipe if ref else TPipe)(host, slots, j_count_train if ref else t_count_train,
                                           **kw)


def _count_batches():
    group = TGroup.uniform(2, 400, 8)
    return [g for g, _ in scenario_batches("drift", group, STEPS, batch_size=4,
                                           lookups_per_table=3, seed=SEED)]


def _drive(pipe, batches, stream_cls, admit=None):
    """Admit ``batches`` (the first ``admit`` of them) one cycle each, the
    planner looking ahead over the whole list."""
    stream = stream_cls(iter([(b, {}) for b in batches]))
    for i, (ids, b) in enumerate(stream):
        if i == admit:
            break
        pipe.run_one_cycle(ids, b, stream.peek_ids)


@pytest.mark.parametrize("planner,precision", [("host", "fp32"), ("device", "fp32"),
                                               ("host", "int8"), ("device", "fp16")])
def test_midwindow_state_arrays_equal_the_reference(planner, precision):
    from repro.data.lookahead import LookaheadStream as JStream

    batches = _count_batches()
    _, jpipe = _count_pipe("ref", planner, precision)
    _, tpipe = _count_pipe("port", planner, precision)
    _drive(jpipe, batches, JStream, admit=KILL_AT)
    _drive(tpipe, batches, TStream, admit=KILL_AT)
    assert sum(int(e.plan.evict_slots.size) for e in tpipe._window) > 0
    ja, ta = jpipe.state_arrays(), tpipe.state_arrays()
    assert sorted(ja) == sorted(ta)
    for k in ja:
        if k != "window":
            np.testing.assert_array_equal(np.asarray(ta[k]), np.asarray(ja[k]), err_msg=k)
    _assert_tree_equal(unpack_blob(ta["window"]), j_unpack(ja["window"]))
    # and each package reads the other's blob
    _assert_tree_equal(unpack_blob(ja["window"]), j_unpack(ta["window"]))
    tpipe.close()
    jpipe.close()


@pytest.mark.parametrize("planner,precision", [("host", "fp32"), ("device", "fp32"),
                                               ("host", "int8")])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, planner, precision):
    """A reference runtime checkpointed mid-window by the reference's
    CheckpointManager; the port reads the directory, carries the arrays
    across and finishes the stream: bitwise equal to the reference's
    uninterrupted run (counting trainer). Then the other way round: the
    reference resumes from a port checkpoint."""
    from repro.data.lookahead import LookaheadStream as JStream

    batches = _count_batches()
    jhost_a, jpipe_a = _count_pipe("ref", planner, precision)
    _drive(jpipe_a, batches, JStream)
    while jpipe_a._window:
        jpipe_a.drain_one_cycle()
    jpipe_a.flush_to_host()
    jstats = jpipe_a.stats

    _, jpipe_b = _count_pipe("ref", planner, precision)
    _drive(jpipe_b, batches, JStream, admit=KILL_AT)
    assert jpipe_b._window
    JCkpt(str(tmp_path / "ref")).save(KILL_AT, {}, host_arrays=jpipe_b.state_arrays(),
                                      blocking=True)
    head = list(jpipe_b.stats)

    cm = CheckpointManager(str(tmp_path / "ref"))
    arrays = {n: cm.restore_host(n) for n in cm.manifest()["host"]}
    thost, tpipe = _count_pipe("port", planner, precision)
    tpipe.load_state_arrays(convert.pipe_state_from_reference(arrays))
    _drive(tpipe, batches[KILL_AT:], TStream)
    while tpipe._window:
        tpipe.drain_one_cycle()
    tpipe.flush_to_host()
    np.testing.assert_array_equal(thost.data, jhost_a.data)
    assert _plan_seq(head + list(tpipe.stats)) == _plan_seq(jstats)

    # the reference resumes from a port checkpoint taken at the same cycle
    _, tpipe_b = _count_pipe("port", planner, precision)
    _drive(tpipe_b, batches, TStream, admit=KILL_AT)
    CheckpointManager(str(tmp_path / "port")).save(
        KILL_AT, {}, host_arrays=tpipe_b.state_arrays(), blocking=True)
    jcm = JCkpt(str(tmp_path / "port"))
    jhost_c, jpipe_c = _count_pipe("ref", planner, precision)
    jpipe_c.load_state_arrays({n: jcm.restore_host(n) for n in jcm.manifest()["host"]})
    _drive(jpipe_c, batches[KILL_AT:], JStream)
    while jpipe_c._window:
        jpipe_c.drain_one_cycle()
    jpipe_c.flush_to_host()
    np.testing.assert_array_equal(jhost_c.data, jhost_a.data)


def test_convert_copies_and_checks():
    from repro.data.lookahead import LookaheadStream as JStream

    _, jpipe = _count_pipe("ref", "device", "fp32")
    _drive(jpipe, _count_batches(), JStream, admit=KILL_AT)
    arrays = jpipe.state_arrays()
    out = convert.pipe_state_from_reference(arrays)
    assert sorted(out) == sorted(arrays)
    for k, v in out.items():
        assert not np.shares_memory(v, np.asarray(arrays[k])), k
    # a sharded snapshot keeps its shard prefixes
    sharded = {f"shard{i}_{k}": v for i in range(2) for k, v in arrays.items()}
    assert sorted(convert.pipe_state_from_reference(sharded)) == sorted(sharded)
    with pytest.raises(ValueError, match="no 'storage'"):
        convert.pipe_state_from_reference({"host_table": arrays["host_table"]})
    # a blob that names a class is refused, not unpickled
    import pickle

    evil = np.frombuffer(pickle.dumps({"v": 1, "obj": JHost}), np.uint8)
    with pytest.raises(pickle.UnpicklingError, match="numpy arrays and builtins"):
        unpack_blob(evil)


# --------------------------------------------------------------------------- #
# CheckpointManager
# --------------------------------------------------------------------------- #
def make_state(x=0.0):
    return {"w": torch.full((4, 3), x), "nested": {"b": torch.arange(5, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    st = make_state(1.5)
    cm.save(10, st, host_arrays={"table": np.ones((3, 2))}, blocking=True)
    got, step = cm.restore(make_state())
    assert step == 10
    assert torch.equal(got["w"], st["w"]) and torch.equal(got["nested"]["b"], st["nested"]["b"])
    assert got["nested"]["b"].dtype == torch.int32
    np.testing.assert_array_equal(cm.restore_host("table"), np.ones((3, 2)))
    assert cm.manifest()["step"] == 10
    # the reference reads it: the same leaves under the same key paths
    jgot, jstep = JCkpt(str(tmp_path)).restore(
        {"w": jnp.zeros((4, 3)), "nested": {"b": jnp.zeros(5, jnp.int32)}})
    assert jstep == 10
    np.testing.assert_array_equal(np.asarray(jgot["w"]), st["w"].numpy())


def test_async_save_and_keep_k(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, make_state(float(s)))
    cm.wait()
    assert cm.all_steps() == [3, 4]
    got, step = cm.restore(make_state())
    assert step == 4 and float(got["w"][0, 0]) == 4.0


def test_restore_missing_leaf_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"a": np.zeros(2)}, blocking=True)
    with pytest.raises(KeyError):
        cm.restore({"a": np.zeros(2), "zzz": np.zeros(3)})


def test_async_save_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path), durable=False)

    def boom(*a, **kw):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(t_manager.np, "savez", boom)
    cm.save(1, {"x": np.zeros(3)}, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        cm.save(2, {"x": np.zeros(3)}, blocking=False)
    monkeypatch.undo()
    cm.wait()  # the error is consumed once surfaced
    cm.save(3, {"x": np.ones(3)}, blocking=True)
    assert cm.latest_step() == 3


def test_durable_save_fsyncs_before_rename(tmp_path, monkeypatch):
    events = []
    real_replace = os.replace
    monkeypatch.setattr(t_manager.os, "fsync", lambda fd: events.append("fsync"))
    monkeypatch.setattr(t_manager.os, "replace",
                        lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    cm = CheckpointManager(str(tmp_path / "durable"), durable=True)
    cm.save(1, {"x": np.zeros(3)}, host_arrays={"t": np.ones(2)}, blocking=True)
    ri = events.index("replace")
    assert events[:ri].count("fsync") >= 3  # arrays + host + manifest + dirs
    assert "fsync" in events[ri + 1:]  # parent dir after the rename
    events.clear()
    CheckpointManager(str(tmp_path / "fast"), durable=False).save(
        1, {"x": np.zeros(3)}, blocking=True)
    assert events.count("fsync") == 0


# --------------------------------------------------------------------------- #
# EmbeddingTrainSupervisor with the DLRM trainer
# --------------------------------------------------------------------------- #
def _dlrm_supervised(tmp_path, mlps, *, nan_at=(), fail_at=(), max_restarts=5,
                     preemption=None, executor="overlapped"):
    """The supervisor over a DLRM runtime; ``nan_at`` poisons the losses of
    those train calls of the FIRST runtime incarnation, ``fail_at`` fails
    them (``FailureInjector``: a node lost mid-step)."""
    from repro_torch.traces.replay import TraceReplayStream

    cfg = TConfig(**CFG_KW)
    group = TGroup.from_config(cfg)
    path = str(tmp_path / "trace")
    record_trace(path, group, scenario_batches(
        "drift", group, STEPS, batch_size=8, lookups_per_table=2,
        num_dense_features=DENSE, seed=SEED))
    first = [True]

    def runtime_factory():
        host, tr, pipe = fresh(executor, "host", "fp32", mlps)
        if first[0] and (nan_at or fail_at):
            calls = [0]
            real = tr.train_fn
            failures = FailureInjector(fail_at)

            def poisoned(storage, slots, batch):
                calls[0] += 1
                failures.maybe_fail()
                storage, aux = real(storage, slots, batch)
                if calls[0] in nan_at:
                    aux = {"loss": torch.tensor(float("nan"))}
                return storage, aux

            pipe.train_fn = poisoned
        first[0] = False
        return pipe, tr

    sup = EmbeddingTrainSupervisor(
        CheckpointManager(str(tmp_path / "ck"), durable=False), runtime_factory,
        lambda skip: TraceReplayStream(path, start=skip, stop=STEPS), ckpt_every=4,
        max_restarts=max_restarts, preemption=preemption)
    stats, report = sup.run(STEPS)
    sup.runtime.flush_to_host()
    out = (stats, report, sup.runtime.host.data.copy())
    sup.runtime.close()
    return out


def test_supervisor_quarantines_nan_by_restore(tmp_path, mlps):
    clean_stats, clean_report, clean_table = _dlrm_supervised(tmp_path / "a", mlps)
    assert clean_report.restarts == 0 and clean_report.checkpoints >= 2
    stats, report, table = _dlrm_supervised(tmp_path / "b", mlps, nan_at=(6,))
    assert report.nan_steps_skipped == 1 and report.restarts == 1
    assert report.restore_ms and report.save_ms
    np.testing.assert_array_equal(_losses(stats), _losses(clean_stats))
    assert np.isfinite(_losses(stats)).all()
    np.testing.assert_array_equal(table, clean_table)


def test_supervisor_restores_after_a_lost_step(tmp_path, mlps):
    """A step that dies before its update (a lost node) restores and
    replays to the same losses and table."""
    clean_stats, _, clean_table = _dlrm_supervised(tmp_path / "a", mlps)
    stats, report, table = _dlrm_supervised(tmp_path / "b", mlps, fail_at=(7,))
    assert report.restarts == 1 and "injected node failure" in report.causes[0]
    np.testing.assert_array_equal(_losses(stats), _losses(clean_stats))
    np.testing.assert_array_equal(table, clean_table)


def test_supervisor_max_restarts(tmp_path, mlps):
    with pytest.raises(RuntimeError, match="exceeded max_restarts=0"):
        _dlrm_supervised(tmp_path, mlps, nan_at=(6,), max_restarts=0)


def test_preemption_checkpoint(tmp_path, mlps):
    ph = PreemptionHandler()
    ph.requested = True  # a SIGTERM before the first cycle
    stats, report, _ = _dlrm_supervised(tmp_path, mlps, preemption=ph)
    assert report.checkpoints == 1 and len(stats) == 0
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 1


def test_lm_train_supervisor_names_item_18(tmp_path):
    """Item 18 ported the LM step-function supervisor (it raised, naming
    the item, before): it runs a loop, and refuses an unknown nan policy."""
    sup = TrainSupervisor(CheckpointManager(str(tmp_path)), lambda s, b: (s + b, {"loss": 0.0}),
                          lambda skip: iter(range(skip, 10)), ckpt_every=3)
    state, report = sup.run(0, total_steps=5)
    assert state == sum(range(5)) and report.steps_run == 5 and report.checkpoints == 1
    with pytest.raises(ValueError, match="nan_policy"):
        TrainSupervisor(None, None, None, nan_policy="ignore")
