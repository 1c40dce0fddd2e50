"""Fault injection (``repro_torch.chaos``) against the port's recovery
stack, on the CPU — tests/test_chaos.py, ported.

Every drill asserts the same invariant from two sides: the fault fired
(counters / report), AND the run's losses and final host table are equal
to the port's uninjected sync run and to the reference's, on the same
batches:

  * worker kills / transient op failures -> ordered inline recompute under
    the supervised overlapped executor (the d2h kill hits the d2h thread's
    wait for the victims' copy);
  * repeated faults -> graceful degradation to the sync executor;
  * stalls -> per-op timeout -> inline recompute;
  * host-row byte flips -> checksum guard -> RowCorruptionError ->
    supervisor rebuild + checkpoint restore + fast-forward;
  * NaN losses -> quarantine via restore;
  * the plan language: parse, rejection, seeded determinism (the same
    plans as the reference's);
  * unsupervised, injected faults raise;
  * the launcher: ``--supervise --chaos`` prints the ``done:``/``traffic:``
    figures of the reference launcher's supervised run and the
    ``state_digest=`` of the port's clean ``--supervise`` run; the
    reference's argument errors.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import ChaosPlan as JPlan
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.pipeline import ScratchPipe as JPipe
from repro.data.lookahead import LookaheadStream as JStream
from repro_torch.chaos import ChaosError, ChaosInjector, ChaosPlan, InjectedWorkerDeath
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.host_table import HostEmbeddingTable, RowCorruptionError
from repro_torch.core.pipeline import ScratchPipe
from repro_torch.core.serving_cache import ReadOnlyCacheServer
from repro_torch.data.lookahead import LookaheadStream
from repro_torch.launch import train as tlaunch
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime import EmbeddingTrainSupervisor, SupervisePolicy
from repro_torch.runtime.supervision import TransientOpError

ROWS, DIM, SLOTS, STEPS = 256, 8, 64, 14
SEED = 7


def _batches(steps=STEPS, seed=SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ROWS, size=(2, 1, 4)) for _ in range(steps)]


def _train_fn(storage, slots, batch):
    """+1 per unique touched slot, in place; the "loss" is order-free (the
    touched count and the largest magnitude), so both packages agree."""
    u = torch.unique(torch.as_tensor(np.asarray(slots)).reshape(-1).long())
    storage[u] += 1.0
    return storage, {"loss": 1000.0 * u.numel() + float(storage.abs().max())}


def _j_train_fn(storage, slots, batch):
    u = jnp.unique(jnp.asarray(slots).ravel(), size=slots.size, fill_value=-1)
    ok = u >= 0
    add = jnp.zeros_like(storage).at[jnp.where(ok, u, 0)].add(
        jnp.where(ok, 1.0, 0.0)[:, None])
    storage = storage + add
    return storage, {"loss": float(1000.0 * int(ok.sum()) + float(jnp.abs(storage).max()))}


def _pipe(executor="overlapped", policy=None, **kw):
    host = HostEmbeddingTable(ROWS, DIM, seed=1)
    if executor == "overlapped":
        kw["supervise"] = policy or SupervisePolicy(backoff=0.0)
    return host, ScratchPipe(host, SLOTS, _train_fn, executor=executor, device="cpu", **kw)


def _run(pipe, batches):
    stream = LookaheadStream(iter([(b, {}) for b in batches]))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    return stats


def _losses(stats):
    return [float(s.aux["loss"]) for s in stats]


@pytest.fixture(scope="module")
def reference():
    """Uninjected sync run of the port, checked against the reference's
    on the same batches: the bit-parity oracle of every drill."""
    host, pipe = _pipe(executor="sync")
    stats = _run(pipe, _batches())
    jhost = JHost(ROWS, DIM, seed=1)
    jpipe = JPipe(jhost, SLOTS, _j_train_fn)
    js = JStream(iter([(b, {}) for b in _batches()]))
    jstats = jpipe.run(js, lookahead_fn=js.peek_ids)
    jpipe.flush_to_host()
    assert _losses(stats) == _losses(jstats)
    np.testing.assert_array_equal(host.data, jhost.data)
    assert sum(s.n_evict for s in stats) > 0
    return _losses(stats), host.data.copy()


# --------------------------------------------------------------------------- #
# the plan language
# --------------------------------------------------------------------------- #
def test_plan_parse_roundtrip():
    spec = "kill-gather@3;stall-d2h@12:0.2;corrupt-row@13:5;nan-loss@9"
    plan = ChaosPlan.parse(spec)
    assert plan.spec == spec == JPlan.parse(spec).spec
    assert [e.action for e in plan.events] == ["kill", "stall", "corrupt", "nan"]
    assert plan.events[1].arg == 0.2 and plan.events[2].arg == 5.0


@pytest.mark.parametrize("bad", [
    "explode-gather@3",  # unknown action
    "kill-nowhere@3",  # unknown point
    "corrupt-gather@3",  # corrupt must target 'row'
    "nan-gather@3",  # nan must target 'loss'
    "kill-gather",  # no @cycle
])
def test_plan_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        ChaosPlan.parse(bad)
    with pytest.raises(ValueError):  # as the reference does
        JPlan.parse(bad)


def test_plan_random_is_deterministic():
    a, b = ChaosPlan.random(5), ChaosPlan.random(5)
    assert a.spec == b.spec == JPlan.random(5).spec and len(a.events) == 3
    assert ChaosPlan.random(6).spec != a.spec
    for e in a.events:
        assert e.action in ("kill", "fail", "stall")


# --------------------------------------------------------------------------- #
# inline recovery under the supervised overlapped executor
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("planner", ["host", "device"])
def test_worker_kill_recovered_inline_bit_parity(reference, planner):
    """Killed gather/writeback/d2h workers are recomputed inline in
    submission order: losses and the final host table equal the oracle."""
    ref_losses, ref_host = reference
    m, tr = MetricsRegistry(), Tracer()
    host, pipe = _pipe(planner=planner, metrics=m, tracer=tr)
    inj = ChaosInjector(ChaosPlan.parse("kill-gather@3;fail-writeback@5;kill-d2h@4"),
                        seed=0, metrics=m).attach(pipe)
    stats = _run(pipe, _batches())
    pipe.close()
    assert len(inj.fired) == 3
    assert pipe._sv.failures >= 3 and pipe._sv.retries >= 3
    assert not pipe._sv.degraded and pipe.executor == "overlapped"
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host.data, ref_host)
    assert m.counter("chaos.injected").value == 3
    assert m.counter("ft.inline_recoveries").value >= 3
    assert ("MainThread", "ft.recover") in tr.totals()


def test_failed_writeback_replays_the_gather_running_behind_it():
    """A write-back that fails frees the ordered worker for the next gather
    at once. When the main thread finds the failure, that gather may still
    be RUNNING, reading the host rows without the write-back: recovery
    waits for it, then recomputes it after the replayed write-back, so the
    gather returns the written rows (the sync order). Keeping the running
    gather's result would feed stale rows into the scratchpad (on the card
    the worker is fast enough to be inside that gather: ``chip_smoke.py``
    phase 8b's fp16 drill, ``fail-writeback@5``, shows it)."""
    import threading
    import time

    host, pipe = _pipe()
    rows = np.array([3, 5])
    new = np.full((2, DIM), 7.0, np.float32)
    calls, read = [], threading.Event()

    def write_back(ids, values):  # fails once, like fail-writeback@1
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.3)  # the gather is queued behind it by then
            raise ChaosError("injected op failure: fail-writeback@1")
        host.scatter(ids, values)

    def gather(ids):
        out = host.gather(ids).copy()
        read.set()
        time.sleep(1.0)  # still running when the failure is found
        return out

    pipe._submit_host(write_back, rows, new)
    g = pipe._submit_host(gather, rows)
    assert read.wait(10) and g.future.running()
    np.testing.assert_array_equal(pipe._op_result(g), new)
    pipe.close()
    assert len(calls) == 2 and pipe._sv.failures >= 1


def test_repeated_faults_degrade_to_sync(reference):
    """Past degrade_after incidents the runtime abandons its pools and runs
    sync for the rest of the run — same output, overlap sacrificed."""
    ref_losses, ref_host = reference
    host, pipe = _pipe(policy=SupervisePolicy(backoff=0.0, degrade_after=2))
    # two kills in clearly separate cycles: a burst within one ordered
    # replay counts as ONE incident
    inj = ChaosInjector(ChaosPlan.parse("kill-gather@2;kill-gather@10"), seed=0).attach(pipe)
    stats = _run(pipe, _batches())
    pipe.close()
    assert pipe._sv.incidents >= 2 and pipe._sv.degraded
    assert pipe.executor == "sync"
    assert pipe._host_pool is None and pipe._d2h_pool is None
    assert len(inj.fired) == 2
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host.data, ref_host)


def test_degrade_with_the_device_planner(reference):
    """Degrading mid-run with the device planner: later plans materialize
    on the calling thread, victims copy back synchronously (the sync path
    is unsupervised, as in the reference: a fault injected there raises)."""
    ref_losses, ref_host = reference
    host, pipe = _pipe(planner="device", policy=SupervisePolicy(backoff=0.0,
                                                                degrade_after=1))
    ChaosInjector(ChaosPlan.parse("fail-gather@3"), seed=0).attach(pipe)
    stats = _run(pipe, _batches())
    pipe.close()
    assert pipe._sv.degraded and pipe.executor == "sync"
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host.data, ref_host)


@pytest.mark.parametrize("point", ["gather", "d2h"])
def test_stall_trips_op_timeout_and_recovers(reference, point):
    ref_losses, ref_host = reference
    host, pipe = _pipe(policy=SupervisePolicy(op_timeout=0.05, backoff=0.0))
    ChaosInjector(ChaosPlan.parse(f"stall-{point}@3:0.5"), seed=0).attach(pipe)
    stats = _run(pipe, _batches())
    pipe.close()
    assert pipe._sv.timeouts >= 1
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host.data, ref_host)


# --------------------------------------------------------------------------- #
# corruption + NaN: supervisor restore drills
# --------------------------------------------------------------------------- #
def _supervised_run(tmp_path, spec, *, verify_every=0, nan_policy="restore",
                    steps=STEPS, rearm=False):
    """The supervisor over chaos-armed runtimes: the first incarnation only
    (the reference's drills), or, with ``rearm``, every incarnation until
    each event has fired (the launcher's ``--chaos``)."""
    batches = _batches(steps)
    first = [True]
    injectors = []

    def runtime_factory():
        host, pipe = _pipe()
        if spec and (first[0] or rearm and not all(e.fired for e in injectors[0].plan.events)):
            if not injectors:
                injectors.append(ChaosInjector(ChaosPlan.parse(spec), seed=3))
            injectors[0].attach(pipe)
        first[0] = False
        return pipe, None

    def stream_factory(skip):
        return LookaheadStream(iter([(b, {}) for b in batches[skip:]]))

    sup = EmbeddingTrainSupervisor(
        CheckpointManager(str(tmp_path), durable=False), runtime_factory, stream_factory,
        ckpt_every=4, verify_every=verify_every, nan_policy=nan_policy,
        blocking_saves=True)
    stats, report = sup.run(steps)
    sup.runtime.flush_to_host()
    host_data = sup.runtime.host.data.copy()
    sup.runtime.close()
    return stats, report, host_data, injectors


def test_row_corruption_detected_and_recovered(tmp_path, reference):
    ref_losses, ref_host = reference
    stats, report, host_data, injectors = _supervised_run(
        tmp_path, "corrupt-row@6:4", verify_every=1)
    assert injectors[0].corrupted, "no rows were flipped"
    assert report.restarts >= 1
    assert report.checkpoints >= 1 and report.restore_ms
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host_data, ref_host)


def test_verify_waits_for_the_write_back(tmp_path, monkeypatch, reference):
    """The checksum audit quiesces the overlapped worker first: a write-back
    whose rows have landed but whose checksums have not must not read as
    corruption (it would restart the run for nothing)."""
    import time

    ref_losses, ref_host = reference

    def slow_scatter(self, ids, values):
        self.traffic.written += ids.size * self.row_bytes
        self.data[ids] = values
        time.sleep(0.02)  # the rows land; their checksums a moment later
        self.reguard(ids)

    monkeypatch.setattr(HostEmbeddingTable, "scatter", slow_scatter)
    batches = _batches()

    def runtime_factory():
        host, pipe = _pipe()
        host.enable_guard()
        return pipe, None

    sup = EmbeddingTrainSupervisor(
        CheckpointManager(str(tmp_path), durable=False), runtime_factory,
        lambda skip: LookaheadStream(iter([(b, {}) for b in batches[skip:]])),
        ckpt_every=4, verify_every=1, blocking_saves=True)
    stats, report = sup.run(STEPS)
    sup.runtime.flush_to_host()
    sup.runtime.close()
    assert report.restarts == 0, report.causes
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(sup.runtime.host.data, ref_host)


def test_no_checkpoint_captures_a_corrupted_row(tmp_path, reference):
    """Rows flipped just before a save, with the periodic audit too rare to
    see them: the audit before the save catches them, so the restore loads
    clean rows (a checkpoint of corrupted rows would reload them with fresh
    checksums, past detection)."""
    ref_losses, ref_host = reference
    stats, report, host_data, injectors = _supervised_run(
        tmp_path, "corrupt-row@6:4", verify_every=1000)
    assert injectors[0].corrupted and report.restarts == 1, report.causes
    assert "RowCorruptionError" in report.causes[0]
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host_data, ref_host)


def test_corruption_raises_on_verify():
    host = HostEmbeddingTable(ROWS, DIM, seed=1)
    host.enable_guard()
    raw = host.data.view(np.uint8).reshape(-1)
    raw[DIM * 4 * 1 + 1] ^= 0xFF  # one byte of row 1, behind the API's back
    with pytest.raises(RowCorruptionError) as ei:
        host.verify()
    assert 1 in ei.value.rows


def test_nan_loss_quarantined_by_restore(tmp_path, reference):
    """nan-loss fires AFTER the embedding update lands — only a checkpoint
    restore can excise it, and does, to bit-parity."""
    ref_losses, ref_host = reference
    stats, report, host_data, injectors = _supervised_run(tmp_path, "nan-loss@6")
    assert [e.spec for e in injectors[0].fired] == ["nan-loss@6"]
    assert report.nan_steps_skipped >= 1 and report.restarts >= 1
    assert _losses(stats) == ref_losses
    assert all(np.isfinite(_losses(stats)))
    np.testing.assert_array_equal(host_data, ref_host)


def test_full_drill_in_one_run(tmp_path):
    """The chip drill's mix on a 30-batch stream: three inline recoveries
    (the kills land before the first restore) and two restores in one
    supervised run, equal to the sync oracle of both packages."""
    host, pipe = _pipe(executor="sync")
    ref_losses = _losses(_run(pipe, _batches(30)))
    ref_host = host.data.copy()
    jhost = JHost(ROWS, DIM, seed=1)
    jpipe = JPipe(jhost, SLOTS, _j_train_fn)
    js = JStream(iter([(b, {}) for b in _batches(30)]))
    assert _losses(jpipe.run(js, lookahead_fn=js.peek_ids)) == ref_losses
    jpipe.flush_to_host()
    np.testing.assert_array_equal(jhost.data, ref_host)
    stats, report, host_data, injectors = _supervised_run(
        tmp_path, "kill-gather@3;fail-writeback@5;kill-d2h@4;nan-loss@18;corrupt-row@24:3",
        verify_every=2, steps=30, rearm=True)
    assert len(injectors[0].fired) == 5 and report.restarts == 2
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host_data, ref_host)


def test_supervised_uninjected_matches_plain_run(tmp_path, reference):
    ref_losses, ref_host = reference
    stats, report, host_data, _ = _supervised_run(tmp_path, "")
    assert report.restarts == 0 and report.checkpoints >= 2
    assert _losses(stats) == ref_losses
    np.testing.assert_array_equal(host_data, ref_host)


def test_injected_faults_raise_without_supervision():
    """Unsupervised, an injected fault surfaces instead of being absorbed —
    under both executors."""
    for executor in ("sync", "overlapped"):
        host = HostEmbeddingTable(ROWS, DIM, seed=1)
        pipe = ScratchPipe(host, SLOTS, _train_fn, executor=executor, device="cpu")
        ChaosInjector(ChaosPlan.parse("kill-gather@2"), seed=0).attach(pipe)
        with pytest.raises(InjectedWorkerDeath):
            for b in _batches(4):
                pipe.run_one_cycle(b, {})
            while pipe._window:
                pipe.drain_one_cycle()
        pipe._pending.clear()
        pipe.close()


def test_chaos_error_is_transient_op_error():
    assert issubclass(ChaosError, TransientOpError)
    assert issubclass(InjectedWorkerDeath, ChaosError)


def test_attach_server_is_item_12():
    """Item 12's serving half is ported: attach_server arms the server's
    fetch hook and its plan clock (tests/test_torch_serving_recovery.py
    drives the faults)."""
    srv = ReadOnlyCacheServer(HostEmbeddingTable(ROWS, DIM, seed=1), SLOTS, device="cpu")
    fetch, plan = srv._fetch_gather, srv.planner.plan
    inj = ChaosInjector(ChaosPlan.parse("kill-fetch@2"))
    assert inj.attach_server(srv) is inj
    assert srv._fetch_gather is not fetch and srv._fetch_gather.__name__ == "chaos_fetch"
    assert srv.planner.plan is not plan and srv.planner.plan.__name__ == "chaos_plan"
    srv._fetch_gather(np.arange(3))
    with pytest.raises(InjectedWorkerDeath):
        srv._fetch_gather(np.arange(3))


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def _launch(module, argv, capsys, monkeypatch):
    """One launcher run in-process (the reference's ``main`` reads
    ``sys.argv``); returns what it printed."""
    argv = ["--arch", "dlrm-scratchpipe", "--smoke", *argv]
    if module == "repro_torch.launch.train":
        tlaunch.main(argv)
    else:
        from repro.launch import train as jlaunch

        monkeypatch.setattr("sys.argv", ["train", *argv])
        jlaunch.main()
    return capsys.readouterr().out


def _figures(out):
    done = re.search(r"done: steps=(\d+) loss \S+ plan_hit=(\S+)", out).groups()
    traffic = re.search(r"^traffic: .*$", out, re.M).group(0)
    digest = re.search(r"state_digest=(\w+)", out)
    return done, traffic, digest.group(1) if digest else None


@pytest.mark.parametrize("chaos,executor", [
    ("kill-gather@3;kill-d2h@4;fail-gather@6", "overlapped"),
    ("nan-loss@9;corrupt-row@11:5", "sync"),
])
def test_launcher_chaos_run(tmp_path, capsys, monkeypatch, chaos, executor):
    common = ["--steps", "16", "--ckpt-every", "4", "--verify-every", "2",
              "--executor", executor]
    clean = _figures(_launch("repro_torch.launch.train",
                             [*common, "--device", "cpu", "--supervise", "--ckpt-dir",
                              str(tmp_path / "clean")], capsys, monkeypatch))
    out = _launch("repro_torch.launch.train",
                  [*common, "--device", "cpu", "--chaos", chaos, "--ckpt-dir",
                   str(tmp_path / "chaos")], capsys, monkeypatch)
    got = _figures(out)
    fired = re.search(r"chaos_fired=(\[.*\])", out).group(1)
    assert fired != "[]"
    assert got[2] == clean[2]  # state_digest: bitwise equal to the clean run
    # the reference launcher's clean supervised run: the same done:/traffic:
    ref = _figures(_launch("repro.launch.train",
                           [*common, "--supervise", "--ckpt-dir", str(tmp_path / "ref")],
                           capsys, monkeypatch))
    assert got[:2] == ref[:2] == clean[:2]
    # and its chaos run fires the same events (no restore: no race on its
    # unsynchronized checkpoint reads)
    if "nan" not in chaos:
        jout = _launch("repro.launch.train",
                       [*common, "--chaos", chaos, "--ckpt-dir", str(tmp_path / "refc")],
                       capsys, monkeypatch)
        assert re.search(r"chaos_fired=(\[.*\])", jout).group(1) == fired
        assert _figures(jout)[:2] == got[:2]


@pytest.mark.parametrize("argv", [
    ["--supervise", "--runtime", "nocache"],
    ["--chaos", "kill-gather@3", "--runtime", "static"],
    ["--supervise", "--record-trace", "x"],
    ["--chaos", "explode-gather@3"],
])
def test_launcher_rejects_what_the_reference_rejects(argv):
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--device", "cpu", *argv])
