"""The port's DLRM training fast path on the CPU: ``ScratchPipe`` with the
device-resident planner (``planner="device"``), the overlapped executor
(``executor="overlapped"``) and both together.

At the smoke config cut to a scratchpad smaller than the table (16,384 rows,
2,400 resident rows: a nominal budget of 2,400 fp32 rows, 1,200 at fp16,
600 at int8), so every cycle reads victims, copies them back and writes
them to the host — through the worker threads under ``overlapped``:

  * for ``scratchpipe`` split and fused and for ``strawman``, at fp32, fp16
    and int8 (``nearest`` rounding), each option against the reference's
    run with the same options (``repro.core.pipeline``, ``kernel="xla"``):
    StepStats and every traffic byte counter IDENTICAL; losses within rtol
    1e-5 (fp32) / 1e-4 (fp16/int8) and the flushed host table within atol
    1e-6 (fp32) / one quantization step (fp16/int8), the tolerances of
    tests/test_torch_train.py and tests/test_torch_precision.py;
  * within the port, every planner x executor combination gives losses and
    flushed host tables BITWISE equal to the host/sync run, at both
    roundings;
  * under ``overlapped`` every plain-version kernel call happens on the main
    thread; ``close()`` is idempotent and leaves no worker thread alive; an
    exception raised in the gather worker surfaces from ``run``;
  * the launcher with ``--planner device --executor overlapped [--fused]``
    prints the ``done:`` and ``traffic:`` figures of ``--planner host``.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest

from repro.configs import dlrm_scratchpipe as jcfgs
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.data import lookahead as jla
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs import dlrm_scratchpipe as tcfgs
from repro_torch.core import quantize as tqz
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.plan_device import DevicePlanner
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.data import lookahead as tla
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch

SEED, LR, STEPS, ROWS_PER_TABLE, SLOTS = 0, 0.05, 12, 4096, 2400
LOSS_RTOL = {"fp32": 1e-5, "fp16": 1e-4, "int8": 1e-4}
TABLE_ATOL = 1e-6  # fp32; fp16/int8: one quantization step per element
DESIGNS = [("scratchpipe", False), ("scratchpipe", True), ("strawman", False)]
#: (planner, executor) of the fast path
OPTIONS = [("device", "sync"), ("host", "overlapped"), ("device", "overlapped")]


def _cfg(cfgs, precision, rounding):
    return dataclasses.replace(cfgs.smoke_config(), rows_per_table=ROWS_PER_TABLE,
                               precision=precision, rounding=rounding)


def _run(package, design, fused, precision, planner, executor, rounding="nearest",
         mlps=None, pipe_hook=None):
    """One 12-step run through ``package`` ("ref" or "port", on the CPU).
    Returns (stats, traffic, flushed host table, the MLP init)."""
    ref = package == "ref"
    cfg = _cfg(jcfgs if ref else tcfgs, precision, rounding)
    host = (JHost if ref else THost)(cfg.total_rows, cfg.embed_dim, seed=SEED)
    if ref:
        trainer = JTrainer(cfg, jax.random.key(SEED), lr=LR)
        mlps = jax.tree.map(lambda a: np.array(a, copy=True), trainer.mlps)
        make, syn, la, kw = j_make_runtime, jsyn, jla, {}
    else:
        trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
        trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
        make, syn, la, kw = t_make_runtime, tsyn, tla, {"device": "cpu"}
    kw.update(num_slots=SLOTS // tqz.SLOT_MULTIPLIER[precision], precision=precision,
              planner=planner, executor=executor)
    if design == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    if fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    pipe = make(design, host, trainer.train_fn, **kw)
    try:
        if pipe_hook is not None:
            pipe_hook(pipe)
        tc = syn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                             lookups_per_table=cfg.lookups_per_table,
                             batch_size=cfg.batch_size, seed=SEED)
        stream = la.LookaheadStream(syn.dlrm_batches(tc, STEPS))
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        traffic = {k: dataclasses.asdict(v) for k, v in pipe.traffic().items()}
    finally:
        pipe.close()
    return stats, traffic, host.data.copy(), mlps


def _plain_stats(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in ("aux", "stage_times")}
            for s in stats]


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats])


def _assert_table_close(got, want, precision):
    if precision == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=TABLE_ATOL)
        return
    if precision == "int8":
        step = np.abs(want).max(axis=1, keepdims=True) / 127.0 * (1 + 2.0 ** -16)
    else:
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    diff = np.abs(got - want)
    assert (diff <= step).all(), (diff.max(), int((diff > step).sum()))


def _reference_mlps():
    """The reference trainer's MLP init at SEED, as numpy arrays."""
    mlps = JTrainer(jcfgs.smoke_config(), jax.random.key(SEED), lr=LR).mlps
    return jax.tree.map(lambda a: np.array(a, copy=True), mlps)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


@pytest.mark.parametrize("planner,executor", OPTIONS)
@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
@pytest.mark.parametrize("design,fused", DESIGNS)
def test_fast_path_matches_reference(design, fused, precision, planner, executor):
    j_stats, j_traffic, j_table, mlps = _run("ref", design, fused, precision, planner,
                                             executor)
    t_stats, t_traffic, t_table, _ = _run("port", design, fused, precision, planner,
                                          executor, mlps=mlps)
    assert len(t_stats) == STEPS
    assert sum(s.n_evict for s in t_stats) > 500
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    assert t_traffic == j_traffic
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL[precision])
    _assert_table_close(t_table, j_table, precision)


@pytest.mark.parametrize("precision,rounding", [("fp32", "nearest"), ("fp16", "nearest"),
                                                ("fp16", "stochastic"), ("int8", "nearest"),
                                                ("int8", "stochastic")])
@pytest.mark.parametrize("design,fused", DESIGNS)
def test_fast_path_bitwise_equal_to_host_sync(design, fused, precision, rounding):
    mlps = _reference_mlps()
    base = _run("port", design, fused, precision, "host", "sync", rounding, mlps)
    assert sum(s.n_evict for s in base[0]) > 0
    assert np.isfinite(_losses(base[0])).all()
    for planner, executor in OPTIONS:
        got = _run("port", design, fused, precision, planner, executor, rounding, mlps)
        assert _plain_stats(got[0]) == _plain_stats(base[0]), (planner, executor)
        assert got[1] == base[1], (planner, executor)
        np.testing.assert_array_equal(_losses(got[0]), _losses(base[0]),
                                      err_msg=f"{planner}/{executor}")
        np.testing.assert_array_equal(got[2], base[2], err_msg=f"{planner}/{executor}")


_PLAIN = ("gather_reduce_ref", "fill_ref", "fill_gather_reduce_ref", "scatter_add_ref",
          "gather_reduce_q_ref", "fill_gather_reduce_q_ref")


@pytest.mark.parametrize("precision,fused", [("fp32", False), ("fp16", True), ("int8", True)])
def test_overlapped_runs_every_kernel_call_on_the_main_thread(monkeypatch, precision, fused):
    """The plain versions are what the kernel wrappers call for CPU tensors:
    each call is recorded with its thread; the workers must make none."""
    threads = []
    for name in _PLAIN:
        real = getattr(tref, name)

        def spy(*a, _real=real, _name=name, **k):
            threads.append((_name, threading.current_thread()))
            return _real(*a, **k)

        monkeypatch.setattr(tref, name, spy)
    workers = []
    stats = _run("port", "scratchpipe", fused, precision, "device", "overlapped",
                 mlps=_reference_mlps(),
                 pipe_hook=lambda p: workers.append((p._host_pool, p._d2h_pool)))[0]
    assert sum(s.n_evict for s in stats) > 0 and all(workers[0])
    names = {n for n, _ in threads}
    assert "scatter_add_ref" in names and len(threads) >= 2 * STEPS
    off = [(n, t.name) for n, t in threads if t is not threading.main_thread()]
    assert not off


def test_close_is_idempotent_and_stops_the_workers():
    pools = []

    def hook(pipe):
        assert isinstance(pipe.planner, DevicePlanner)
        pools.append(pipe)

    _run("port", "scratchpipe", False, "fp32", "device", "overlapped",
         mlps=_reference_mlps(), pipe_hook=hook)
    pipe = pools[0]
    assert pipe._host_pool is None and pipe._d2h_pool is None  # _run closed it
    pipe.close()  # again: a no-op
    cfg = _cfg(tcfgs, "fp32", "nearest")
    host = THost(cfg.total_rows, cfg.embed_dim, seed=SEED)
    trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
    pipe = t_make_runtime("scratchpipe", host, trainer.train_fn, num_slots=SLOTS,
                          executor="overlapped", device="cpu")
    stream = tla.LookaheadStream(tsyn.dlrm_batches(
        tsyn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                         lookups_per_table=cfg.lookups_per_table,
                         batch_size=cfg.batch_size, seed=SEED), 3))
    pipe.run(stream, lookahead_fn=stream.peek_ids)
    workers = list(pipe._host_pool._threads) + list(pipe._d2h_pool._threads)
    assert workers and all(t.is_alive() for t in workers)
    pipe.close()
    pipe.close()
    for t in workers:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in workers)
    pipe.close()  # a sync runtime's close is a no-op too
    t_make_runtime("strawman", host, trainer.train_fn, num_slots=SLOTS, device="cpu").close()


@pytest.mark.parametrize("planner", ["host", "device"])
def test_a_gather_worker_exception_surfaces_from_run(planner):
    calls = []

    def hook(pipe):
        real = pipe._gather_fn

        def boom(ids):
            calls.append(threading.current_thread())
            if len(calls) == 4:
                raise RuntimeError("gather failed on the worker")
            return real(ids)

        pipe._gather_fn = boom

    with pytest.raises(RuntimeError, match="gather failed on the worker"):
        _run("port", "scratchpipe", False, "fp32", planner, "overlapped",
             mlps=_reference_mlps(), pipe_hook=hook)
    assert len(calls) >= 4 and all(t is not threading.main_thread() for t in calls)


def _figures(out: str):
    lines = out.splitlines()
    done = next(ln for ln in lines if ln.startswith("done: ")).split()
    traffic = next(ln for ln in lines if ln.startswith("traffic: "))
    return [w for w in done if not w.endswith("ms/step")], traffic


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--precision", "int8", "--fused"],
                                   ["--runtime", "strawman"]])
def test_launcher_fast_path_prints_the_host_planners_figures(extra, capsys):
    argv = ["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "10", "--device", "cpu"] + extra
    figures = []
    for flags in ([], ["--planner", "device", "--executor", "overlapped"]):
        res = tlaunch.main(argv + flags)
        res["pipe"].close()
        figures.append(_figures(capsys.readouterr().out))
    assert figures[0] == figures[1]
