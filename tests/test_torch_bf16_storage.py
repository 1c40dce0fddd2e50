"""The fp32 path's bf16 scratchpad (``storage_dtype=torch.bfloat16``) of the
port on the CPU, against the JAX package's (``storage_dtype=jnp.bfloat16``).

  * the plain versions of the four kernels' bf16 forms — ``gather_reduce``
    (bf16 bags), ``fill`` (fp32 rows rounded into bf16 slots),
    ``fill_gather_reduce`` and ``coalesce_apply`` (each add rounded to bf16)
    — against the reference's ``kernels/ref.py`` on the sweep of its
    tests/test_kernels.py, with drop sentinels, duplicates within and across
    bags, special values and empty operands: BITWISE;
  * the update itself: ``scratchpad.apply_grad`` on a bf16 storage given the
    reference's own bf16 bag gradient of a DLRM step, bitwise against the
    reference's ``apply_grad``; the port's [Train] hands it a bf16 gradient,
    as the reference's does;
  * ``ScratchPipe(storage_dtype=)`` on the smoke config, split, fused,
    ``planner="device"`` and ``executor="overlapped"``: planner state and
    StepStats IDENTICAL to the reference's, losses within rtol 1e-5 and the
    scratchpad and flushed host table within atol 1e-6 (the fp32 parity
    tests' bounds, tests/test_torch_fastpath.py); within the port split and
    fused, host/sync and device/overlapped bitwise equal;
  * ``ReadOnlyCacheServer(storage_dtype=)``: bags bitwise the reference's
    (which are bf16 on its host; the port returns their fp32 widening);
  * the options' errors, a ``state_arrays`` round trip mid-window, the
    reference's snapshot loaded, and the same constructor's ``policy=``,
    ``memoize_plan=`` and ``record_stage_times=`` against the reference.

A jax bf16 array reaches torch only through its 16 bits (an int16 view), and
comes back the same way. The kernels themselves are held against these
plain versions on the card by tests/test_torch_cuda_bf16.py.
"""
from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_scratchpipe as jcfgs
from repro.core import scratchpad as jsp
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.data import lookahead as jla
from repro.data import synthetic as jsyn
from repro.kernels import ref as jref
from repro.models import dlrm as jdlrm
from repro.serving import replay_serving as j_replay
from repro.traces import scenarios as jsc
from repro.core.table_group import TableGroup as JGroup
from repro_torch import convert
from repro_torch.configs import dlrm_scratchpipe as tcfgs
from repro_torch.core import dlrm_runtime as tdr
from repro_torch.core import scratchpad as tsp
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.pipeline import ScratchPipe as TPipe
from repro_torch.core.plan_device import DevicePlanner
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.data import lookahead as tla
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving import replay_serving as t_replay

RNG = np.random.default_rng(0)
SEED, LR, STEPS, SLOTS = 0, 0.05, 12, 1024
LOSS_RTOL, TABLE_ATOL = 1e-5, 1e-6  # tests/test_torch_fastpath.py's fp32 bounds
#: (fused, planner, executor): split, fused, the device planner, the overlapped executor
MODES = [(False, "host", "sync"), (True, "host", "sync"), (False, "device", "sync"),
         (False, "host", "overlapped")]


# --------------------------------------------------------------------------- #
# jax <-> torch through the 16 bits
# --------------------------------------------------------------------------- #
def to_torch(a) -> torch.Tensor:
    """A jax or numpy array -> a torch tensor of its dtype (bf16 by its bits)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """A bf16 tensor or array -> its uint16 bits; anything else as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def assert_bitwise(got, want, msg=""):
    g, w = bits(got), bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (msg, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def bf16_storage(N, D):
    return jnp.asarray(RNG.standard_normal((N, D)), dtype=jnp.bfloat16)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# --------------------------------------------------------------------------- #
# the plain versions of the four bf16 forms, bitwise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("N,D", [(32, 128), (64, 256), (16, 384), (24, 8), (24, 40),
                                 (24, 192)])
@pytest.mark.parametrize("shape", [(4, 5), (2, 3, 7), (1, 1)])
def test_bf16_gather_reduce_bitwise(N, D, shape):
    st = bf16_storage(N, D)
    ids = jnp.asarray(RNG.integers(0, N, shape + (5,)), jnp.int32)
    got = tops.gather_reduce(to_torch(st), to_torch(ids))
    assert got.dtype == torch.bfloat16
    assert_bitwise(got, jref.gather_reduce_ref(st, ids))


@pytest.mark.parametrize("shape", [(0, 5), (3, 0), (0, 0)])
def test_bf16_gather_reduce_duplicates_and_empty(shape):
    st = bf16_storage(16, 128)
    ids = jnp.asarray([[3, 3, 3, 5], [5, 3, 5, 3], [0, 0, 0, 0]], jnp.int32)
    assert_bitwise(tops.gather_reduce(to_torch(st), to_torch(ids)),
                   jref.gather_reduce_ref(st, ids))
    empty = jnp.zeros(shape, jnp.int32)
    assert_bitwise(tops.gather_reduce(to_torch(st), to_torch(empty)),
                   jref.gather_reduce_ref(st, empty))


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,nb,L", [(16, 128, 8, 4), (64, 256, 12, 7), (24, 8, 5, 3),
                                      (24, 40, 5, 3), (24, 192, 5, 3)])
def test_bf16_coalesce_apply_bitwise(N, D, nb, L, grad_dtype):
    """Heavy duplication: many bags update one slot, each add rounded to
    bf16 in flat bag-major order. fp32 gradients are the reference's own
    sweep; bf16 ones are what the training step hands the update (its
    ``lr`` is then rounded to bf16 first, as jnp's weak typing does)."""
    st = bf16_storage(N, D)
    ids = jnp.asarray(RNG.integers(0, max(2, N // 4), (nb, L)), jnp.int32)
    g = jnp.asarray(RNG.standard_normal((nb, D)).astype(np.float32), dtype=grad_dtype)
    want = jref.coalesce_apply_ref(st, ids, g, 0.07)
    got = tops.coalesce_apply(to_torch(st), to_torch(ids), to_torch(g), 0.07)
    assert_bitwise(got, want)


def test_bf16_scatter_rounds_every_add():
    """A row of 1.0 and 1000 adds of 2^-9 (below half a bf16 step of 1.0):
    rounded add by add the row stays 1.0, as the reference's does; summed
    in fp32 and rounded once it would be ~2.95."""
    st = jnp.ones((4, 8), jnp.bfloat16)
    ids = jnp.zeros((1000, 1), jnp.int32)
    g = jnp.full((1000, 8), -(2.0 ** -9) / 0.5, jnp.bfloat16)
    want = jref.coalesce_apply_ref(st, ids, g, 0.5)
    got = tops.coalesce_apply(to_torch(st), to_torch(ids), to_torch(g), 0.5)
    assert_bitwise(got, want)
    assert float(got[0, 0]) == 1.0


def test_bf16_coalesce_apply_empty_operands():
    st = bf16_storage(8, 128)
    got = tops.coalesce_apply(to_torch(st), torch.zeros((0, 4), dtype=torch.int32),
                              torch.zeros((0, 128), dtype=torch.bfloat16), 0.05)
    assert_bitwise(got, st)


@pytest.mark.parametrize("D", [128, 40, 12])
def test_bf16_fill_drop_sentinel_and_special_values(D):
    """fp32 rows rounded into bf16 slots (nearest even): ties both ways,
    +-0, +-inf, fp32 subnormals and values past bf16's largest; slots == N
    dropped. A NaN stays a NaN: its bits are each framework's own (jnp's
    0x7FC0, torch's 0xFFFF on the CPU, the card's 0x7FFF), so it is held
    apart."""
    N, F = 32, 6
    st = bf16_storage(N, D)
    slots = jnp.asarray([1, 5, N, 9, N, 2], jnp.int32)
    rows = RNG.standard_normal((F, D)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                        1e-40, -1e-45, 3.4e38, np.nan], np.float32)
    rows[0, :special.size] = special
    rows = jnp.asarray(rows)
    got = bits(tops.fill(to_torch(st), to_torch(slots), to_torch(rows))).copy()
    want = bits(jref.fill_ref(st, slots, rows)).copy()
    nan = (1, special.size - 1)  # slot 1 took row 0
    assert (got[nan] & 0x7F80) == (want[nan] & 0x7F80) == 0x7F80
    assert got[nan] & 0x7F and want[nan] & 0x7F
    got[nan] = want[nan] = 0
    np.testing.assert_array_equal(got, want)
    empty = tops.fill(to_torch(st), torch.zeros((0,), dtype=torch.int32),
                      torch.zeros((0, D), dtype=torch.float32))
    assert_bitwise(empty, st)


@pytest.mark.parametrize("D", [128, 40, 192])
def test_bf16_fill_gather_reduce_bitwise(D):
    """The fill lands before the gather: bags that read just-filled slots
    see the rounded rows."""
    N, F, nb, L = 48, 7, 9, 5
    st = bf16_storage(N, D)
    fill_slots = jnp.asarray(list(RNG.permutation(N)[: F - 1]) + [N], jnp.int32)
    rows = jnp.asarray(RNG.standard_normal((F, D)).astype(np.float32))
    ids = jnp.asarray(RNG.integers(0, N, (nb, L)), jnp.int32)
    ids = ids.at[0, :3].set(fill_slots[0])
    st_r, bags_r = jref.fill_gather_reduce_ref(st, fill_slots, rows, ids)
    st_p, bags_p = tops.fill_gather_reduce(to_torch(st), to_torch(fill_slots),
                                           to_torch(rows), to_torch(ids))
    assert_bitwise(st_p, st_r, "storage")
    assert_bitwise(bags_p, bags_r, "bags")


# --------------------------------------------------------------------------- #
# the update, given the reference's own bag gradient
# --------------------------------------------------------------------------- #
def _one_batch(cfg):
    tc = jsyn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                          lookups_per_table=cfg.lookups_per_table,
                          batch_size=cfg.batch_size, seed=SEED)
    return next(iter(jsyn.dlrm_batches(tc, 1)))


def test_bf16_apply_grad_bitwise_given_the_reference_gradient():
    cfg = jcfgs.smoke_config()
    ids, batch = _one_batch(cfg)
    slots = jnp.asarray(np.asarray(ids) % 600, jnp.int32)  # resident slots of 600
    st = bf16_storage(600, cfg.embed_dim)
    mlps = JTrainer(cfg, jax.random.key(SEED), lr=LR).mlps
    bags = jsp.gather_reduce(st, slots)

    def loss_fn(m, b):
        return jdlrm.bce_loss(jdlrm.forward_from_bags(m, batch["dense"], b), batch["label"])

    _, (_, g_bags) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(mlps, bags)
    assert bags.dtype == g_bags.dtype == jnp.bfloat16
    want = jax.jit(lambda s_, i_, g_: jsp.apply_grad(s_, i_, g_, LR))(st, slots, g_bags)
    got = tsp.apply_grad(to_torch(st), to_torch(slots), to_torch(g_bags), LR)
    assert_bitwise(got, want)


def test_bf16_train_step_hands_apply_grad_a_bf16_gradient(monkeypatch):
    seen = []
    real = tsp.apply_grad

    def spy(storage, slot_ids, bag_grads, lr):
        seen.append((storage.dtype, bag_grads.dtype))
        return real(storage, slot_ids, bag_grads, lr)

    monkeypatch.setattr(tdr.sp, "apply_grad", spy)
    cfg = tcfgs.smoke_config()
    ids, batch = _one_batch(cfg)
    trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
    st = tsp.make_storage(600, cfg.embed_dim, dtype=torch.bfloat16, device="cpu")
    trainer.train_fn(st, np.asarray(ids) % 600, batch)
    fs = np.array([3, 600, 7], np.int32)
    rows = torch.from_numpy(RNG.standard_normal((3, cfg.embed_dim)).astype(np.float32))
    trainer.fused_train_fn(st, fs, rows, np.asarray(ids) % 600, batch)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2


# --------------------------------------------------------------------------- #
# ScratchPipe(storage_dtype=) against the reference
# --------------------------------------------------------------------------- #
def _run(package, fused, planner, executor, mlps=None, steps=STEPS, pipe_kw=None,
         stop_after=None):
    """``steps`` batches through ``package``'s bf16 ScratchPipe (on the CPU).
    Returns (stats, the runtime after its flush, the flushed host table,
    the MLP init); ``stop_after`` cycles: the runtime mid-window instead."""
    ref = package == "ref"
    cfg = (jcfgs if ref else tcfgs).smoke_config()
    host = (JHost if ref else THost)(cfg.total_rows, cfg.embed_dim, seed=SEED)
    if ref:
        trainer = JTrainer(cfg, jax.random.key(SEED), lr=LR)
        mlps = jax.tree.map(lambda a: np.array(a, copy=True), trainer.mlps)
        make, syn, la = j_make_runtime, jsyn, jla
        kw = {"storage_dtype": jnp.bfloat16}
    else:
        trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
        trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
        make, syn, la = t_make_runtime, tsyn, tla
        kw = {"storage_dtype": torch.bfloat16, "device": "cpu"}
    kw.update(num_slots=SLOTS, past_window=cfg.past_window, future_window=cfg.future_window,
              planner=planner, executor=executor, **(pipe_kw or {}))
    if fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    pipe = make("scratchpipe", host, trainer.train_fn, **kw)
    tc = syn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                         lookups_per_table=cfg.lookups_per_table,
                         batch_size=cfg.batch_size, seed=SEED)
    stream = la.LookaheadStream(syn.dlrm_batches(tc, steps))
    if stop_after is not None:
        stats = [pipe.run_one_cycle(*next(stream), lookahead_fn=stream.peek_ids)
                 for _ in range(stop_after)]
        return [s for s in stats if s is not None], pipe, host, mlps, trainer, stream
    try:
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
    finally:
        pipe.close()
    return stats, pipe, host.data.copy(), mlps


def _reference_mlps():
    """The reference trainer's MLP init at SEED, as numpy arrays."""
    mlps = JTrainer(jcfgs.smoke_config(), jax.random.key(SEED), lr=LR).mlps
    return jax.tree.map(lambda a: np.array(a, copy=True), mlps)


def _plain_stats(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in ("aux", "stage_times")}
            for s in stats]


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats])


def _planner_state(pipe, package):
    arrays = pipe.state_arrays()
    if package == "ref":
        arrays = convert.pipe_state_from_reference(arrays)
    return {k: np.asarray(v) for k, v in arrays.items() if k.startswith("planner_")}


@pytest.mark.parametrize("fused,planner,executor", MODES)
def test_bf16_scratchpipe_matches_reference(fused, planner, executor):
    j_stats, j_pipe, j_table, mlps = _run("ref", fused, planner, executor)
    t_stats, t_pipe, t_table, _ = _run("port", fused, planner, executor, mlps=mlps)
    assert t_pipe.storage.dtype == torch.bfloat16 and j_pipe.storage.dtype == jnp.bfloat16
    assert len(t_stats) == STEPS and sum(s.n_evict for s in t_stats) > 0
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    jp, tp = _planner_state(j_pipe, "ref"), _planner_state(t_pipe, "port")
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert {k: dataclasses.asdict(v) for k, v in t_pipe.traffic().items()} == \
        {k: dataclasses.asdict(v) for k, v in j_pipe.traffic().items()}
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        (bits(t_pipe.storage).astype(np.uint32) << 16).view(np.float32),
        np.asarray(j_pipe.storage, dtype=np.float32), rtol=0, atol=TABLE_ATOL)
    np.testing.assert_allclose(t_table, j_table, rtol=0, atol=TABLE_ATOL)
    assert not np.array_equal(t_table, THost(*t_table.shape, seed=SEED).data)


def test_bf16_scratchpipe_bitwise_across_the_port_modes():
    mlps = _reference_mlps()
    base = _run("port", False, "host", "sync", mlps=mlps)
    for fused, planner, executor in [(True, "host", "sync"), (False, "device", "overlapped"),
                                     (True, "device", "overlapped")]:
        got = _run("port", fused, planner, executor, mlps=mlps)
        what = f"fused={fused} {planner}/{executor}"
        assert _plain_stats(got[0]) == _plain_stats(base[0]), what
        np.testing.assert_array_equal(_losses(got[0]), _losses(base[0]), err_msg=what)
        assert_bitwise(got[1].storage, base[1].storage, what)
        np.testing.assert_array_equal(got[2], base[2], err_msg=what)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_overlapped_runs_every_kernel_call_on_the_main_thread(monkeypatch, fused):
    """The plain versions are what the kernel wrappers call for CPU
    tensors: under the device planner and the overlapped executor every
    call happens on the main thread; the workers only gather, widen and
    write back."""
    threads = []
    for name in ("gather_reduce_ref", "fill_ref", "fill_gather_reduce_ref",
                 "scatter_add_ref"):
        real = getattr(tref, name)

        def spy(*a, _real=real, _name=name, **k):
            threads.append((_name, threading.current_thread()))
            return _real(*a, **k)

        monkeypatch.setattr(tref, name, spy)
    stats, pipe, _, _ = _run("port", fused, "device", "overlapped", mlps=_reference_mlps())
    assert sum(s.n_evict for s in stats) > 0 and pipe.storage.dtype == torch.bfloat16
    assert {n for n, _ in threads} >= {"scatter_add_ref"} and len(threads) >= 2 * STEPS
    assert not [(n, t.name) for n, t in threads if t is not threading.main_thread()]


def test_bf16_state_arrays_round_trip_mid_window():
    """A snapshot mid-window (bf16 scratchpad widened to fp32, the victims in
    flight too) restored into a fresh runtime continues bitwise as the
    uninterrupted run; the reference's own snapshot at that cycle (its bf16
    arrays) loads with the same scratchpad, planner and host table."""
    mlps = _reference_mlps()
    full = _run("port", False, "host", "sync", mlps=mlps)
    _, pipe, host, _, trainer, stream = _run("port", False, "host", "sync", mlps=mlps,
                                             stop_after=7)
    arrays = pipe.state_arrays()
    assert arrays["storage"].dtype == np.float32 and "window" in arrays
    cfg = tcfgs.smoke_config()
    host2 = THost(cfg.total_rows, cfg.embed_dim, seed=SEED + 1)
    pipe2 = TPipe(host2, SLOTS, trainer.train_fn, storage_dtype=torch.bfloat16, device="cpu",
                  past_window=cfg.past_window, future_window=cfg.future_window)
    pipe2.load_state_arrays(arrays)
    assert_bitwise(pipe2.storage, pipe.storage)
    rest = pipe2.run(stream, lookahead_fn=stream.peek_ids)
    pipe2.flush_to_host()
    np.testing.assert_array_equal(_losses(rest), _losses(full[0])[-len(rest):])
    np.testing.assert_array_equal(host2.data, full[2])

    _, j_pipe, _, _, _, _ = _run("ref", False, "host", "sync", stop_after=7)
    _, t_pipe, _, _, _, _ = _run("port", False, "host", "sync", mlps=mlps, stop_after=7)
    j_arrays = convert.pipe_state_from_reference(j_pipe.state_arrays())
    assert j_arrays["storage"].dtype == np.float32
    t_pipe.load_state_arrays(j_arrays)
    assert t_pipe.storage.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        (bits(t_pipe.storage).astype(np.uint32) << 16).view(np.float32),
        np.asarray(j_pipe.storage, dtype=np.float32))
    assert len(t_pipe._window) == len(j_pipe._window) > 0
    victims = 0
    for t_e, j_e in zip(t_pipe._window, j_pipe._window):  # bf16 bits -> fp32, exactly
        if j_e.evicted_dev is not None:
            victims += 1
            np.testing.assert_array_equal(t_e.evicted_dev.numpy(),
                                          np.asarray(j_e.evicted_dev, dtype=np.float32))
    assert victims > 0


# --------------------------------------------------------------------------- #
# ReadOnlyCacheServer(storage_dtype=)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("depth,num_slots", [(2, 128), (1, 40), (0, 40)])
def test_bf16_server_bags_bitwise(depth, num_slots):
    group = JGroup.uniform(2, 400, 16)
    batches = [g for g, _ in jsc.scenario_batches("flash_crowd", group, 14, batch_size=4,
                                                  lookups_per_table=3, seed=7)]
    j_srv = JServer(JHost(800, 16, seed=7), num_slots, window=2, kernel="xla",
                    storage_dtype=jnp.bfloat16)
    t_srv = TServer(THost(800, 16, seed=7), num_slots, window=2, device="cpu",
                    storage_dtype=torch.bfloat16)
    j_res = j_replay(j_srv, batches, depth=depth, collect_bags=True)
    t_res = t_replay(t_srv, batches, depth=depth, collect_bags=True)
    assert len(t_res["bags"]) == len(j_res["bags"]) == len(batches)
    for i, (a, b) in enumerate(zip(t_res["bags"], j_res["bags"])):
        assert a.dtype == np.float32 and np.asarray(b).dtype == jnp.bfloat16
        np.testing.assert_array_equal(a, np.asarray(b, dtype=np.float32),
                                      err_msg=f"bags of serve {i}")
    for a, b in zip(t_res["stats"], j_res["stats"]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert_bitwise(t_srv.storage, j_srv.storage)
    assert t_srv.state_arrays()["storage"].dtype == np.float32


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #
def test_storage_dtype_with_a_reduced_precision_raises():
    """The reference's ValueError (tests/test_precision_parity.py)."""
    host = THost(400, 16, seed=SEED)
    with pytest.raises(ValueError, match="storage_dtype"):
        TPipe(host, 64, lambda *a: None, storage_dtype=torch.bfloat16, precision="fp16",
              device="cpu")
    with pytest.raises(ValueError, match="storage_dtype"):
        TServer(host, 64, storage_dtype=torch.bfloat16, precision="int8", device="cpu")


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_storage_dtypes_raise_naming_the_roadmap_item(dtype):
    host = THost(400, 16, seed=SEED)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 26,"):
        TPipe(host, 64, lambda *a: None, storage_dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 26,"):
        TServer(host, 64, storage_dtype=dtype, device="cpu")
    assert tsp.storage_precision(tsp.make_storage(4, 8, dtype=torch.bfloat16,
                                                  device="cpu")) == "fp32"


# --------------------------------------------------------------------------- #
# policy=, memoize_plan=, record_stage_times=
# --------------------------------------------------------------------------- #
def _record_plans(pipe):
    plans = []
    real = pipe.planner.plan

    def spy(ids, lookahead):
        p = real(ids, lookahead)
        plans.append({f: np.asarray(getattr(p, f)).copy() for f in
                      ("slots", "miss_ids", "fill_slots", "evict_slots", "evict_ids")})
        return p

    pipe.planner.plan = spy
    return plans


@pytest.mark.parametrize("policy", ["lfu", "random"])
@pytest.mark.parametrize("memoize", [True, False])
def test_policy_and_memoize_match_reference(policy, memoize):
    mlps = _reference_mlps()
    runs = {}
    kw = {"policy": policy, "memoize_plan": memoize, "record_stage_times": True}
    for package in ("ref", "port"):
        _, pipe, _, _, _, stream = _run(package, False, "host", "sync", mlps=mlps,
                                        pipe_kw=kw, stop_after=0)
        assert pipe.planner.policy == policy
        plans = _record_plans(pipe)
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.close()
        runs[package] = (stats, plans)
    (j_stats, j_plans), (t_stats, t_plans) = runs["ref"], runs["port"]
    assert sum(s.n_evict for s in t_stats) > 0
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    assert len(t_plans) == len(j_plans) == STEPS
    for i, (a, b) in enumerate(zip(t_plans, j_plans)):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"step {i} {f}")
    for a, b in zip(t_stats, j_stats):
        assert a.stage_times is not None and set(a.stage_times) == set(b.stage_times)
        assert all(v >= 0 for v in a.stage_times.values())


def test_stage_times_only_when_asked_and_device_planner_takes_lru_only():
    mlps = _reference_mlps()
    stats = _run("port", True, "host", "sync", mlps=mlps, steps=8)[0]
    assert all(s.stage_times is None for s in stats)
    stats = _run("port", True, "host", "sync", mlps=mlps, steps=8,
                 pipe_kw={"record_stage_times": True})[0]
    assert set(stats[-1].stage_times) == {"plan", "collect", "exchange", "insert", "train"}
    with pytest.raises(ValueError, match="lru"):
        TPipe(THost(400, 16, seed=SEED), 64, lambda *a: None, planner="device",
              policy="lfu", device="cpu")
    assert isinstance(TPipe(THost(400, 16, seed=SEED), 64, lambda *a: None,
                            planner="device", device="cpu").planner, DevicePlanner)
