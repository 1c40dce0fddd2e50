"""The port's mixed-precision training path (``device="cpu"``) against the
JAX package's.

Inputs are made from numpy seeds and handed to both packages:

  * the kernels' plain versions ``gather_reduce_q_ref`` and
    ``fill_gather_reduce_q_ref`` (through ``kernels/ops.py``, which runs them
    for CPU tensors) are BITWISE equal to ``repro.kernels.ref`` and to the
    Pallas kernels in interpret mode, for fp16 and int8 storage, over
    D in {8, 40, 128}, L in {1, 3, 20}, duplicates within and across bags,
    drop sentinels and fills gathered in the same call;
  * the storage primitives (``make_storage``, ``fill`` with sentinels,
    ``read``, ``storage_bytes``) agree with the reference, and
    ``apply_grad_q`` and ``fill_gather_reduce_q`` at ``rounding="nearest"``,
    given the same bag gradients, are BITWISE equal to the reference's
    ``kernel="xla"`` primitives on payload, scale and bags;
  * every cache runtime that holds replicas (``scratchpipe`` split and
    fused, ``strawman``, ``static``) at fp16 and int8, ``nearest``, started
    from the reference's MLP arrays: StepStats and every traffic byte
    counter IDENTICAL to the reference's (at ``kernel="xla"``, its canonical
    definition), the loss trajectory within rtol 1e-4 (the reference's MLP
    tier; the MLPs' sums differ in order, 1e-7 relative, and a rounding
    boundary can flip one quantization step), and the flushed host table
    within one quantization step per element — also under eviction, where
    the victims' dequantized write-back is compared;
  * within the port, split and fused runs are bitwise equal, at
    ``stochastic`` too (the same noise at the same step);
  * the launcher prints the reference's ``done:`` plan_hit and ``traffic:``
    line at ``--precision int8``, and ``--runtime nocache --precision int8``
    exits with the reference's message.
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

from repro.configs import dlrm_scratchpipe as jcfgs
from repro.core import quantize as jqz
from repro.core import scratchpad as jsp
from repro.core.dlrm_runtime import DLRMTrainer as JTrainer
from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.runtime import make_runtime as j_make_runtime
from repro.core.table_group import TableGroup as JGroup
from repro.data import lookahead as jla
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.configs import dlrm_scratchpipe as tcfgs
from repro_torch.core import quantize as tqz
from repro_torch.core import scratchpad as tsp
from repro_torch.core.dlrm_runtime import DLRMTrainer as TTrainer
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.runtime import make_runtime as t_make_runtime
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.data import lookahead as tla
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(31)
SEED = 0
LR = 0.05
STEPS = 12
LOSS_RTOL = 1e-4


def assert_bitwise(out, want, msg=""):
    out, want = np.asarray(out), np.asarray(want)
    assert out.dtype == want.dtype, (msg, out.dtype, want.dtype)
    assert out.shape == want.shape, (msg, out.shape, want.shape)
    np.testing.assert_array_equal(out, want, err_msg=msg)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _qstorage(precision, N, D):
    """A reference storage of ``precision`` as numpy arrays (fp16 array, or
    an int8 (data, scale) pair) quantized from random fp32 rows, a zero row
    among them."""
    rows = (RNG.standard_normal((N, D)) * 10.0 ** RNG.integers(-2, 1, (N, 1))).astype(
        np.float32)
    rows[1] = 0.0
    return jqz.quantize_rows_np(rows, precision)


def _jstorage(st):
    if isinstance(st, tuple):
        return jqz.QuantStorage(jnp.asarray(st[0]), jnp.asarray(st[1]))
    return jnp.asarray(st)


def _parts(st):
    """The arrays of a storage (or of a row pair), as numpy arrays."""
    return [np.asarray(a) for a in (st if isinstance(st, tuple) else (st,))]


def assert_storage_bitwise(got, want, msg=""):
    got, want = _parts(got), _parts(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_bitwise(a, b, msg)


def _fill_operands(precision, N, D, F, n_valid):
    slots = np.full(F, N, np.int32)  # drop sentinels
    slots[RNG.permutation(F)[:n_valid]] = RNG.permutation(N)[:n_valid]
    rows = _qstorage(precision, F, D)
    return slots, rows


def _ids(slots, N, nb, L):
    """Half the lookups read a slot filled in the call; duplicates within
    and across bags (ids < N // 2 otherwise)."""
    filled = slots[slots < N]
    return np.where(RNG.random((nb, L)) < 0.5, RNG.choice(filled, (nb, L)),
                    RNG.integers(0, N // 2, (nb, L))).astype(np.int32)


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------
# (L, D): the grid, then the edges the card's kernels are swept at (rows of
# several warp loads, more than one 32-lookup group)
_Q_EDGES = [(L, D) for L in (1, 3, 20) for D in (8, 40, 128)] + [(3, 192), (33, 128), (2, 256)]


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("L, D", _Q_EDGES)
def test_gather_reduce_q_matches_reference(precision, D, L):
    N, nb = 48, 7
    st = _qstorage(precision, N, D)
    ids = RNG.integers(0, N // 3, (nb, L)).astype(np.int32)
    data, scale = st if precision == "int8" else (st, None)
    t_scale = None if scale is None else torch.from_numpy(scale)
    j_scale = None if scale is None else jnp.asarray(scale)
    port = tops.gather_reduce_q(torch.from_numpy(data), t_scale, torch.from_numpy(ids))
    want_ref = jref.gather_reduce_q_ref(jnp.asarray(data), j_scale, jnp.asarray(ids))
    want_pl = jops.gather_reduce_q(jnp.asarray(data), j_scale, jnp.asarray(ids),
                                   interpret=True)
    assert_bitwise(port.numpy(), want_ref, "vs repro.kernels.ref")
    assert_bitwise(port.numpy(), want_pl, "vs pallas interpret")
    # leading dims, and the plain version called directly
    port3 = tops.gather_reduce_q(torch.from_numpy(data), t_scale,
                                 torch.from_numpy(ids.reshape(1, nb, L)))
    assert_bitwise(port3.numpy()[0], want_ref)
    assert_bitwise(tref.gather_reduce_q_ref(torch.from_numpy(data), t_scale,
                                            torch.from_numpy(ids)).numpy(), want_ref)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("L, D", _Q_EDGES)
def test_fill_gather_reduce_q_matches_reference(precision, D, L):
    N, F, nb = 40, 16, 6
    st = _qstorage(precision, N, D)
    slots, rows = _fill_operands(precision, N, D, F, 12)
    ids = _ids(slots, N, nb, L)
    if precision == "int8":
        data, scale = st
        rows_data, rows_scale = rows
        # the scale column already holds the fill rows' scales (the
        # scratchpad scatters it before the launch)
        scale = np.array(jnp.asarray(scale).at[slots].set(rows_scale, mode="drop"))
        t_scale, j_scale = torch.from_numpy(scale), jnp.asarray(scale)
    else:
        data, rows_data, t_scale, j_scale = st, rows, None, None
    port_st, port = tops.fill_gather_reduce_q(
        torch.from_numpy(data.copy()), t_scale, torch.from_numpy(slots),
        torch.from_numpy(rows_data), torch.from_numpy(ids))
    for name, (w_st, w_bags) in (
            ("ref", jref.fill_gather_reduce_q_ref(
                jnp.asarray(data), j_scale, jnp.asarray(slots), jnp.asarray(rows_data),
                jnp.asarray(ids))),
            ("pallas", jops.fill_gather_reduce_q(
                jnp.asarray(data), j_scale, jnp.asarray(slots), jnp.asarray(rows_data),
                jnp.asarray(ids), interpret=True))):
        assert_bitwise(port_st.numpy(), w_st, f"storage vs {name}")
        assert_bitwise(port.numpy(), w_bags, f"bags vs {name}")
    plain_st, plain = tref.fill_gather_reduce_q_ref(
        torch.from_numpy(data.copy()), t_scale, torch.from_numpy(slots),
        torch.from_numpy(rows_data), torch.from_numpy(ids))
    assert_bitwise(plain.numpy(), port.numpy())
    assert_bitwise(plain_st.numpy(), port_st.numpy())


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_quantized_ops_degenerate_operands(precision):
    """Empty lookups or fills launch nothing and fall back as the reference
    does: fill only, or gather only; empty bags are fp32 zeros."""
    N, D = 20, 8
    st = _qstorage(precision, N, D)
    data, scale = st if precision == "int8" else (st, None)
    t_scale = None if scale is None else torch.from_numpy(scale)
    slots, rows = _fill_operands(precision, N, D, 8, 5)
    rows_data = rows[0] if precision == "int8" else rows
    ids = RNG.integers(0, N, (4, 3)).astype(np.int32)
    out = tops.gather_reduce_q(torch.from_numpy(data), t_scale,
                               torch.zeros((3, 0), dtype=torch.int32))
    assert out.shape == (3, D) and out.dtype == torch.float32 and not out.any()
    st_t, bags = tops.fill_gather_reduce_q(
        torch.from_numpy(data.copy()), t_scale, torch.from_numpy(slots),
        torch.from_numpy(rows_data), torch.zeros((2, 0), dtype=torch.int32))
    assert bags.shape == (2, D) and not bags.any()
    assert_bitwise(st_t.numpy(), jref.fill_ref(jnp.asarray(data), jnp.asarray(slots),
                                               jnp.asarray(rows_data)))
    st_t, bags = tops.fill_gather_reduce_q(
        torch.from_numpy(data.copy()), t_scale, torch.zeros(0, dtype=torch.int32),
        torch.zeros((0, D), dtype=st_t.dtype), torch.from_numpy(ids))
    assert_bitwise(st_t.numpy(), data)
    assert_bitwise(bags.numpy(), jref.gather_reduce_q_ref(
        jnp.asarray(data), None if scale is None else jnp.asarray(scale), jnp.asarray(ids)))
    with pytest.raises(ValueError, match="non-negative"):
        tops.fill_gather_reduce_q(torch.from_numpy(data.copy()), t_scale,
                                  torch.tensor([-1], dtype=torch.int32),
                                  torch.from_numpy(rows_data[:1]), torch.from_numpy(ids))


# ---------------------------------------------------------------------------
# the storage primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_make_storage_fill_read_bytes(precision):
    N, D = 24, 8
    t_st = tsp.make_storage(N, D, precision=precision, device="cpu")
    j_st = jsp.make_storage(N, D, precision=precision)
    assert_storage_bitwise(t_st, j_st)
    assert tsp.storage_bytes(t_st) == jsp.storage_bytes(j_st)
    assert tsp.storage_precision(t_st) == jsp.storage_precision(j_st) == precision
    slots = np.array([3, N, 7, N, 0], np.int32)  # sentinels dropped
    rows = jqz.quantize_rows_np(RNG.standard_normal((5, D)).astype(np.float32), precision)
    j_st = jsp.fill(j_st, jnp.asarray(slots),
                    tuple(jnp.asarray(r) for r in rows) if precision == "int8"
                    else jnp.asarray(rows))
    t_rows = (tuple(torch.from_numpy(r) for r in rows) if precision == "int8"
              else torch.from_numpy(rows))
    t_out = tsp.fill(t_st, torch.from_numpy(slots), t_rows)
    assert t_out is t_st  # in place
    assert_storage_bitwise(t_st, j_st)
    read_idx = np.array([7, 0, 5], np.int32)
    t_read, j_read = tsp.read(t_st, torch.from_numpy(read_idx)), jsp.read(j_st, jnp.asarray(read_idx))
    assert_storage_bitwise(t_read, j_read)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("shape", [(6, 4), (2, 3, 5), (1, 1)])
def test_apply_grad_q_nearest_bitwise(precision, shape):
    N, D = 30, 16
    st = _qstorage(precision, N, D)
    ids = RNG.integers(0, N // 2, shape).astype(np.int32)  # duplicates
    g = (RNG.standard_normal(shape[:-1] + (D,)) * 10.0 ** RNG.integers(-3, 1)).astype(np.float32)
    want = jsp.apply_grad_q(_jstorage(st), jnp.asarray(ids), jnp.asarray(g), LR,
                            jax.random.key(0), kernel="xla", rounding="nearest")
    port_st = convert.storage_from_reference(st)
    got = tsp.apply_grad_q(port_st, torch.from_numpy(ids), torch.from_numpy(g), LR,
                           rounding="nearest")
    assert got is port_st  # in place
    assert_storage_bitwise(got, want)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("L", [1, 4])
def test_fill_gather_reduce_q_storage_nearest_bitwise(precision, L):
    """The fused forward (scale scattered first), then the quantized
    backward at the same bag gradients: payload, scale and bags."""
    N, D, F, nb = 32, 8, 8, 5
    st = _qstorage(precision, N, D)
    slots, rows = _fill_operands(precision, N, D, F, 6)
    ids = _ids(slots, N, nb, L).reshape(nb, 1, L)
    j_rows = tuple(jnp.asarray(r) for r in rows) if precision == "int8" else jnp.asarray(rows)
    t_rows = (tuple(torch.from_numpy(r) for r in rows) if precision == "int8"
              else torch.from_numpy(rows))
    j_st, j_bags = jsp.fill_gather_reduce_q(_jstorage(st), jnp.asarray(slots), j_rows,
                                            jnp.asarray(ids), kernel="xla")
    t_st, t_bags = tsp.fill_gather_reduce_q(convert.storage_from_reference(st),
                                            torch.from_numpy(slots), t_rows,
                                            torch.from_numpy(ids))
    assert_bitwise(t_bags.numpy(), j_bags, "bags")
    g = (RNG.standard_normal((nb, 1, D)) * 1e-2).astype(np.float32)
    j_st = jsp.apply_grad_q(j_st, jnp.asarray(ids), jnp.asarray(g), LR, jax.random.key(1),
                            kernel="xla", rounding="nearest")
    t_st = tsp.apply_grad_q(t_st, torch.from_numpy(ids), torch.from_numpy(g), LR,
                            rounding="nearest")
    assert_storage_bitwise(t_st, j_st, "storage")


def test_storage_from_reference_copies():
    data, scale = _qstorage("int8", 6, 4)
    port = convert.storage_from_reference((data, scale))
    assert isinstance(port, tqz.QuantStorage)
    port.data[0] = 9
    port.scale[0] = 9.0
    assert data[0, 0] != 9 and scale[0, 0] != 9.0
    f16 = _qstorage("fp16", 6, 4)
    t = convert.storage_from_reference(f16)
    assert t.dtype == torch.float16
    t[0] = 5.0
    assert f16[0, 0] != 5.0
    with pytest.raises(ValueError):
        convert.storage_from_reference((f16, scale))


# ---------------------------------------------------------------------------
# the runtimes, end to end, against the reference
# ---------------------------------------------------------------------------
DESIGNS = [("scratchpipe", False), ("scratchpipe", True), ("strawman", False),
           ("static", False)]


def _trace(cfg, syn):
    return syn.TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                           lookups_per_table=cfg.lookups_per_table,
                           batch_size=cfg.batch_size, seed=SEED)


def _cfgs(precision, rounding, **kw):
    return (dataclasses.replace(jcfgs.smoke_config(), precision=precision,
                                rounding=rounding, **kw),
            dataclasses.replace(tcfgs.smoke_config(), precision=precision,
                                rounding=rounding, **kw))


def _kw(design, cfg, group, precision, num_slots):
    if design == "static":
        syn = jsyn if isinstance(group, JGroup) else tsyn
        return {"hot_ids": syn.hot_ids_for_group(group, cfg.cache_fraction),
                "precision": precision}
    kw = {"num_slots": num_slots, "precision": precision}
    if design == "scratchpipe":
        kw.update(past_window=cfg.past_window, future_window=cfg.future_window)
    return kw


def _run(package, design, fused, precision, rounding, mlps=None, num_slots=None,
         steps=STEPS, **cfg_kw):
    """One run through ``package`` ("ref" at kernel="xla", or "port" on the
    CPU). Returns (stats, traffic, flushed host table, the MLP init)."""
    cfg_j, cfg_t = _cfgs(precision, rounding, **cfg_kw)
    cfg = cfg_j if package == "ref" else cfg_t
    slots = num_slots or max(2048, int(cfg.total_rows * cfg.cache_fraction))
    if package == "ref":
        host = JHost(cfg.total_rows, cfg.embed_dim, seed=SEED)
        trainer = JTrainer(cfg, jax.random.key(SEED), lr=LR)
        mlps = jax.tree.map(lambda a: np.array(a, copy=True), trainer.mlps)
        kw, make, syn, la = _kw(design, cfg, JGroup.from_config(cfg), precision,
                                slots), j_make_runtime, jsyn, jla
    else:
        host = THost(cfg.total_rows, cfg.embed_dim, seed=SEED)
        trainer = TTrainer(cfg, seed=SEED, lr=LR, device="cpu")
        trainer.model.load_state_dict(convert.mlps_from_reference(mlps))
        kw, make, syn, la = _kw(design, cfg, TGroup.from_config(cfg), precision,
                                slots), t_make_runtime, tsyn, tla
        kw["device"] = "cpu"
    if fused:
        kw["fused_train_fn"] = trainer.fused_train_fn
    pipe = make(design, host, trainer.train_fn, **kw)
    stream = la.LookaheadStream(syn.dlrm_batches(_trace(cfg, syn), steps))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    return stats, pipe.traffic(), host.data.copy(), mlps


def _plain_stats(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items() if k not in ("aux", "stage_times")}
            for s in stats]


def _losses(stats):
    return np.array([float(s.aux["loss"]) for s in stats])


def _assert_one_step(got, want, precision):
    """Flushed tables within one quantization step per element: the int8
    row's scale (max|row| / 127 after re-quantization), or the fp16 spacing
    at the value."""
    if precision == "int8":
        step = np.abs(want).max(axis=1, keepdims=True) / 127.0 * (1 + 2.0 ** -16)
    else:
        step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    diff = np.abs(got - want)
    assert (diff <= step).all(), (diff.max(), int((diff > step).sum()))
    return diff


@pytest.fixture(scope="module")
def reference_runs():
    return {(d, f, p): _run("ref", d, f, p, "nearest")
            for d, f in DESIGNS for p in ("fp16", "int8")}


def _compare(ref, port, precision):
    j_stats, j_traffic, j_table, _ = ref
    t_stats, t_traffic, t_table, _ = port
    assert _plain_stats(t_stats) == _plain_stats(j_stats)
    for tier in ("host", "pcie", "hbm"):
        assert dataclasses.asdict(t_traffic[tier]) == dataclasses.asdict(j_traffic[tier]), tier
    np.testing.assert_allclose(_losses(t_stats), _losses(j_stats), rtol=LOSS_RTOL)
    _assert_one_step(t_table, j_table, precision)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("design,fused", DESIGNS)
def test_runtime_matches_reference(reference_runs, design, fused, precision):
    ref = reference_runs[design, fused, precision]
    port = _run("port", design, fused, precision, "nearest", mlps=ref[3])
    assert len(port[0]) == STEPS
    _compare(ref, port, precision)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("design,fused", [("scratchpipe", False), ("scratchpipe", True),
                                          ("strawman", False)])
def test_runtime_matches_reference_under_eviction(design, fused, precision):
    """A 16,384-row table and 2,400 resident rows (a nominal budget of 1,200
    fp32 rows at fp16, 600 at int8): [Collect] reads quantized victims,
    [Exchange] copies them back and [Insert] dequantizes them into the
    masters every cycle."""
    nominal = 2400 // tqz.SLOT_MULTIPLIER[precision]
    ref = _run("ref", design, fused, precision, "nearest", num_slots=nominal,
               rows_per_table=4096)
    port = _run("port", design, fused, precision, "nearest", mlps=ref[3],
                num_slots=nominal, rows_per_table=4096)
    assert sum(s.n_evict for s in port[0]) > 500
    _compare(ref, port, precision)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_split_and_fused_bitwise_within_the_port(reference_runs, precision, rounding):
    mlps = reference_runs["scratchpipe", False, precision][3]
    nominal = 2400 // tqz.SLOT_MULTIPLIER[precision]  # evicts, as above
    runs = [_run("port", d, f, precision, rounding, mlps=mlps, num_slots=nominal,
                 rows_per_table=4096)
            for d, f in (("scratchpipe", False), ("scratchpipe", True))]
    (s_stats, _, s_table, _), (f_stats, _, f_table, _) = runs
    assert sum(s.n_evict for s in s_stats) > 0
    assert np.isfinite(_losses(s_stats)).all()
    np.testing.assert_array_equal(_losses(f_stats), _losses(s_stats))
    np.testing.assert_array_equal(f_table, s_table)


def test_stochastic_runs_track_the_reference(reference_runs):
    """Stochastic rounding cannot be matched bit for bit (torch.Generator is
    not jax.random); its losses stay within the reference's P3 bound of the
    nearest-rounding run (tests/test_precision_parity.py: 1e-1 at int8)."""
    want = _losses(reference_runs["scratchpipe", False, "int8"][0])
    got = _losses(_run("port", "scratchpipe", False, "int8", "stochastic",
                       mlps=reference_runs["scratchpipe", False, "int8"][3])[0])
    np.testing.assert_allclose(got, want, rtol=1e-1)


def test_trainer_and_runtime_options():
    cfg = dataclasses.replace(tcfgs.smoke_config(), precision="int8", rounding="nearest")
    tr = TTrainer(cfg, device="cpu")
    assert (tr.precision, tr.rounding) == ("int8", "nearest")
    tr = TTrainer(cfg, precision="fp16", rounding="stochastic", device="cpu")
    assert (tr.precision, tr.rounding) == ("fp16", "stochastic")
    with pytest.raises(ValueError, match="rounding"):
        TTrainer(cfg, rounding="up", device="cpu")
    host = THost(64, 8, seed=0)
    noop = lambda s, slots, b: (s, {})  # noqa: E731
    for precision, rows, dtype in (("fp16", 32, torch.float16), ("int8", 64, torch.int8)):
        pipe = t_make_runtime("scratchpipe", host, noop, num_slots=16, precision=precision,
                              device="cpu")
        assert (pipe.num_slots, pipe.nominal_slots) == (rows, 16)
        data = pipe.storage.data if precision == "int8" else pipe.storage
        assert data.shape == (rows, 8) and data.dtype == dtype
        assert pipe._row_bytes == jqz.row_bytes(8, precision)
    with pytest.raises(ValueError, match="precision"):
        t_make_runtime("scratchpipe", host, noop, num_slots=16, precision="bf16",
                       device="cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def _launch(module, extra):
    cmd = [sys.executable, "-m", module, "--arch", "dlrm-scratchpipe", "--smoke",
           "--steps", "10", *extra]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=240)


def _figures(out):
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    done = next(ln for ln in lines if ln.startswith("done: "))
    run = next(ln for ln in lines if ln.startswith("runtime="))
    return (" ".join(w for w in run.split() if not w.startswith("kernel=")),
            done.split("plan_hit=")[1].split()[0],
            next(ln for ln in lines if ln.startswith("traffic: ")))


@pytest.mark.parametrize("extra", [["--precision", "int8"],
                                   ["--precision", "int8", "--rounding", "nearest", "--fused"],
                                   ["--precision", "fp16", "--runtime", "static"]])
def test_launcher_prints_reference_figures(extra):
    ref = _figures(_launch("repro.launch.train", extra))
    port = _figures(_launch("repro_torch.launch.train", extra + ["--device", "cpu"]))
    assert port == ref
    assert "precision=" + extra[1] in port[0]


def test_launcher_nocache_rejects_precision():
    ref = _launch("repro.launch.train", ["--runtime", "nocache", "--precision", "int8"])
    port = _launch("repro_torch.launch.train",
                   ["--runtime", "nocache", "--precision", "int8", "--device", "cpu"])
    assert ref.returncode == port.returncode == 1
    assert port.stderr.strip().splitlines()[-1] == ref.stderr.strip().splitlines()[-1]
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "dlrm-scratchpipe", "--smoke", "--runtime", "nocache",
                      "--precision", "fp16"])
