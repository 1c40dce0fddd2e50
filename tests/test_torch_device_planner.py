"""The port's device-resident planner (``repro_torch.core.plan_device``) on
the CPU, against the JAX package's (``repro.core.plan_jax``) and against the
port's own numpy host planner.

Inputs are made from numpy seeds and handed to both packages:

  * ``plan_step`` equals ``repro.core.plan_jax.plan_step`` on every output,
    the -1 padding included, and on the state after every step (the port's
    trailing dummy elements dropped, ``hold`` as uint32), over random
    traces with eviction pressure, for three seeds;
  * ``plan_window`` equals sequential ``plan_step`` calls;
  * ``plan_group_step`` equals the reference's on two tables with offsets;
  * ``DevicePlanner`` equals the host ``Planner`` on every compacted output,
    order included, single- and multi-table, materialized inline or through
    a worker pool;
  * an infeasible cycle raises the host planner's exact message, and
    ``policy="lfu"`` raises ``ValueError``;
  * ``state_dict`` round-trips, and a reference planner's state carried
    across by ``convert.device_planner_state_from_reference`` plans the
    same next cycles as the reference.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_jax as J
from repro_torch import convert
from repro_torch.core import plan_device as P
from repro_torch.core.plan import Planner

ROWS, SLOTS, N, STEPS = 200, 96, 12, 40  # as tests/test_plan_jax.py


def _trace(seed, rows=ROWS, n=N, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, rows, size=n).astype(np.int32) for _ in range(steps + 2)]


def _assert_outputs(port: dict, ref: dict, msg=""):
    assert set(port) == set(ref)
    for k, v in ref.items():
        want = np.asarray(v)
        got = port[k].numpy()
        assert got.dtype == want.dtype, (msg, k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} {k}")


def _assert_state(port: P.PlanState, ref: J.PlanState, msg=""):
    host = P.state_to_host(port)
    for f in P._STATE_FIELDS:
        want = np.asarray(getattr(ref, f))
        assert host[f].dtype == want.dtype and host[f].shape == want.shape, (msg, f)
        np.testing.assert_array_equal(host[f], want, err_msg=f"{msg} {f}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_step_matches_reference(seed):
    batches = _trace(seed)
    js, ts = J.init_state(ROWS, SLOTS), P.init_state(ROWS, SLOTS)
    evicted = 0
    for t in range(STEPS):
        fut = np.concatenate(batches[t + 1:t + 3])
        js, jo = J.plan_step(js, jnp.asarray(batches[t]), jnp.asarray(fut))
        ts, to = P.plan_step(ts, torch.from_numpy(batches[t]), torch.from_numpy(fut))
        _assert_outputs(to, jo, f"step {t}")
        _assert_state(ts, js, f"step {t}")
        evicted += int(jo["n_evict"])
    assert evicted > 0  # the trace put the cache under eviction pressure


def test_plan_step_leaves_its_input_state_alone():
    batches = _trace(5)
    st = P.init_state(ROWS, SLOTS)
    for t in range(8):
        st, _ = P.plan_step(st, torch.from_numpy(batches[t]), torch.from_numpy(batches[t + 1]))
    before = [x.clone() for x in st]
    P.plan_step(st, torch.from_numpy(batches[9]), torch.from_numpy(batches[10]))
    assert all(torch.equal(a, b) for a, b in zip(before, st))
    with pytest.raises(ValueError, match="30"):
        P.plan_step(st, torch.from_numpy(batches[0]), torch.from_numpy(batches[1]),
                    past_window=31)


@pytest.mark.parametrize("seed", [0, 3])
def test_plan_window_matches_sequential_steps(seed):
    rows, slots, n, W = 120, 64, 8, 12
    batches = _trace(seed, rows, n, W)
    ids = torch.from_numpy(np.stack(batches[:W]))
    fut = torch.from_numpy(np.stack([np.concatenate(batches[t + 1:t + 3]) for t in range(W)]))
    seq, outs = P.init_state(rows, slots), []
    for t in range(W):
        seq, o = P.plan_step(seq, ids[t], fut[t])
        outs.append(o)
    win, stacked = P.plan_window(P.init_state(rows, slots), ids, fut)
    for a, b in zip(seq, win):
        assert torch.equal(a, b)
    for k in outs[0]:
        assert torch.equal(torch.stack([o[k] for o in outs]), stacked[k]), k
    # and the reference's lax.scan gives the same stacked outputs
    _, j_stacked = J.plan_window(J.init_state(rows, slots), jnp.asarray(ids.numpy()),
                                 jnp.asarray(fut.numpy()))
    _assert_outputs(stacked, j_stacked, "window")


def test_plan_group_step_matches_reference():
    rows, budgets, n = (150, 90), (40, 30), 10
    offsets = [0, rows[0], rows[0] + rows[1]]
    rng = np.random.default_rng(7)
    trace = [[rng.integers(0, r, size=n).astype(np.int32) for r in rows]
             for _ in range(32)]
    j_states = [J.init_state(r, b) for r, b in zip(rows, budgets)]
    t_states = [P.init_state(r, b) for r, b in zip(rows, budgets)]
    evicted = 0
    for t in range(30):
        fut = [np.concatenate([trace[t + 1][k], trace[t + 2][k]]) for k in range(2)]
        j_states, j_outs = J.plan_group_step(j_states, offsets, trace[t], fut)
        t_states, t_outs = P.plan_group_step(
            t_states, offsets, [torch.from_numpy(x) for x in trace[t]],
            [torch.from_numpy(x) for x in fut])
        for k in range(2):
            _assert_outputs(t_outs[k], j_outs[k], f"step {t} table {k}")
            _assert_state(t_states[k], j_states[k], f"step {t} table {k}")
            evicted += int(j_outs[k]["n_evict"])
    assert evicted > 0


def test_init_group_states_sizes_each_table():
    class Spec:
        def __init__(self, rows):
            self.rows = rows

    class Group:
        num_tables = 2
        tables = [Spec(5), Spec(7)]

    states = P.init_group_states(Group(), [3, 4])
    assert [(s.hitmap.numel(), s.slot_to_id.numel()) for s in states] == [(6, 4), (8, 5)]
    with pytest.raises(ValueError):
        P.init_group_states(Group(), [3])


_FIELDS = ("miss_ids", "fill_slots", "evict_slots", "evict_ids")


def _drive_pair(batches, rows, slots, future=2, pool=None, **kw):
    host = Planner(rows, slots, future_window=future, **kw)
    dev = P.DevicePlanner(rows, slots, future_window=future, device="cpu", **kw)
    evicted = 0
    for i, ids in enumerate(batches):
        look = batches[i + 1:i + 1 + future]
        rh = host.plan(ids, look)
        rd = dev.plan(ids, look)
        if pool is not None:
            rd.start_materialize(pool)
        for f in _FIELDS:
            vh, vd = getattr(rh, f), getattr(rd, f)
            assert vd.dtype == np.int32, f
            np.testing.assert_array_equal(vd, vh, err_msg=f"{f} @ step {i}")
        assert rd.slots.dtype == torch.int32
        np.testing.assert_array_equal(rd.slots.numpy(), rh.slots, err_msg=f"slots @ {i}")
        assert (rd.step, rd.n_unique, rd.n_hits) == (rh.step, rh.n_unique, rh.n_hits), i
        evicted += rh.evict_ids.size
        for f in ("hits_by_table", "misses_by_table"):
            a, b = getattr(rd, f), getattr(rh, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dev.slot_to_id, host.slot_to_id)
    assert dev.occupancy == host.occupancy
    return evicted


@pytest.mark.parametrize("seed", range(6))
def test_device_planner_equals_host_planner(seed):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(30, 150))
    batches = [rng.integers(0, rows, size=rng.integers(1, 10)) for _ in range(16)]
    worst = max(sum(len(np.unique(b)) for b in batches[i:i + 6]) for i in range(16))
    _drive_pair(batches, rows, min(rows, worst + 4))


def test_device_planner_materializes_on_a_pool():
    rng = np.random.default_rng(11)
    batches = [rng.integers(0, 100, size=(3, 4)) for _ in range(20)]
    with ThreadPoolExecutor(max_workers=1) as pool:
        assert _drive_pair(batches, 100, 72, pool=pool) > 0


def test_device_planner_multi_table_equals_host_planner():
    """(B, T, L) ids, per-table row offsets and slot budgets: the fused
    coordinates, victim order and per-table counts of the host planner."""
    rows, budgets, B, L = (120, 60, 90), (40, 40, 40), 2, 3
    offsets = np.concatenate([[0], np.cumsum(rows)])
    ranges = [(int(a), int(a + b)) for a, b in zip(np.concatenate([[0], np.cumsum(budgets)]),
                                                     budgets)]
    rng = np.random.default_rng(2)
    batches = [np.stack([rng.integers(0, r, size=(B, L)) + o
                         for r, o in zip(rows, offsets[:-1])], axis=1)
               for _ in range(24)]
    assert _drive_pair(batches, int(offsets[-1]), sum(budgets), row_offsets=offsets,
                       slot_ranges=ranges) > 0


def test_device_planner_validates_the_first_batch():
    dev = P.DevicePlanner(50, 20, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        dev.plan(np.array([3, 50]), [])
    multi = P.DevicePlanner(50, 20, row_offsets=[0, 20, 50], slot_ranges=[(0, 10), (10, 20)],
                            device="cpu")
    with pytest.raises(ValueError, match="layout"):
        multi.plan(np.array([[[3], [5]]]), [])
    with pytest.raises(ValueError, match=r"\(B, 2, L\)"):
        multi.plan(np.array([3, 25]), [])


def test_infeasible_cycle_raises_the_host_planners_words():
    rows, slots = 40, 3
    host = Planner(rows, slots, past_window=3, future_window=0)
    dev = P.DevicePlanner(rows, slots, past_window=3, future_window=0, device="cpu")
    errors = []
    for planner in (host, dev):
        with pytest.raises(RuntimeError, match="scratchpad too small") as e:
            for i in range(4):
                planner.plan(np.array([i]), []).miss_ids  # materializing raises
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_device_planner_rejects_other_policies():
    with pytest.raises(ValueError, match="lru"):
        P.DevicePlanner(10, 4, policy="lfu", device="cpu")
    with pytest.raises(ValueError, match="int32"):
        P.DevicePlanner(2 ** 31, 4, device="cpu")


def test_state_dict_round_trip():
    batches = _trace(3, n=12, steps=24)
    a = P.DevicePlanner(ROWS, SLOTS, device="cpu")
    for i in range(10):
        a.plan(batches[i], batches[i + 1:i + 3]).miss_ids
    snap = a.state_dict()
    assert snap["t0_hold"].dtype == np.uint32 and snap["t0_hitmap"].shape == (ROWS,)
    b = P.DevicePlanner(ROWS, SLOTS, device="cpu")
    b.load_state_dict(snap)
    assert b._cycle == a._cycle == 10
    for i in range(10, 20):
        ra = a.plan(batches[i], batches[i + 1:i + 3])
        rb = b.plan(batches[i], batches[i + 1:i + 3])
        assert torch.equal(ra.slots, rb.slots)
        np.testing.assert_array_equal(ra.evict_ids, rb.evict_ids)
    np.testing.assert_array_equal(a.slot_to_id, b.slot_to_id)
    with pytest.raises(ValueError, match="incompatible"):
        P.DevicePlanner(ROWS, SLOTS, device="cpu").load_state_dict(
            Planner(ROWS, SLOTS).state_dict())


def test_state_from_the_reference_continues_as_the_reference():
    batches = _trace(4, n=12, steps=30)
    ref = J.DevicePlanner(ROWS, SLOTS)
    for i in range(12):
        ref.plan(batches[i], batches[i + 1:i + 3]).miss_ids
    state = convert.device_planner_state_from_reference(ref.state_dict())
    port = P.DevicePlanner(ROWS, SLOTS, device="cpu")
    port.load_state_dict(state)
    evicted = 0
    for i in range(12, 28):
        rr = ref.plan(batches[i], batches[i + 1:i + 3])
        rp = port.plan(batches[i], batches[i + 1:i + 3])
        np.testing.assert_array_equal(rp.slots.numpy(), np.asarray(rr.slots))
        for f in _FIELDS:
            np.testing.assert_array_equal(getattr(rp, f), getattr(rr, f), err_msg=f)
        evicted += rr.evict_ids.size
    assert evicted > 0
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(port.state_dict()[k], v, err_msg=k)
    # copies, not views of the reference's arrays; malformed input refused
    snap = ref.state_dict()
    state = convert.device_planner_state_from_reference(snap)
    state["t0_hitmap"][0] = 12345
    assert np.asarray(snap["t0_hitmap"])[0] != 12345
    bad = dict(snap, t0_hold=np.asarray(snap["t0_hold"]).astype(np.int64))
    with pytest.raises(ValueError, match="uint32"):
        convert.device_planner_state_from_reference(bad)
    high = dict(snap, t0_hold=np.full_like(np.asarray(snap["t0_hold"]), 1 << 31))
    with pytest.raises(ValueError, match="bit 31"):
        convert.device_planner_state_from_reference(high)
    with pytest.raises(ValueError, match="lacks"):
        convert.device_planner_state_from_reference(
            {k: v for k, v in snap.items() if k != "t0_cycle"})
