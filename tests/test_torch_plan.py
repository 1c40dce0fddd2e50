"""The port's numpy substrate against the JAX package's, on the same seeds.

The port copies these modules (it may not import ``repro``), so each copy
is held to its original: TableGroup layouts and budgets, host-table data,
scenario ids for all five scenarios, every PlanResult field over drift and
inference_mix streams (with and without per-table slot budgets), planner
checkpoints, operand padding and the numpy quantize helpers. Everything is
compared exactly.
"""
import numpy as np
import pytest

from repro.core import host_table as j_host
from repro.core import pipeline as j_pipe
from repro.core import plan as j_plan
from repro.core import quantize as j_qz
from repro.core import table_group as j_tg
from repro.traces import scenarios as j_sc
from repro_torch.core import host_table as t_host
from repro_torch.core import pipeline as t_pipe
from repro_torch.core import plan as t_plan
from repro_torch.core import quantize as t_qz
from repro_torch.core import table_group as t_tg
from repro_torch.traces import scenarios as t_sc

SCENARIOS = ["drift", "flash_crowd", "diurnal", "cold_start", "inference_mix"]
PLAN_FIELDS = t_pipe._PLAN_FIELDS


def test_plan_fields_and_step_stats_match_reference():
    assert t_pipe._PLAN_FIELDS == j_pipe._PLAN_FIELDS
    t_fields = [(f.name, f.default) for f in t_pipe.StepStats.__dataclass_fields__.values()]
    j_fields = [(f.name, f.default) for f in j_pipe.StepStats.__dataclass_fields__.values()]
    assert t_fields == j_fields
    st = t_pipe.StepStats(1, 10, 4, 3, 1, 0)
    assert st.hit_rate == j_pipe.StepStats(1, 10, 4, 3, 1, 0).hit_rate == 0.75


def assert_same(a, b, msg=""):
    if a is None or b is None:
        assert a is None and b is None, msg
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def hetero(mod):
    return mod.TableGroup([
        mod.TableSpec("a", 300, 8, 0.05),
        mod.TableSpec("b", 120, 8, 0.2),
        mod.TableSpec("c", 900, 8, 0.01),
    ])


# ---------------------------------------------------------------------------
# TableGroup
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_slots,floor", [(64, 1), (200, 10), (1000, 30)])
def test_table_group_layout_and_budgets(num_slots, floor):
    j, t = hetero(j_tg), hetero(t_tg)
    assert_same(t.offsets, j.offsets)
    assert t.slot_budgets(num_slots, floor) == j.slot_budgets(num_slots, floor)
    assert (t.precision_slot_budgets(num_slots, floor)
            == j.precision_slot_budgets(num_slots, floor))
    b = j.slot_budgets(num_slots, floor)
    assert t.slot_ranges(b) == j.slot_ranges(b)
    assert t.window_floor(40, 4) == j.window_floor(40, 4)
    gids = np.array([0, 299, 300, 419, 420, 1319])
    assert_same(t.table_of(gids), j.table_of(gids))
    for a, c in zip(t.to_local(gids), j.to_local(gids)):
        assert_same(a, c)
    local = np.random.default_rng(1).integers(0, 120, (5, 3, 4))
    assert_same(t.globalize(local), j.globalize(local))
    for a, c in zip(t.split(j.globalize(local)), j.split(j.globalize(local))):
        assert_same(a, c)


def test_table_group_uniform_and_precisions():
    t = t_tg.TableGroup.uniform(3, 50, 16, precision="int8")
    j = j_tg.TableGroup.uniform(3, 50, 16, precision="int8")
    assert repr(t) == repr(j)
    assert t.precisions == j.precisions
    assert t.precision_slot_budgets(60) == j.precision_slot_budgets(60)
    with pytest.raises(ValueError, match="precision"):
        t_tg.TableSpec("x", 4, 4, precision="fp8")


# ---------------------------------------------------------------------------
# host table and scenario ids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 8])
def test_host_table_same_data_from_seed(seed):
    t = t_host.HostEmbeddingTable(500, 24, seed=seed)
    j = j_host.HostEmbeddingTable(500, 24, seed=seed)
    assert_same(t.data, j.data)
    ids = np.array([3, 3, 499, 0])
    assert_same(t.gather(ids), j.gather(ids))
    assert t.traffic.read == j.traffic.read == 4 * 24 * 4


@pytest.mark.parametrize("rows,dim,dtype", [
    (2 * t_host.NORMAL_BLOCK_ROWS + 5, 16, np.float32),  # two whole blocks and a part
    (t_host.NORMAL_BLOCK_ROWS, 8, np.float16),
    (1, 3, np.float64),
    (0, 4, np.float32),
])
def test_host_table_blocks_draw_the_references_rows(rows, dim, dtype):
    """``normal_rows`` draws in blocks of rows: the reference's table, bit
    for bit, at any row count and dtype."""
    t = t_host.HostEmbeddingTable(rows, dim, seed=7, dtype=dtype)
    j = j_host.HostEmbeddingTable(rows, dim, seed=7, dtype=dtype)
    assert t.data.dtype == j.data.dtype and t.data.shape == j.data.shape == (rows, dim)
    assert_same(t.data, j.data)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_ids_identical(scenario):
    kw = dict(batch_size=6, lookups_per_table=4, seed=5)
    t_items = list(t_sc.scenario_batches(scenario, hetero(t_tg), 12, **kw))
    j_items = list(j_sc.scenario_batches(scenario, hetero(j_tg), 12, **kw))
    assert len(t_items) == len(j_items) == 12
    for i, ((tg, tp), (jg, jp)) in enumerate(zip(t_items, j_items)):
        assert_same(tg, jg, f"{scenario} batch {i} ids")
        assert tp.keys() == jp.keys()
        for k in jp:
            assert_same(tp[k], jp[k], f"{scenario} batch {i} {k}")
    assert t_sc.available_scenarios() == j_sc.available_scenarios()


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
def _planners(budgets: bool, policy: str, past: int, num_slots: int):
    out = []
    for tg, pl in ((t_tg, t_plan), (j_tg, j_plan)):
        g = hetero(tg)
        kw = {}
        if budgets:
            kw = dict(row_offsets=g.offsets,
                      slot_ranges=g.slot_ranges(g.slot_budgets(num_slots, 24)))
        out.append(pl.Planner(g.total_rows, num_slots, past_window=past,
                              future_window=2, policy=policy, seed=3, **kw))
    return out


@pytest.mark.parametrize("scenario", ["drift", "inference_mix"])
@pytest.mark.parametrize("budgets", [False, True])
@pytest.mark.parametrize("policy,past", [("lru", 3), ("lru", 0), ("lfu", 0),
                                         ("random", 3)])
def test_planner_results_identical(scenario, budgets, policy, past):
    num_slots = 180  # tight: evictions every cycle once warm
    tp, jp = _planners(budgets, policy, past, num_slots)
    batches = [g for g, _ in j_sc.scenario_batches(
        scenario, hetero(j_tg), 20, batch_size=4, lookups_per_table=3, seed=2)]
    n_evicting = 0
    for i, ids in enumerate(batches):
        future = batches[i + 1: i + 3]
        rt, rj = tp.plan(ids, future), jp.plan(ids, future)
        for f in PLAN_FIELDS:
            assert_same(getattr(rt, f), getattr(rj, f), f"batch {i} {f}")
        n_evicting += rj.evict_slots.size > 0
    assert n_evicting > 0  # the stream exercised victim selection
    for k, v in jp.state_dict().items():
        assert_same(tp.state_dict()[k], v, k)


def test_planner_resumes_from_reference_checkpoint():
    tp, jp = _planners(True, "lru", 0, 180)
    batches = [g for g, _ in j_sc.scenario_batches(
        "drift", hetero(j_tg), 14, batch_size=4, lookups_per_table=3, seed=9)]
    for ids in batches[:7]:
        jp.plan(ids, [])
    tp.load_state_dict({k: np.copy(v) for k, v in jp.state_dict().items()})
    for i, ids in enumerate(batches[7:]):
        rt, rj = tp.plan(ids, batches[8 + i:10 + i]), jp.plan(ids, batches[8 + i:10 + i])
        for f in PLAN_FIELDS:
            assert_same(getattr(rt, f), getattr(rj, f), f"batch {i} {f}")


def test_planner_too_small_raises_like_reference():
    for pl in (t_plan, j_plan):
        p = pl.Planner(100, 4, past_window=0, future_window=0)
        p.plan(np.arange(4), [])
        with pytest.raises(RuntimeError, match="scratchpad too small"):
            p.plan(np.arange(4, 10), [np.arange(4)])


def test_pinned_cache_lru_by_identity():
    for pl in (t_plan, j_plan):
        c = pl.PinnedCache(2)
        a, b, d = np.arange(3), np.arange(3), np.arange(3)
        assert c.get(a, len) == 3 and c.get(a, len) == 3
        c.get(b, len)
        c.get(d, len)  # evicts a
        assert (c.hits, c.misses, len(c)) == (1, 3, 2)


# ---------------------------------------------------------------------------
# operand padding and the numpy quantize helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("buckets", [None, (16, 48, 300)])
@pytest.mark.parametrize("n", [0, 1, 16, 17, 255, 256, 257, 301, 1000])
def test_pad_helpers_identical(n, buckets):
    assert t_plan.pad_len(n, buckets) == j_plan.pad_len(n, buckets)
    idx = np.arange(n, dtype=np.int32)
    assert_same(t_plan.pad_index(idx, 999, buckets),
                j_plan.pad_index(idx, 999, buckets))
    rows = np.ones((n, 3), np.float32)
    assert_same(t_plan.pad_rows(rows, buckets), j_plan.pad_rows(rows, buckets))
    assert t_plan.PAD_FLOOR == j_plan.PAD_FLOOR


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_quantize_np_identical(precision):
    rows = np.random.default_rng(4).standard_normal((9, 16)).astype(np.float32)
    rows[3] = 0.0
    tq = t_qz.quantize_rows_np(rows, precision)
    jq = j_qz.quantize_rows_np(rows, precision)
    if precision == "int8":
        for a, b in zip(tq, jq):
            assert_same(a, b)
    else:
        assert_same(tq, jq)
    assert_same(t_qz.dequantize_rows_np(jq, precision),
                j_qz.dequantize_rows_np(jq, precision))
    assert t_qz.row_bytes(16, precision) == j_qz.row_bytes(16, precision)
    assert t_qz.SLOT_MULTIPLIER == j_qz.SLOT_MULTIPLIER
    assert t_qz.PRECISIONS == j_qz.PRECISIONS
