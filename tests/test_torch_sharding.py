"""The port's sharding specs and dry-run accounting against the reference's.

In process, no ranks: the reference's ``MeshAxes`` is built directly
(``repro/parallel/sharding.py``), so no 256-device jax mesh is needed. For
each of the 11 archs on the production meshes 16x16 and 2x16x16:

  * ``runtime_config`` (the TP padding of heads and vocab) equals the
    reference's, and with ``ax=None`` gives the config back unpadded;
  * ``param_specs`` equal the reference's leaf by leaf, through
    ``convert.specs_to_reference`` (the port's per-layer lists restacked);
  * ``cache_specs`` at each runnable shape, ``opt_state_specs`` with ZeRO-1
    and the batch specs equal the reference's;
  * the ``meta`` param shapes and dtypes equal ``jax.eval_shape`` of the
    reference's init;
  * every ``dryrun_cells`` cell's per-device argument bytes
    (``launch/dryrun.py: arg_bytes``) equal the same sum over the
    reference's specs and abstract shapes;
  * ``dryrun_cells()`` equals the reference's, cell by cell.

Hypothesis cases hold ``shard_dim``, ``batch_spec`` and ``zero1_spec`` to
the reference's on random shapes and meshes, and ``StepTimeMonitor`` /
``plan_rebalance`` bitwise to the reference's on random streams.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RP

from repro.configs import ASSIGNED_ARCHS as ARCHS
from repro.configs import SHAPES_BY_NAME as RSHAPES
from repro.configs import dryrun_cells as ref_dryrun_cells
from repro.configs import get_config as ref_config
from repro.configs import get_entry as ref_entry
from repro.launch import steps as rsteps
from repro.models import api as rapi
from repro.models import dlrm as rdlrm
from repro.optim import AdamW as RAdamW
from repro.parallel import sharding as rsh
from repro.runtime import straggler as rstrag
from repro_torch import convert
from repro_torch.configs import SHAPES_BY_NAME, dryrun_cells, get_config, get_entry
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import api
from repro_torch.parallel import sharding as sh
from repro_torch.runtime import straggler

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

MESHES = {"16x16": False, "2x16x16": True}


def _axes(multi_pod: bool):
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = tuple(zip(mesh.mesh_dim_names, mesh.shape))
    data = ("pod", "data") if multi_pod else ("data",)
    return rsh.MeshAxes(data=data, model="model", sizes=sizes), sh.mesh_axes(mesh), mesh


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, RP))


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch: str, multi_pod: bool):
    rax, _, _ = _axes(multi_pod)
    return rapi.abstract_params(ref_config(arch), rax)


def _ref_factor(spec, rax) -> int:
    out = 1
    for entry in spec:
        for a in (() if entry is None else (entry if isinstance(entry, tuple) else (entry,))):
            out *= rax.size(a)
    return out


def _ref_bytes(specs, shapes, rax) -> int:
    total = [0]

    def add(spec, a):
        total[0] += int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize // _ref_factor(spec, rax)

    jax.tree.map(add, specs, shapes, is_leaf=lambda x: isinstance(x, RP))
    return total[0]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_config_and_param_specs(arch, mesh_name):
    rax, ax, _ = _axes(MESHES[mesh_name])
    rcfg, cfg = ref_config(arch), get_config(arch)
    want, got = rapi.runtime_config(rcfg, rax), api.runtime_config(cfg, ax)
    assert got[1] == want[1]
    assert got[0].num_heads == want[0].num_heads
    assert api.runtime_config(cfg) == (cfg, cfg.vocab_size)
    assert api.runtime_config(cfg)[0] is cfg
    assert convert.specs_to_reference(api.param_specs(cfg, ax)) == _tuples(
        rapi.param_specs(rcfg, rax))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_opt_and_batch_specs(arch, mesh_name):
    multi = MESHES[mesh_name]
    rax, ax, mesh = _axes(multi)
    rcfg, cfg = ref_config(arch), get_config(arch)
    for shape in ref_entry(arch).shapes:
        want = _tuples(rapi.cache_specs(rcfg, rax, shape.global_batch, shape.seq_len))
        got = convert.specs_to_reference(
            api.cache_specs(cfg, ax, shape.global_batch, shape.seq_len))
        assert got == want, shape.name
        if shape.kind != "decode":
            mine = api.batch_specs(cfg, SHAPES_BY_NAME[shape.name], ax)
            for name, (shp, _) in rapi.batch_structure(rcfg, shape).items():
                assert tuple(mine[name]) == tuple(rsh.batch_spec(rax, shp[0], len(shp) - 1))
    want = rsteps.opt_state_specs(rcfg, rax, _ref_abstract(arch, multi),
                                  rapi.param_specs(rcfg, rax))
    got = steps.train_step_specs(cfg, mesh)["opt"]
    assert tuple(got["t"]) == tuple(want["t"]) == ()
    for k in ("m", "v", "master"):
        assert convert.specs_to_reference(got[k]) == _tuples(want[k]), k
    assert rcfg.zero1  # the reference's ZeRO-1 is on, as the port's always is


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_shapes_equal_the_references(arch):
    rax, ax, _ = _axes(False)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), _ref_abstract(arch, False))
    got = convert.shapes_to_reference(api.abstract_params(get_config(arch), ax))
    assert got == want
    for t in jax.tree.leaves(api.abstract_params(get_config(arch), ax)):
        assert t.device.type == "meta"


def _ref_arg_bytes(arch, shape_name, multi):
    rax, _, _ = _axes(multi)
    entry = ref_entry(arch)
    cfg = entry.config
    out = {}
    dp = rax.data if len(rax.data) > 1 else rax.data[0]
    if arch == "dlrm-scratchpipe":
        params = jax.eval_shape(lambda k: rdlrm.init_full(cfg, k), jax.random.key(0))
        out["params"] = _ref_bytes(rdlrm.full_specs(cfg, rax), params, rax)
        B, T, L = entry.shapes[0].global_batch, cfg.num_tables, cfg.lookups_per_table
        batch = {"dense": jax.ShapeDtypeStruct((B, cfg.num_dense_features), np.float32),
                 "label": jax.ShapeDtypeStruct((B,), np.float32),
                 "sparse_ids": jax.ShapeDtypeStruct((B, T, L), np.int32)}
        out["batch"] = _ref_bytes({"dense": RP(dp, None), "label": RP(dp),
                                   "sparse_ids": RP(dp, None, None)}, batch, rax)
    else:
        shape = RSHAPES[shape_name]
        params = _ref_abstract(arch, multi)
        pspecs = rapi.param_specs(cfg, rax)
        out["params"] = _ref_bytes(pspecs, params, rax)
        if shape.kind == "train":
            opt = jax.eval_shape(RAdamW().init, params)
            ospecs = rsteps.opt_state_specs(cfg, rax, params, pspecs)
            out["opt"] = _ref_bytes(ospecs, opt, rax)
        if shape.kind == "decode":
            cache = jax.eval_shape(lambda: rapi.init_cache(cfg, shape.global_batch,
                                                           shape.seq_len, rax))
            cspecs = rapi.cache_specs(cfg, rax, shape.global_batch, shape.seq_len)
            out["cache"] = _ref_bytes(cspecs, cache, rax)
            b_ax = rsh.shard_dim(rax, shape.global_batch, dp)
            out["batch"] = shape.global_batch * 4 // _ref_factor(RP(b_ax, None), rax) + 4
        else:
            specs, shapes = {}, {}
            for name, (shp, dt) in rapi.batch_structure(cfg, shape).items():
                specs[name] = rsh.batch_spec(rax, shp[0], len(shp) - 1)
                shapes[name] = jax.ShapeDtypeStruct(shp, np.dtype(dt) if dt != "bfloat16"
                                                    else jax.numpy.bfloat16)
            out["batch"] = _ref_bytes(specs, shapes, rax)
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dryrun_arg_bytes_equal_the_references(mesh_name):
    multi = MESHES[mesh_name]
    mesh = make_production_mesh(multi_pod=multi)
    cells = [c for c in dryrun_cells(include_dlrm=True) if not c["skip"]]
    assert len(cells) == sum(1 for c in ref_dryrun_cells(include_dlrm=True) if not c["skip"])
    for c in cells:
        got = dryrun.arg_bytes(c["arch"], c["shape"], mesh)
        assert got == _ref_arg_bytes(c["arch"], c["shape"], multi), c


def test_dryrun_cells_equal_the_references():
    for dlrm_too in (False, True):
        assert dryrun_cells(include_dlrm=dlrm_too) == ref_dryrun_cells(include_dlrm=dlrm_too)
    assert len(dryrun_cells()) == 40
    for arch in ARCHS + ["dlrm-scratchpipe"]:
        e, r = get_entry(arch), ref_entry(arch)
        assert [s.name for s in e.shapes] == [s.name for s in r.shapes]
        assert e.skips == r.skips


def test_production_meshes_are_abstract():
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi)
        assert isinstance(mesh, AbstractMesh) and mesh.shape == shape
        assert mesh.get_coordinate() is None and mesh.size() == int(np.prod(shape))


# --------------------------------------------------------------------------- #
# hypothesis: the rules on random shapes and meshes, the straggler logic
# --------------------------------------------------------------------------- #
_sizes = st.sampled_from([1, 2, 3, 4, 8, 16])


def _both_axes(pod, data, model):
    if pod:
        sizes, names = (("pod", pod), ("data", data), ("model", model)), ("pod", "data")
    else:
        sizes, names = (("data", data), ("model", model)), ("data",)
    return (rsh.MeshAxes(data=names, model="model", sizes=sizes),
            sh.MeshAxes(data=names, model="model", sizes=sizes))


@settings(max_examples=60, deadline=None)
@given(pod=st.sampled_from([0, 2]), data=_sizes, model=_sizes,
       dims=st.lists(st.integers(1, 96), min_size=1, max_size=4), seed=st.integers(0, 2**16))
def test_rules_equal_the_references(pod, data, model, dims, seed):
    rax, ax = _both_axes(pod, data, model)
    rng = np.random.default_rng(seed)
    axes = [None, "model", "data"] + ([("pod", "data")] if pod else [])
    for d in dims:
        for a in axes:
            assert sh.shard_dim(ax, d, a) == rsh.shard_dim(rax, d, a)
        assert tuple(sh.batch_spec(ax, d, len(dims))) == tuple(rsh.batch_spec(rax, d, len(dims)))
    spec = [axes[int(rng.integers(0, 2))] for _ in dims[:int(rng.integers(0, len(dims) + 1))]]
    assert tuple(sh.zero1_spec(sh.P(*spec), dims, ax)) == tuple(
        rsh.zero1_spec(RP(*spec), dims, rax))


@settings(max_examples=30, deadline=None)
@given(hosts=st.integers(1, 12), steps=st.integers(1, 30), seed=st.integers(0, 2**16),
       alpha=st.sampled_from([0.05, 0.1, 0.5]))
def test_straggler_logic_equals_the_references(hosts, steps, seed, alpha):
    rng = np.random.default_rng(seed)
    pol, rpol = (straggler.StragglerPolicy(ema_alpha=alpha),
                 rstrag.StragglerPolicy(ema_alpha=alpha))
    mon, rmon = straggler.StepTimeMonitor(hosts, pol), rstrag.StepTimeMonitor(hosts, rpol)
    for _ in range(steps):
        t = rng.gamma(4.0, 0.25, hosts)
        mon.observe(t)
        rmon.observe(t)
        assert np.array_equal(mon.ema, rmon.ema) and mon.stragglers() == rmon.stragglers()
    shards = rng.integers(0, 9, hosts)
    assert np.array_equal(straggler.plan_rebalance(mon.ema, shards),
                          rstrag.plan_rebalance(rmon.ema, shards))
