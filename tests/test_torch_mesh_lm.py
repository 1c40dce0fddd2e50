"""The transformer LMs' training step partitioned over a mesh, on 8 gloo ranks,
against the reference's step on 8 forced host devices.

Jax subprocesses with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_multidevice.py`` runs the reference) run the reference's
``launch/steps.py: make_train_step`` jitted under ``NamedSharding`` (its
GSPMD partitioning, ZeRO-1 AdamW state placed by its own specs) for two
steps in each cell, from ``api.init(cfg, key(0), ax)`` (the model padded
for the mesh) and ``synth_batch`` at seeds 0 and 1, and write the initial
params, each step's loss and grad norm, and the params and AdamW state
after each step to an ``.npz``:

  (a) mixtral-8x7b smoke on (2, 4) ("data", "model"): the reference's own
      check (``tests/test_multidevice.py``);
  (b) mixtral smoke with ``fsdp=True`` on (2, 4);
  (c) mixtral smoke on (2, 2, 2) ("pod", "data", "model");
  (d) chatglm3-6b smoke on (2, 4): dense, qkv biases, RoPE on half of each
      head, K = 2 kv heads replicated over a model axis of 4;
  (e) chatglm3-6b smoke on (1, 8): 4 heads padded to 8, the vocab 128 / 8;
  (f) hubert-xlarge smoke on (2, 4): frames, non-causal, GELU biases,
      layer norms;
  (g) phi-3-vision smoke on (2, 4): patches, the loss on the text only;
  (h) llama4-scout smoke on (2, 4): top-1 MoE, the expert inner dim 96 / 4.

Then 8 gloo ranks of the port (``torch.multiprocessing``, a ``FileStore``
in the test's own directory) run ``make_train_step(cfg, mesh=...)`` from
the reference's initial params, cut to each rank's shards
(``convert.lm_train_state_to_rank``), on each rank's data slice of the
same batches; ``convert.lm_tree_from_ranks`` puts the shards back
together. The limits are those ``tests/test_torch_lm_train.py`` holds the
one-card port to against the reference:

  * losses and grad norms: rtol 1e-5;
  * step 1's raw gradients (before the clip), leaf by leaf, within 1e-4 of
    each leaf's largest |value|. The reference's are read from its step:
    with m = 0 before it, m after step 1 is (1 - b1) x the clipped
    gradient, and the clip scale is min(1, 1 / grad norm);
  * after two steps, AdamW's ``m`` within 1e-4 and ``v`` within 1e-3 of
    each leaf's largest |value|; the params and ``master`` within 1e-3 x lr
    of their values, with under 0.1% of entries outside (an Adam step is
    about lr x sign(g) at first: an entry whose gradient is within its
    rounding of zero steps either way) and none past 2 x steps x lr;
  * every data replica's params bitwise equal to the other replicas';
  * each rank's AdamW bytes equal to ``launch/dryrun.py:
    tree_bytes_per_device`` of the ZeRO-1 specs;
  * the plain flash versions ran (no kernel on the CPU).

MoE capacity is per data shard, so the routing differs from a one-card
run's: every comparison is with the reference on the same mesh. Last, the
launcher: ``train_lm --mesh 2,4`` on 8 gloo ranks, 4 steps, checkpoints
every 2 steps and a failure at the 3rd step call, ends bitwise equal on
every rank to an uninterrupted run; and a world-1 ``--mesh 1,1`` run is
bitwise the run without a mesh, for these families and the hybrid and ssm
ones (whose cells against the reference are ``tests/test_torch_mesh_ssm.py``'s).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_lock import cpu_lock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
N_RANKS, STEPS, LR, BATCH, SEQ = 8, 2, 3e-4, 4, 16
B1 = 0.9  # AdamW's b1, the reference's and the port's
#: cell -> (arch, mesh shape, config overrides)
CELLS = {"a": ("mixtral-8x7b", (2, 4), {}), "b": ("mixtral-8x7b", (2, 4), {"fsdp": True}),
         "c": ("mixtral-8x7b", (2, 2, 2), {}), "d": ("chatglm3-6b", (2, 4), {}),
         "e": ("chatglm3-6b", (1, 8), {}), "f": ("hubert-xlarge", (2, 4), {}),
         "g": ("phi-3-vision-4.2b", (2, 4), {}), "h": ("llama4-scout-17b-a16e", (2, 4), {})}
#: the cells of each reference subprocess (each well inside its 120 s)
REF_GROUPS = ("ab", "cd", "ef", "gh")

REF_SCRIPT = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch import steps as SS
from repro.models import api
from repro.parallel.sharding import mesh_axes, tree_shardings

out_path, lr, B, S, n_steps = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
cells = json.loads(sys.argv[6])
res = {}

def put(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{prefix}|{jax.tree_util.keystr(kp)}"] = np.asarray(v)

for cell, (arch, shape, over) in cells.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(tuple(shape), names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    with jax.set_mesh(mesh):
        step, specs, opt = SS.make_train_step(cfg, mesh, lr=lr)
        params = jax.tree.map(jax.device_put, api.init(cfg, jax.random.key(0), mesh_axes(mesh)),
                              tree_shardings(mesh, specs["params"]))
        state = jax.tree.map(jax.device_put, opt.init(params),
                             tree_shardings(mesh, specs["opt"]))
        put(f"{cell}|params0", params)
        step = jax.jit(step)
        for i in range(n_steps):
            batch = api.synth_batch(cfg, ShapeSpec("t", S, B, "train"), seed=i)
            params, state, m = step(params, state, batch)
            res[f"{cell}|loss{i}"] = np.asarray(m["loss"])
            res[f"{cell}|gnorm{i}"] = np.asarray(m["grad_norm"])
            put(f"{cell}|params{i + 1}", params)
            put(f"{cell}|state{i + 1}", state)
np.savez(out_path, **res)
print("REF-OK")
"""


def _nested(flat: dict, prefix: str) -> dict:
    """The arrays saved under ``prefix|<jax keystr>`` as a nested dict."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "|"):
            continue
        path = re.findall(r"\['([^']+)'\]", key[len(prefix) + 1:])
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _cfg(cell):
    from repro_torch.configs import get_smoke_config

    arch, shape, over = CELLS[cell]
    return dataclasses.replace(get_smoke_config(arch), **over)


def _cell_rank(cell, mesh, ref, out) -> None:
    """One cell's two steps on this rank; what it got goes into ``out``."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import tree_bytes_per_device
    from repro_torch.models import api
    from repro_torch.optim import AdamW
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel.sharding import data_index, mesh_axes

    cfg, ax = _cfg(cell), mesh_axes(mesh)
    params0 = _nested(ref, f"{cell}|params0")
    step, opt = S.make_train_step(cfg, lr=LR, mesh=mesh)
    params, want = convert.lm_train_state_to_rank(
        params0, {"m": _zeros_like(params0), "v": _zeros_like(params0), "master": params0,
                  "t": np.zeros((), np.int32)}, cfg, mesh)
    state = opt.init(params)
    out[f"{cell}|init_equal"] = np.array(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(want))))
    spec = S.train_step_specs(cfg, mesh)
    _, abs_state = S.abstract_state(cfg, mesh, AdamW())
    out[f"{cell}|opt_bytes"] = np.array(sum(t.numel() * t.element_size()
                                            for t in tree_leaves(state)))
    out[f"{cell}|opt_bytes_dryrun"] = np.array(tree_bytes_per_device(spec["opt"], abs_state, ax))

    grads, real_clip = [], S.clip_by_global_norm
    flash_calls, real_flash = [], kref.flash_attention_ref

    def spy_clip(g, *a, **k):
        if not grads:
            grads.extend(t.clone() for t in g)
        return real_clip(g, *a, **k)

    def spy_flash(*a, **k):
        flash_calls.append(1)
        return real_flash(*a, **k)

    S.clip_by_global_norm, kref.flash_attention_ref = spy_clip, spy_flash
    ops.reset_launch_counts()
    b = BATCH // ax.data_size
    lo = data_index(mesh) * b
    try:
        for i in range(STEPS):
            batch = api.synth_batch(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=i)
            params, state, m = step(params, state, {k: v[lo:lo + b] for k, v in batch.items()})
            out[f"{cell}|loss{i}"] = m["loss"].numpy()
            out[f"{cell}|gnorm{i}"] = m["grad_norm"].numpy()
    finally:
        S.clip_by_global_norm, kref.flash_attention_ref = real_clip, real_flash
    out[f"{cell}|launches"] = np.array(sum(ops.launch_counts().values()))
    out[f"{cell}|flash_plain_calls"] = np.array(len(flash_calls))
    for name, leaves in (("grads1", grads), ("params", tree_leaves(params)),
                         ("m", tree_leaves(state["m"])), ("v", tree_leaves(state["v"])),
                         ("master", tree_leaves(state["master"]))):
        for j, t in enumerate(leaves):
            out[f"{cell}|{name}|{j}"] = t.detach().float().numpy()
    out[f"{cell}|t"] = state["t"].numpy()


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return np.zeros_like(tree)


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every cell's port side, saved for the test process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    ref = {}
    for g in REF_GROUPS:
        ref.update(dict(np.load(os.path.join(tmp, f"ref_{g}.npz"))))
    out = {}
    for cell, (_, shape, _) in CELLS.items():
        names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        _cell_rank(cell, mesh, ref, out)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


def _run_spawned(fn: str, tmp: str) -> None:
    env = dict(os.environ, PYTHONPATH=SRC)
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[2]); "
                            f"import test_torch_mesh_lm as t; t.{fn}(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's arrays and each port rank's, as dicts."""
    tmp = str(tmp_path_factory.mktemp("mesh_lm"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    for g in REF_GROUPS:
        cells = json.dumps({c: CELLS[c] for c in g})
        with cpu_lock(tmp):
            r = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                                os.path.join(tmp, f"ref_{g}.npz"), str(LR), str(BATCH),
                                str(SEQ), str(STEPS), cells],
                               capture_output=True, text=True, env=env, timeout=120)
        assert r.returncode == 0 and "REF-OK" in r.stdout, r.stderr[-3000:]
    _run_spawned("_spawn", tmp)
    ref = {}
    for g in REF_GROUPS:
        ref.update(dict(np.load(os.path.join(tmp, f"ref_{g}.npz"))))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{i}.npz"))) for i in range(N_RANKS)]
    return {"ref": ref, "ranks": ranks}


def _gathered(runs, cell, name, zero1=False):
    """The ranks' shards of one tree, put back together in the reference's
    layout (``convert.lm_tree_from_ranks``)."""
    from repro_torch import convert

    arch, shape, _ = CELLS[cell]
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    leaves = []
    for got in runs["ranks"]:
        n = sum(1 for k in got if k.startswith(f"{cell}|{name}|"))
        leaves.append([got[f"{cell}|{name}|{j}"] for j in range(n)])
    return convert.lm_tree_from_ranks(leaves, _cfg(cell), shape, names, zero1=zero1)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _leaves_close(got, want, tol, what):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        err = float(np.abs(g[k] - w[k]).max()) if w[k].size else 0.0
        assert err <= tol * max(scale, 1e-30), (what, k, err, scale)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_losses_and_grad_norms_match_the_reference(runs, cell):
    ref = runs["ref"]
    for rank, got in enumerate(runs["ranks"]):
        for i in range(STEPS):
            np.testing.assert_allclose(got[f"{cell}|loss{i}"], ref[f"{cell}|loss{i}"],
                                       rtol=1e-5, err_msg=f"rank {rank} step {i}")
            np.testing.assert_allclose(got[f"{cell}|gnorm{i}"], ref[f"{cell}|gnorm{i}"],
                                       rtol=1e-5, err_msg=f"rank {rank} step {i}")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_step1_gradients_match_the_reference(runs, cell):
    ref = runs["ref"]
    scale = min(1.0, 1.0 / max(float(ref[f"{cell}|gnorm0"]), 1e-12))
    m1 = _nested(ref, f"{cell}|state1")["m"]

    def raw(tree):
        if isinstance(tree, dict):
            return {k: raw(v) for k, v in tree.items()}
        return np.asarray(tree, np.float64) / ((1 - B1) * scale)

    _leaves_close(_gathered(runs, cell, "grads1"), raw(m1), 1e-4, f"{cell} step-1 gradients")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_params_and_adamw_state_after_two_steps(runs, cell):
    ref = runs["ref"]
    want = _nested(ref, f"{cell}|state{STEPS}")
    assert all(int(got[f"{cell}|t"]) == int(want["t"]) == STEPS for got in runs["ranks"])
    _leaves_close(_gathered(runs, cell, "m", zero1=True), want["m"], 1e-4, f"{cell} m")
    _leaves_close(_gathered(runs, cell, "v", zero1=True), want["v"], 1e-3, f"{cell} v")
    flips = total = 0
    for name, got, wtree in (
            ("params", _gathered(runs, cell, "params"), _nested(ref, f"{cell}|params{STEPS}")),
            ("master", _gathered(runs, cell, "master", zero1=True), want["master"])):
        g, w = _flat(got), _flat(wtree)
        assert set(g) == set(w)
        for k in w:
            diff = np.abs(g[k] - w[k])
            assert (diff <= 2 * STEPS * LR + 1e-6).all(), (cell, name, k)
            flips += int((diff > 1e-3 * LR + 1e-6 * np.abs(w[k])).sum())
            total += diff.size
    assert flips <= 1e-3 * total, (cell, flips, total)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_data_replicas_are_bitwise_equal(runs, cell):
    """Ranks that differ only in their data coordinates hold the same
    params, bit for bit, in every leaf replicated over the data axes (its
    gradient is summed there, and ZeRO-1 all-gathers the update); FSDP
    leaves hold a different block on each data rank."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.steps import train_step_specs
    from repro_torch.parallel.sharding import data_dims, mesh_axes, spec_leaves

    _, shape, _ = CELLS[cell]
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = AbstractMesh(shape, names)
    specs = spec_leaves(train_step_specs(_cfg(cell), mesh)["params"])
    keys = [f"{cell}|params|{j}" for j, (_, sp) in enumerate(specs)
            if not data_dims(sp, mesh_axes(mesh))]
    assert keys and len(keys) < len(specs) if cell == "b" else len(keys) == len(specs)
    tp, ranks = shape[-1], runs["ranks"]
    for rank, got in enumerate(ranks):
        first = ranks[rank % tp]  # the data-rank-0 replica of this model rank
        for k in keys:
            assert np.array_equal(got[k], first[k]), (cell, rank, k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_zero1_bytes_and_the_plain_path(runs, cell):
    """Each rank's AdamW state takes the bytes the dry run computes for it
    (``launch/dryrun.py: tree_bytes_per_device`` of the ZeRO-1 specs); the
    state ``opt.init`` gives equals the reference's initial state cut by
    ``convert.lm_train_state_to_rank``; on the CPU the plain flash versions
    ran and no kernel launched."""
    for got in runs["ranks"]:
        assert int(got[f"{cell}|opt_bytes"]) == int(got[f"{cell}|opt_bytes_dryrun"])
        assert bool(got[f"{cell}|init_equal"])
        assert int(got[f"{cell}|launches"]) == 0
        assert int(got[f"{cell}|flash_plain_calls"]) > 0


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
DRILL = ["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--mesh", "2,4",
         "--steps", "4", "--batch", "4", "--seq-len", "16", "--ckpt-every", "2"]


def _drill_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the drill: the clean run, then the one with a failure at
    the 3rd step call; the rank writes whether they ended bitwise equal."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import FailureInjector

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    res, printed = {}, {}
    for name, hook in (("clean", None), ("drill", FailureInjector(fail_at=[3]).maybe_fail)):
        args = train.build_parser().parse_args(DRILL + ["--ckpt-dir", os.path.join(tmp, name)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res[name] = train.train_lm(args, step_hook=hook)
        printed[name] = buf.getvalue()
    clean, drill = res["clean"], res["drill"]
    out = {"equal": all(torch.equal(a, b) for a, b in zip(
        tree_leaves((clean["params"], clean["opt_state"])),
        tree_leaves((drill["params"], drill["opt_state"])))),
        "restarts": [clean["report"].restarts, drill["report"].restarts],
        "causes": drill["report"].causes, "losses": [clean["losses"], drill["losses"]],
        "printed": printed, "ckpt": sorted(os.listdir(os.path.join(tmp, "drill"))),
        "rank_ckpt": sorted(os.listdir(os.path.join(tmp, "drill", f"rank{rank}"))),
        "still_initialized": dist.is_initialized()}
    with open(os.path.join(tmp, f"drill{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn_drill(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_drill_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


def test_launcher_mesh_drill_resumes_bitwise(tmp_path):
    """``train_lm --mesh 2,4`` on 8 gloo ranks (mixtral's smoke config, 4
    steps, checkpoints every 2 steps, each rank into ``rank{r}/``): a
    failure at the 3rd step call restores every rank from its own step-2
    checkpoint, and each rank's params and AdamW state end bitwise equal to
    an uninterrupted run's; rank 0 alone prints ``done:``; the group the
    test started stays up (the launcher destroys only its own)."""
    _run_spawned("_spawn_drill", str(tmp_path))
    for rank in range(N_RANKS):
        with open(tmp_path / f"drill{rank}.json") as f:
            got = json.load(f)
        assert got["equal"], rank
        assert got["restarts"] == [0, 1] and got["causes"] == [[2, "RuntimeError"]]
        clean, drill = got["losses"]
        assert len(clean) == 4 and all(np.isfinite(clean))
        assert drill[:2] + drill[-2:] == clean  # steps 0-1, the failure, then 2-3 again
        assert got["ckpt"] == [f"rank{r}" for r in range(N_RANKS)]
        assert got["rank_ckpt"] == ["step_2", "step_4"]
        for name in ("clean", "drill"):
            assert ("done: steps=4" in got["printed"][name]) == (rank == 0), (rank, name)
        assert got["still_initialized"]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mixtral-8x7b", "hubert-xlarge",
                                  "phi-3-vision-4.2b", "zamba2-1.2b", "mamba2-2.7b"])
def test_world_1_mesh_run_is_the_one_card_run(arch, tmp_path):
    """``--mesh 1,1`` (a world-1 gloo group the launcher starts and
    destroys) gives each step's loss and grad norm and the final params and
    AdamW state bitwise equal to the run without a mesh: every collective
    of a world-1 group is the identity, and the step keeps the one-card
    path's order of operations (``chip_smoke.py`` phase 24 holds the same
    on the card through NCCL, at full width)."""
    import torch.distributed as dist

    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves

    out = []
    for mesh in (None, "1,1"):
        argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2",
                "--seq-len", "16", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / str(mesh))]
        out.append(train.train_lm(train.build_parser().parse_args(
            argv + (["--mesh", mesh] if mesh else []))))
        assert not dist.is_initialized()
    one, meshed = out
    assert one["losses"] == meshed["losses"] and one["grad_norms"] == meshed["grad_norms"]
    a, b = (tree_leaves((r["params"], r["opt_state"])) for r in out)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))

