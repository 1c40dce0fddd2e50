"""The port's mesh layer on gloo ranks, against the reference's 8-device host
mesh.

A jax subprocess with ``--xla_force_host_platform_device_count=8`` (as
``tests/test_multidevice.py`` runs the reference) computes the reference's
results on the meshes (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data",
"model") from seeded numpy inputs, and writes them to an ``.npz``. Then 8
gloo ranks of the port (``torch.multiprocessing``, a ``FileStore`` in the
test's own directory, ``init_device_mesh("cpu", ...)``) run the same inputs
through ``parallel/collectives.py``, ``launch/dryrun.py:
dlrm_full_train_step`` and ``runtime/elastic.py: reshard_restore``, and
each rank writes what it got. The tests compare:

  * ``vocab_sharded_lookup``: output and table gradient within 1e-6, the
    gradient not scaled by the TP width;
  * the vocab-parallel cross entropy: loss within rtol 1e-5, its gradients
    too;
  * ``hierarchical_psum`` against the plain all-reduce: rtol 1e-6;
  * ``ef_int8_psum``: the int8 codes equal to the reference's, its output
    and residual within 1e-6 of their largest |value|;
  * the DLRM full-table step at the smoke config on (2, 4), two steps:
    losses within rtol 1e-5, tables and MLPs within the MLP tier, every
    data replica's table bitwise equal to the others';
  * a world-1 checkpoint restored by ``reshard_restore`` onto (2, 4): each
    rank's shard equal to the slice the reference's sharding gives that
    device;
  * a world-1 gloo ``make_host_mesh(1, 1, device="cpu")`` run of the
    full-table step: bitwise equal to the no-mesh call.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_lock import cpu_lock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
N_RANKS = 8
DLRM_STEPS = 2
LR = 0.05

REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.parallel import collectives as C
from repro.parallel.sharding import mesh_axes
from repro.models import api, dlrm
from repro.configs import get_smoke_config
from repro.optim import SGD

out_path, lr, steps = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
AT = (jax.sharding.AxisType.Auto,)
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=AT * 2)
mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=AT * 3)
rng = np.random.default_rng(0)
res = {}

# vocab-sharded lookup and its table gradient
V, D = 32, 16
tab = rng.standard_normal((V, D)).astype(np.float32)
ids = rng.integers(0, V, (4, 6)).astype(np.int32)
res["lookup_tab"], res["lookup_ids"] = tab, ids
with jax.set_mesh(mesh):
    tab_sh = jax.device_put(jnp.asarray(tab), NamedSharding(mesh, P("model", None)))
    f = lambda t: C.vocab_sharded_lookup(t, jnp.asarray(ids), mesh)
    res["lookup_out"] = np.asarray(f(tab_sh))
    res["lookup_grad"] = np.asarray(jax.grad(lambda t: (f(t) ** 2).sum())(tab_sh))

# vocab-parallel cross entropy, its value and gradients
B, S, Dm, Vp, TV = 4, 16, 8, 40, 33
x = rng.standard_normal((B, S, Dm)).astype(np.float32)
head = rng.standard_normal((Dm, Vp)).astype(np.float32)
labels = rng.integers(0, TV, (B, S)).astype(np.int32)
res["xent_x"], res["xent_head"], res["xent_labels"] = x, head, labels
with jax.set_mesh(mesh):
    head_sh = jax.device_put(jnp.asarray(head), NamedSharding(mesh, P(None, "model")))
    lf = lambda x_, h_: C.sharded_xent_loss(x_, h_, jnp.asarray(labels), true_vocab=TV,
                                            seq_chunk=8)
    loss, (gx, gh) = jax.jit(jax.value_and_grad(lf, argnums=(0, 1)))(jnp.asarray(x), head_sh)
res["xent_loss"], res["xent_gx"], res["xent_gh"] = float(loss), np.asarray(gx), np.asarray(gh)

# the gradient syncs on (2, 2, 2)
g = rng.standard_normal((8, 4)).astype(np.float32)
res["sync_g"] = g
spec = P(("pod", "data"), None)
with jax.set_mesh(mesh3):
    f_h = jax.shard_map(C.hierarchical_psum, mesh=mesh3, in_specs=spec, out_specs=spec)
    f_p = jax.shard_map(lambda v: jax.lax.psum(v, ("pod", "data")), mesh=mesh3,
                        in_specs=spec, out_specs=spec)
    f_q = jax.shard_map(lambda gg, ee: C.ef_int8_psum(gg, ee), mesh=mesh3,
                        in_specs=(spec, P()), out_specs=(spec, spec))
    res["hier_out"] = np.asarray(f_h(jnp.asarray(g)))
    res["plain_out"] = np.asarray(f_p(jnp.asarray(g)))
    q_out, q_err = f_q(jnp.asarray(g), jnp.zeros((), jnp.float32))
    res["ef_out"], res["ef_err"] = np.asarray(q_out), np.asarray(q_err)

# the DLRM full-table SGD step at the smoke config on (2, 4)
cfg = get_smoke_config("dlrm-scratchpipe")
params = dlrm.init_full(cfg, jax.random.key(0))
res["dlrm_tables0"] = np.asarray(params["tables"])
for part in ("bottom", "top"):
    for i, lyr in enumerate(params["mlps"][part]):
        res[f"dlrm_mlp0_{part}_{i}_w"] = np.asarray(lyr["w"])
        res[f"dlrm_mlp0_{part}_{i}_b"] = np.asarray(lyr["b"])
Bd, T, L = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
opt = SGD()
def train_step(p, batch):
    loss, grads = jax.value_and_grad(lambda q: dlrm.loss_full_tables(q, cfg, batch, mesh))(p)
    p, _ = opt.step(p, grads, (), lr)
    return p, loss
with jax.set_mesh(mesh):
    step = jax.jit(train_step)
    for s in range(steps):
        batch = {"dense": rng.standard_normal((Bd, cfg.num_dense_features)).astype(np.float32),
                 "label": (rng.random(Bd) < 0.5).astype(np.float32),
                 "sparse_ids": rng.integers(0, cfg.rows_per_table, (Bd, T, L)).astype(np.int32)}
        for k, v in batch.items():
            res[f"dlrm_batch{s}_{k}"] = v
        params, loss = step(params, {k: jnp.asarray(v) for k, v in batch.items()})
        res[f"dlrm_loss{s}"] = float(loss)
res["dlrm_tables"] = np.asarray(params["tables"])
for part in ("bottom", "top"):
    for i, lyr in enumerate(params["mlps"][part]):
        res[f"dlrm_mlp_{part}_{i}_w"] = np.asarray(lyr["w"])
        res[f"dlrm_mlp_{part}_{i}_b"] = np.asarray(lyr["b"])

# where the reference's param specs put each slice on (2, 4): per leaf and
# device position (d, m), the (start, stop) of every dim
cfg_lm = get_smoke_config("chatglm3-6b")
specs = api.param_specs(cfg_lm, mesh_axes(mesh))
shapes = jax.eval_shape(lambda k: api.init(cfg_lm, k, mesh_axes(mesh)), jax.random.key(0))
slices = {}
is_p = lambda v: isinstance(v, P)
paths = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_p)[0]
shape_of = dict((jax.tree_util.keystr(k), v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0])
for kp, sp in paths:
    key = jax.tree_util.keystr(kp)
    idx = NamedSharding(mesh, sp).devices_indices_map(shape_of[key])
    pos = {dev: (int(i), int(j)) for (i, j), dev in np.ndenumerate(mesh.devices)}
    slices[key] = {f"{pos[dev][0]},{pos[dev][1]}":
                   [[s.start or 0, s.stop if s.stop is not None else n]
                    for s, n in zip(ix, shape_of[key])] for dev, ix in idx.items()}
res["reshard_slices"] = np.array(json.dumps(slices))
np.savez(out_path, **res)
print("REF-OK")
"""


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: runs every check's port side and saves what it got."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import dlrm_full_train_step
    from repro_torch.models import dlrm
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.runtime.elastic import reshard_restore

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    out = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")

    # vocab-sharded lookup: the ids are data-sharded (4 rows over 2), the
    # table row-sharded over "model" (32 rows over 4)
    tab = torch.from_numpy(ref["lookup_tab"])
    ids = torch.from_numpy(ref["lookup_ids"])[2 * d:2 * d + 2]
    shard = local_shard(tab, P("model", None), mesh).clone().requires_grad_(True)
    emb = C.vocab_sharded_lookup(shard, ids, mesh)
    # the loss of the global batch: this rank's addend, summed over "data"
    # by the gradient's own sum below
    (g_shard,) = torch.autograd.grad((emb ** 2).sum(), shard)
    out["lookup_out"] = emb.detach().numpy()
    out["lookup_grad"] = C.all_reduce(g_shard, mesh, "data").numpy()

    # the vocab-parallel cross entropy: x, labels data-sharded, the head a
    # column shard over "model"
    x = torch.from_numpy(ref["xent_x"])[2 * d:2 * d + 2].clone().requires_grad_(True)
    head = local_shard(torch.from_numpy(ref["xent_head"]), P(None, "model"),
                       mesh).clone().requires_grad_(True)
    labels = torch.from_numpy(ref["xent_labels"])[2 * d:2 * d + 2]
    loss = C.sharded_xent_loss(x, head, labels, true_vocab=33, seq_chunk=8, mesh=mesh)
    gx, gh = torch.autograd.grad(loss, (x, head))
    # the global mean is the mean of the two data shards' means (equal sizes)
    out["xent_loss"] = (C.all_reduce(loss.detach(), mesh, "data") / 2).numpy()
    out["xent_gx"] = (gx / 2).numpy()
    out["xent_gh"] = (C.all_reduce(gh, mesh, "data") / 2).numpy()

    # the syncs on (2, 2, 2): rows over ("pod", "data"), 2 rows a block
    mesh3 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    pd = mesh3.get_local_rank("pod") * 2 + mesh3.get_local_rank("data")
    g = torch.from_numpy(ref["sync_g"])[2 * pd:2 * pd + 2].clone()
    C.reset_collective_records()
    out["hier_out"] = C.hierarchical_psum(g, mesh3).numpy()
    out["hier_records"] = np.array(json.dumps(C.collective_records()))
    out["plain_out"] = C.psum_tree_hierarchical([g], mesh=mesh3, mode="plain")[0][0].numpy()
    codes = []
    ef_out, ef_err = C.ef_int8_psum(g, None, mesh3, codes=codes)
    out["ef_out"], out["ef_err"], out["ef_codes"] = ef_out.numpy(), ef_err.numpy(), codes[0].numpy()
    tree_out, tree_err = C.psum_tree_hierarchical({"a": g}, mesh=mesh3, mode="ef_int8")
    out["ef_tree_equal"] = np.array(bool(torch.equal(tree_out["a"], ef_out)
                                         and torch.equal(tree_err["a"], ef_err)))

    # the DLRM full-table step on (2, 4)
    cfg = get_smoke_config("dlrm-scratchpipe")
    mlps = {part: [{"w": ref[f"dlrm_mlp0_{part}_{i}_w"], "b": ref[f"dlrm_mlp0_{part}_{i}_b"]}
                   for i in range(len(getattr(cfg, f"{part}_mlp")))]
            for part in ("bottom", "top")}
    model = dlrm.DLRM(cfg)
    model.load_state_dict(convert.mlps_from_reference(mlps))
    tables = local_shard(torch.from_numpy(ref["dlrm_tables0"]), P("model", None), mesh).clone()
    params = {"tables": tables, "mlps": model}
    Bd = cfg.batch_size // 2
    for s in range(DLRM_STEPS):
        batch = {k: torch.from_numpy(ref[f"dlrm_batch{s}_{k}"])[Bd * d:Bd * (d + 1)]
                 for k in ("dense", "label", "sparse_ids")}
        params, loss = dlrm_full_train_step(params, cfg, batch, mesh, lr=LR)
        out[f"dlrm_loss{s}"] = loss.numpy()
    out["dlrm_tables"] = params["tables"].numpy()
    replicas = C.all_gather(params["tables"], mesh, "data", tiled=False)
    out["dlrm_replicas_equal"] = np.array(bool(torch.equal(replicas[0], replicas[1])))
    for k, v in model.state_dict().items():
        out[f"dlrm_mlp_{k}"] = v.numpy()

    # reshard_restore of a world-1 checkpoint onto (2, 4)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    local, step = reshard_restore(ckpt, get_smoke_config("chatglm3-6b"), mesh)
    out["reshard_step"] = np.array(step)
    flat = convert.lm_params_to_reference(local)
    for k, v in _flat(flat).items():
        out[f"reshard:{k}"] = v

    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree}


def _spawn(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(N_RANKS, tmp), nprocs=N_RANKS, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and each port rank's, as dicts of arrays."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    tmp = str(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c", REF_SCRIPT, os.path.join(tmp, "ref.npz"),
                            str(LR), str(DLRM_STEPS)],
                           capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0 and "REF-OK" in r.stdout, r.stderr[-3000:]
    # the world-1 checkpoint: chatglm3-6b smoke params from a seed
    params = api.init(get_smoke_config("chatglm3-6b"), torch.Generator().manual_seed(3))
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    ckpt.save(7, params)
    ckpt.wait()
    with cpu_lock(tmp):
        r = subprocess.run([sys.executable, "-c",
                            "import sys; sys.path.insert(0, sys.argv[2]); "
                            "import test_torch_mesh as t; t._spawn(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    ranks = [dict(np.load(os.path.join(tmp, f"rank{i}.npz"))) for i in range(N_RANKS)]
    from repro_torch import convert

    return {"ref": ref, "ranks": ranks, "params": convert.lm_params_to_reference(params)}


def _coords(rank: int):
    return rank // 4, rank % 4  # (data, model) on the (2, 4) mesh


def test_vocab_sharded_lookup_and_its_gradient(runs):
    ref = runs["ref"]
    for rank, got in enumerate(runs["ranks"]):
        d, m = _coords(rank)
        np.testing.assert_allclose(got["lookup_out"], ref["lookup_out"][2 * d:2 * d + 2],
                                   atol=1e-6)
        # the shard's rows of the whole gradient: not scaled by the TP width
        np.testing.assert_allclose(got["lookup_grad"], ref["lookup_grad"][8 * m:8 * m + 8],
                                   atol=1e-6)
    tab, ids = ref["lookup_tab"], ref["lookup_ids"]
    want = np.zeros_like(tab)
    np.add.at(want, ids.reshape(-1), 2 * tab[ids.reshape(-1)])
    np.testing.assert_allclose(ref["lookup_grad"], want, atol=1e-5)


def test_vocab_parallel_xent(runs):
    ref = runs["ref"]
    for rank, got in enumerate(runs["ranks"]):
        d, m = _coords(rank)
        np.testing.assert_allclose(got["xent_loss"], ref["xent_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["xent_gx"], ref["xent_gx"][2 * d:2 * d + 2],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["xent_gh"], ref["xent_gh"][:, 10 * m:10 * m + 10],
                                   rtol=1e-5, atol=1e-7)


def test_hierarchical_psum_equals_the_plain_sum(runs):
    ref = runs["ref"]
    for rank, got in enumerate(runs["ranks"]):
        pd = rank // 2  # (pod, data, model) = (2, 2, 2): rows over pod * 2 + data
        np.testing.assert_allclose(got["hier_out"], got["plain_out"], rtol=1e-6)
        np.testing.assert_allclose(got["hier_out"], ref["hier_out"][2 * pd:2 * pd + 2],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["plain_out"], ref["plain_out"][2 * pd:2 * pd + 2],
                                   rtol=1e-6)
        rec = json.loads(str(got["hier_records"]))
        # reduce-scatter in the pod, all-reduce across, all-gather back
        assert {k: v["count"] for k, v in rec.items()} == {
            "reduce-scatter": 1, "all-reduce": 1, "all-gather": 1}
        assert rec["all-reduce"]["bytes_in"] == 4 * 4  # 1/2 of the rank's 2 x 4 fp32


def test_ef_int8_psum_codes_output_and_residual(runs):
    ref = runs["ref"]
    g = ref["sync_g"]
    for rank, got in enumerate(runs["ranks"]):
        pod, data = rank // 4, (rank // 2) % 2
        # the in-pod reduce-scatter: this rank's row of the pod's 2 blocks
        blocks = g.reshape(2, 2, 2, 4)[pod]  # (data, rows, cols)
        shard = (blocks[0] + blocks[1])[data:data + 1]
        err = ref["ef_err"][2 * pod + data:2 * pod + data + 1]
        scale = np.float32(max(np.abs(shard).max(), np.float32(1e-8))) / np.float32(127.0)
        want_codes = np.round((shard - err) / scale).astype(np.int8)
        np.testing.assert_array_equal(got["ef_codes"], want_codes)
        pd = 2 * pod + data
        out = ref["ef_out"][2 * pd:2 * pd + 2]
        assert np.abs(got["ef_out"] - out).max() <= 1e-6 * np.abs(out).max()
        assert np.abs(got["ef_err"] - err).max() <= 1e-6 * max(np.abs(err).max(), 1e-30)
        assert bool(got["ef_tree_equal"])


def test_dlrm_full_table_step_on_a_2x4_mesh(runs):
    ref = runs["ref"]
    rows = ref["dlrm_tables0"].shape[0] // 4
    for rank, got in enumerate(runs["ranks"]):
        d, m = _coords(rank)
        for s in range(DLRM_STEPS):
            np.testing.assert_allclose(got[f"dlrm_loss{s}"], ref[f"dlrm_loss{s}"], rtol=1e-5)
        np.testing.assert_allclose(got["dlrm_tables"], ref["dlrm_tables"][rows * m:rows * (m + 1)],
                                   rtol=1e-5, atol=1e-6)
        assert bool(got["dlrm_replicas_equal"])
        for part, stack in (("bottom", "bottom"), ("top", "top")):
            i = 0
            while f"dlrm_mlp_{stack}.{i}.weight" in got:
                np.testing.assert_allclose(got[f"dlrm_mlp_{stack}.{i}.weight"],
                                           ref[f"dlrm_mlp_{part}_{i}_w"].T, rtol=1e-4, atol=1e-6)
                np.testing.assert_allclose(got[f"dlrm_mlp_{stack}.{i}.bias"],
                                           ref[f"dlrm_mlp_{part}_{i}_b"], rtol=1e-4, atol=1e-6)
                i += 1
            assert i > 0
    # the tables moved: the step applied an update
    assert not np.array_equal(ref["dlrm_tables"], ref["dlrm_tables0"])


def test_reshard_restore_gives_each_rank_its_slice(runs):
    ref, params = runs["ref"], runs["params"]
    slices = json.loads(str(ref["reshard_slices"]))
    whole = _flat(params)
    assert set(slices) == set(whole)
    for rank, got in enumerate(runs["ranks"]):
        d, m = _coords(rank)
        assert int(got["reshard_step"]) == 7
        for key, by_pos in slices.items():
            idx = tuple(slice(a, b) for a, b in by_pos[f"{d},{m}"])
            np.testing.assert_array_equal(got[f"reshard:{key}"], whole[key][idx], err_msg=key)


def test_world_1_gloo_mesh_step_is_the_no_mesh_call():
    """A (1, 1) gloo mesh from an in-process store: the full-table step
    through it is bitwise the call without a mesh."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import dlrm_full_train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import dlrm

    cfg = get_smoke_config("dlrm-scratchpipe")
    rng = np.random.default_rng(5)
    batches = [{"dense": torch.from_numpy(rng.standard_normal((32, 13)).astype(np.float32)),
                "label": torch.from_numpy((rng.random(32) < 0.5).astype(np.float32)),
                "sparse_ids": torch.from_numpy(rng.integers(0, 512, (32, 4, 4)).astype(np.int32))}
               for _ in range(3)]

    def run(mesh):
        params = dlrm.init_full(cfg, torch.Generator().manual_seed(0), "cpu")
        losses = []
        for b in batches:
            params, loss = dlrm_full_train_step(params, cfg, b, mesh)
            losses.append(loss)
        return torch.stack(losses), params["tables"], params["mlps"].state_dict()

    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        got = run(mesh)
    finally:
        dist.destroy_process_group()
    want = run(None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k


def test_full_table_step_trains_what_scratchpipe_trains():
    """The paper's claim at the smoke config on the CPU: the full-table step
    (the "GPU-only" baseline, the whole table as the storage, the global row
    ids as slots) gives each step's loss and the final table bitwise equal
    to the launcher's ``scratchpipe`` run from the same table, batches and
    MLP init (``chip_smoke.py`` phase 23 holds the same on the card)."""
    from repro_torch.configs.dlrm_scratchpipe import smoke_config
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.data.synthetic import TraceConfig, dlrm_batches
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import dlrm_full_train_step
    from repro_torch.models import dlrm

    cfg, steps = smoke_config(), 12
    args = train.build_parser().parse_args(
        ["--arch", "dlrm-scratchpipe", "--smoke", "--steps", str(steps), "--device", "cpu",
         "--batch", "32", "--seed", "0"])
    host = HostEmbeddingTable(cfg.total_rows, cfg.embed_dim, seed=0)
    params = {"tables": torch.from_numpy(host.data.copy()), "mlps": dlrm.DLRM(cfg, seed=0)}
    res = train.train_dlrm(args, cfg=cfg, host=host)
    want = torch.stack([st.aux["loss"] for st in res["stats"]])
    res["pipe"].flush_to_host()
    res["pipe"].close()
    tc = TraceConfig(num_tables=cfg.num_tables, rows_per_table=cfg.rows_per_table,
                     lookups_per_table=cfg.lookups_per_table, batch_size=32,
                     locality=args.locality, seed=0)
    got = []
    for _, p in dlrm_batches(tc, steps):
        batch = {"dense": torch.from_numpy(p["dense"].astype(np.float32)),
                 "label": torch.from_numpy(p["label"].astype(np.float32)),
                 "sparse_ids": torch.from_numpy(p["sparse_ids"].astype(np.int32))}
        params, loss = dlrm_full_train_step(params, cfg, batch, None, lr=args.lr)
        got.append(loss)
    assert torch.equal(torch.stack(got), want)
    assert np.array_equal(params["tables"].numpy(), res["host"].data)
