"""Serving every LM family that decodes partitioned over a mesh, on 8 gloo
ranks, against the reference's prefill and decode on 8 forced host
devices; and the pieces, on 4 gloo ranks, against one-rank computations.

Jax subprocesses with ``--xla_force_host_platform_device_count=8`` (the
harness of ``tests/test_torch_mesh_lm.py``) take the params from
``api.init(cfg, key(0), ax)`` (the model padded for the mesh) placed by
``tree_shardings(mesh, param_specs)``, the prompt from ``synth_batch(seed=0)``,
run the jitted ``make_prefill_fn(cfg, mesh)``, grow the cache as the
reference's ``_serve_lm`` grows it (placed by its ``cache_specs`` at the
grown size), run ``gen - 1`` jitted ``make_decode_fn(cfg, mesh)`` steps,
and write the params, the prefill logits, the tokens and the final cache
to an ``.npz``, four cells a subprocess. Then 8 gloo ranks of the port
(``torch.multiprocessing``, a ``FileStore`` in the test's own directory)
serve from the reference's params cut to each rank
(``convert.lm_params_to_rank``) through ``make_prefill_fn(cfg, mesh)``,
``launch/serve.py: fit_kv_cache`` and ``make_decode_fn(cfg, mesh)``, each
on its data slice of the prompts. Batch 4, prompt 16, gen 8 unless a cell
says otherwise:

  (a) mixtral-8x7b (2, 4), prompt 64: K = 2 kv heads at TP 4 and 64 window
      slots, so the cache is sharded over the sequence ("seq"); the ring
      wraps during decode; MoE capacity per data shard;
  (b) mixtral-8x7b (2, 2, 2), prompt 64: ("pod", "data", "model"), one
      prompt per data rank, the kv heads over "model";
  (c) chatglm3-6b (2, 4): "seq", 24 slots, 6 a rank; qkv biases, half-RoPE;
  (d) chatglm3-6b (1, 8): 4 heads padded to 8, the vocab 128 / 8, "seq"
      with 3 slots a rank;
  (e) chatglm3-6b (2, 4), gen 7: 23 slots, neither K nor S divides: the
      cache whole on every rank ("whole");
  (f) phi-3-vision-4.2b (2, 4): the patch prefix; the kv heads over "model";
  (g) llama4-scout-17b-a16e (2, 4): top-1 MoE, "seq";
  (h) zamba2-1.2b (2, 4): the shared block's kv heads over "model", the
      mamba states over d_inner and the heads, ``x0``, the ``+ 1`` slot;
  (i) mamba2-2.7b (2, 4): the tied head vocab-parallel;
  (j) mamba2-2.7b (1, 8), ``ssm_headdim=32``: the mixed layout (``conv_x``
      sharded, ``ssm`` whole);
  (k) mamba2-2.7b (2, 4), ``ssm_ngroups=2``: each rank's scan reads the
      group its heads fall in.

Cells a and b take a prompt of 64, a multiple of mixtral's 64-slot
window: the reference's launcher keeps a windowed prefill's slots in
position order, which is a ring only there (ROADMAP.md Queue 3).

The limits are those of the one-card serving tests
(``tests/test_torch_transformer.py``, ``test_torch_moe.py``,
``test_torch_lm.py``): the prefill logits over the true vocab within rtol
1e-4 / atol 1e-5; the greedy tokens (B, gen) equal; the final cache, put
back together by ``convert.lm_cache_from_ranks``, within rtol 1e-4 / atol
1e-5. Besides: every rank holds the whole batch's tokens and ranks that
hold the same block of a cache leaf hold it bit for bit (its data or model
replicas), every model rank of a data shard the same logits; each rank's
param + cache bytes are ``launch/dryrun.py: tree_bytes_per_device`` of the
param and cache specs at the grown size; the plain flash and SSD versions
ran and no kernel launched. ``launch/steps.py: make_prefill_step`` and
``make_serve_step`` at (2, 4) return functions whose per-rank caches have
the shapes of the specs they return.

The launcher: ``serve --arch mixtral-8x7b --smoke --device cpu --mesh 2,4
--prompt-len 64`` on 8 gloo ranks prints the reference's ``sample[b]``
tokens (from the reference's params, served by the reference at the same
mesh; at the launcher's default prompt of 32 the reference's windowed
decode overwrites keys still in the window); ``--mesh
1,1`` (a world-1 gloo group the launcher starts and destroys) is bitwise
the run without a mesh for one arch of each family.

The pieces, on 4 gloo ranks of a (1, 4) mesh against the one-rank step:
the decode attention against a KV cache sharded over the sequence, at a
ring that wraps and at a cache that does not; the sharded mamba2 decode
layer with the heads over "model" (one B / C group, or groups split two
ways) and in the mixed layout.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_lock import cpu_lock
from test_torch_mesh_lm import SRC, _flat, _nested

N_RANKS, BATCH, PROMPT, GEN = 8, 4, 16, 8
#: cell -> (arch, mesh shape, config overrides, batch, prompt, gen)
CELLS = {
    "a": ("mixtral-8x7b", (2, 4), {}, BATCH, 64, GEN),
    "b": ("mixtral-8x7b", (2, 2, 2), {}, BATCH, 64, GEN),
    "c": ("chatglm3-6b", (2, 4), {}, BATCH, PROMPT, GEN),
    "d": ("chatglm3-6b", (1, 8), {}, BATCH, PROMPT, GEN),
    "e": ("chatglm3-6b", (2, 4), {}, BATCH, PROMPT, 7),
    "f": ("phi-3-vision-4.2b", (2, 4), {}, BATCH, PROMPT, GEN),
    "g": ("llama4-scout-17b-a16e", (2, 4), {}, BATCH, PROMPT, GEN),
    "h": ("zamba2-1.2b", (2, 4), {}, BATCH, PROMPT, GEN),
    "i": ("mamba2-2.7b", (2, 4), {}, BATCH, PROMPT, GEN),
    "j": ("mamba2-2.7b", (1, 8), {"ssm_headdim": 32}, BATCH, PROMPT, GEN),
    "k": ("mamba2-2.7b", (2, 4), {"ssm_ngroups": 2}, BATCH, PROMPT, GEN),
}
#: the launcher's cell: its defaults (batch 4, gen 16, seed 0) but a prompt
#: of 64, a multiple of the window (cells a and b)
LAUNCHER = ("mixtral-8x7b", (2, 4), {}, 4, 64, 16)
#: each cell's KV layout over "model" (``layers.kv_layout``)
LAYOUTS = {"a": "seq", "b": "heads", "c": "seq", "d": "seq", "e": "whole", "f": "heads",
           "g": "seq", "h": "heads"}
#: the cells of each reference subprocess, run side by side (each well
#: inside its 120 s)
REF_GROUPS = ("abcL", "defg", "hijk")

REF_SCRIPT = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.models import api
from repro.parallel.sharding import mesh_axes, tree_shardings

out_path, cells = sys.argv[1], json.loads(sys.argv[2])
res = {}

def put(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[f"{prefix}|{jax.tree_util.keystr(kp)}"] = np.asarray(v)

for cell, (arch, shape, over, B, prompt, gen) in cells.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = jax.make_mesh(tuple(shape), names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    with jax.set_mesh(mesh):
        ax = mesh_axes(mesh)
        params = jax.tree.map(jax.device_put, api.init(cfg, jax.random.key(0), ax),
                              tree_shardings(mesh, api.param_specs(cfg, ax)))
        put(f"{cell}|params", params)
        batch = api.synth_batch(cfg, ShapeSpec("serve", prompt, B, "prefill"), seed=0)
        logits, cache = jax.jit(api.make_prefill_fn(cfg, mesh))(params, batch)
        # _serve_lm's growth, then the cache placed by its specs at that size
        size = prompt
        if "k" in cache and cfg.family != "ssm" and cfg.sliding_window is None:
            pad = gen + (1 if cfg.family == "hybrid" else 0)
            size = prompt + pad
            cache = jax.tree.map(np.asarray, cache)
            for name in ("k", "v"):
                cache[name] = np.pad(cache[name], ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
        cache = jax.tree.map(jax.device_put, cache,
                             tree_shardings(mesh, api.cache_specs(cfg, ax, B, size)))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        outs = [np.asarray(tok)]
        decode = jax.jit(api.make_decode_fn(cfg, mesh), donate_argnums=(1,))
        for i in range(gen - 1):
            tok, cache = decode(params, cache, tok, jnp.int32(prompt + i))
            outs.append(np.asarray(tok))
        res[f"{cell}|logits"] = np.asarray(logits)
        res[f"{cell}|tokens"] = np.concatenate(outs, axis=1)
        put(f"{cell}|cache", cache)
np.savez(out_path, **res)
print("REF-OK")
"""


def _spec(cell):
    return LAUNCHER if cell == "L" else CELLS[cell]


def _cfg(cell):
    from repro_torch.configs import get_smoke_config

    arch, _, over, *_ = _spec(cell)
    return dataclasses.replace(get_smoke_config(arch), **over)


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _bytes(tree) -> int:
    from repro_torch.optim.optimizers import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _cell_rank(cell, mesh, ref, out) -> None:
    """One cell's prefill and decode on this rank; what it got goes into
    ``out``."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import tree_bytes_per_device
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import data_index, mesh_axes

    arch, shape, _, B, prompt, gen = CELLS[cell]
    cfg, ax = _cfg(cell), mesh_axes(mesh)
    slots = serve.kv_cache_slots(cfg, prompt, gen)
    params = convert.lm_params_to_rank(_nested(ref, f"{cell}|params"), cfg, mesh)
    batch = api.synth_batch(cfg, ShapeSpec("serve", prompt, B, "prefill"), seed=0)
    b = B // ax.data_size
    batch = {k: v[data_index(mesh) * b:(data_index(mesh) + 1) * b] for k, v in batch.items()}
    prefill, decode = api.make_prefill_fn(cfg, mesh), api.make_decode_fn(cfg, mesh, slots)

    plain = {"ssd_chunk_scan_ref": [], "flash_attention_ref": []}
    real = {n: getattr(kref, n) for n in plain}

    def spy(name):
        def call(*a, **k):
            plain[name].append(1)
            return real[name](*a, **k)
        return call

    for n in plain:
        setattr(kref, n, spy(n))
    ops.reset_launch_counts()
    try:
        with torch.inference_mode():
            logits, cache = prefill(params, batch)
            cache = serve.fit_kv_cache(cfg, cache, prompt, gen, mesh)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks = [tok]
            for i in range(gen - 1):
                tok, cache = decode(params, cache, tok, prompt + i)
                toks.append(tok)
            tokens = C.gather_over_data(torch.cat(toks, dim=1), mesh)
    finally:
        for n, fn in real.items():
            setattr(kref, n, fn)
    out[f"{cell}|launches"] = np.array(sum(ops.launch_counts().values()))
    for n, calls in plain.items():
        out[f"{cell}|{n}_calls"] = np.array(len(calls))
    out[f"{cell}|logits"] = logits.numpy()
    out[f"{cell}|tokens"] = tokens.numpy()
    for j, t in enumerate(tree_leaves(cache)):
        out[f"{cell}|cache|{j}"] = t.numpy()
    out[f"{cell}|held_bytes"] = np.array(_bytes(params) + _bytes(cache))
    out[f"{cell}|held_bytes_dryrun"] = np.array(
        tree_bytes_per_device(api.param_specs(cfg, ax), api.abstract_params(cfg, ax), ax)
        + tree_bytes_per_device(api.cache_specs(cfg, ax, B, slots),
                                api.abstract_cache(cfg, B, slots, ax), ax))


#: the steps' spec-and-shape check at (2, 4): one arch of each family kind
STEP_ARCHS = ("chatglm3-6b", "mixtral-8x7b", "zamba2-1.2b", "mamba2-2.7b")


def _steps_rank(mesh, out) -> None:
    """``make_prefill_step`` / ``make_serve_step`` at (2, 4): the per-rank
    cache of each function against the shapes its specs give."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve, steps as S
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel.sharding import (data_index, local_shard, mesh_axes,
                                               spec_leaves)

    ax = mesh_axes(mesh)
    for arch in STEP_ARCHS:
        cfg = get_smoke_config(arch)
        gen = torch.Generator().manual_seed(0)
        params = api.local_params(api.init(cfg, gen, ax=ax), cfg, mesh)
        pre_shape = ShapeSpec("serve", PROMPT, BATCH, "prefill")
        slots = serve.kv_cache_slots(cfg, PROMPT, GEN)
        pre, pre_specs = S.make_prefill_step(cfg, mesh, pre_shape)
        dec, dec_specs = S.make_serve_step(cfg, mesh, ShapeSpec("serve", slots, BATCH,
                                                                "decode"))
        b = BATCH // ax.data_size
        batch = {k: v[data_index(mesh) * b:(data_index(mesh) + 1) * b]
                 for k, v in api.synth_batch(cfg, pre_shape).items()}

        def shapes(specs, seq):
            whole = api.abstract_cache(cfg, BATCH, seq, ax)
            return [list(local_shard(t, sp, mesh).shape)
                    for (_, sp), t in zip(spec_leaves(specs), tree_leaves(whole))]

        with torch.inference_mode():
            _, cache = pre(params, batch)
            got_pre = [list(t.shape) for t in tree_leaves(cache)]
            cache = serve.fit_kv_cache(cfg, cache, PROMPT, GEN, mesh)
            tok, cache = dec(params, cache, batch["tokens"][:, -1:], PROMPT)
        out[f"steps|{arch}"] = {
            "prefill": got_pre, "prefill_specs": shapes(pre_specs["cache"], PROMPT),
            "decode": [list(t.shape) for t in tree_leaves(cache)],
            "decode_specs": shapes(dec_specs["cache"], slots),
            "params_follow_specs": all(
                list(t.shape) == list(local_shard(w, sp, mesh).shape)
                for (_, sp), t, w in zip(spec_leaves(pre_specs["params"]),
                                         tree_leaves(params),
                                         tree_leaves(api.abstract_params(cfg, ax)))),
            "tokens": list(tok.shape)}


def _init_gloo(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    torch.set_num_threads(1)


def _load_ref(tmp: str) -> dict:
    ref = {}
    for g in REF_GROUPS:
        ref.update(dict(np.load(os.path.join(tmp, f"ref_{g}.npz"))))
    return ref


def _rank(rank: int, world: int, tmp: str) -> None:
    """One gloo rank: every cell's port side, the steps' check and the
    launcher at (2, 4), saved for the test process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.launch import serve

    _init_gloo(rank, world, tmp)
    ref = _load_ref(tmp)
    out = {}
    for cell, (_, shape, *_) in CELLS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=_names(shape))
        _cell_rank(cell, mesh, ref, out)
    steps = {}
    _steps_rank(init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")), steps)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    # the launcher, from the reference's params of its cell
    arch = LAUNCHER[0]
    args = serve.build_parser().parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                                            "--prompt-len", str(LAUNCHER[4]), "--mesh", "2,4"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = serve.run_lm(args, params=convert.lm_params_from_reference(
            _nested(ref, "L|params")))
    steps["launcher"] = {"printed": buf.getvalue(), "tokens": res["tokens"].tolist(),
                         "still_initialized": dist.is_initialized()}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(steps, f)
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
                            f"import test_torch_mesh_serve as t; t.{fn}(sys.argv[1])",
                            tmp, os.path.dirname(os.path.abspath(__file__))],
                           capture_output=True, text=True, env=env, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's arrays and each port rank's, as dicts."""
    tmp = str(tmp_path_factory.mktemp("mesh_serve"))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = []
    with cpu_lock(tmp):
        for g in REF_GROUPS:
            cells = json.dumps({c: _spec(c) for c in g})
            procs.append(subprocess.Popen(
                [sys.executable, "-c", REF_SCRIPT, os.path.join(tmp, f"ref_{g}.npz"), cells],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
        for p in procs:
            try:
                stdout, stderr = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            assert p.returncode == 0 and "REF-OK" in stdout, stderr[-3000:]
    _run_spawned("_spawn", tmp)
    ranks, extra = [], []
    for i in range(N_RANKS):
        ranks.append(dict(np.load(os.path.join(tmp, f"rank{i}.npz"))))
        with open(os.path.join(tmp, f"rank{i}.json")) as f:
            extra.append(json.load(f))
    return {"ref": _load_ref(tmp), "ranks": ranks, "extra": extra}


def _coords(shape, rank):
    return dict(zip(_names(shape), (int(c) for c in np.unravel_index(rank, tuple(shape)))))


def _data_rows(shape, rank, B):
    """The prompts (rows of the batch) the rank at ``rank`` serves."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel.sharding import data_index, mesh_axes

    mesh = AbstractMesh(shape, _names(shape))
    b = B // mesh_axes(mesh).data_size
    i = data_index(mesh, _coords(shape, rank))
    return slice(i * b, (i + 1) * b)


def _cache_leaves(runs, cell, rank):
    got = runs["ranks"][rank]
    n = sum(1 for k in got if k.startswith(f"{cell}|cache|"))
    return [got[f"{cell}|cache|{j}"] for j in range(n)]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_prefill_logits_match_the_reference(runs, cell):
    """Each rank's logits, of its data shard, over the true vocab within
    rtol 1e-4 / atol 1e-5 of the reference's rows (the padded vocab
    columns -inf in both)."""
    arch, shape, _, B, *_ = CELLS[cell]
    V = _cfg(cell).vocab_size
    want = runs["ref"][f"{cell}|logits"]
    for rank, got in enumerate(runs["ranks"]):
        g = got[f"{cell}|logits"]
        w = want[_data_rows(shape, rank, B)]
        assert g.shape == w.shape, (cell, rank, g.shape, w.shape)
        np.testing.assert_allclose(g[:, :V], w[:, :V], rtol=1e-4, atol=1e-5,
                                   err_msg=f"cell {cell} rank {rank}")
        assert np.isneginf(g[:, V:]).all() and np.isneginf(w[:, V:]).all()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_greedy_tokens_equal_the_reference(runs, cell):
    """Every rank holds the whole batch's (B, gen) greedy tokens, equal to
    the reference's."""
    _, _, _, B, _, gen = CELLS[cell]
    want = runs["ref"][f"{cell}|tokens"]
    assert want.shape == (B, gen)
    for rank, got in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(got[f"{cell}|tokens"], want,
                                      err_msg=f"cell {cell} rank {rank}")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_final_cache_matches_the_reference(runs, cell):
    """The ranks' cache shares after decode, put back together
    (``convert.lm_cache_from_ranks``), within rtol 1e-4 / atol 1e-5 of the
    reference's final cache, leaf by leaf."""
    from repro_torch import convert
    from repro_torch.launch import serve

    _, shape, _, B, prompt, gen = CELLS[cell]
    cfg = _cfg(cell)
    got = convert.lm_cache_from_ranks([_cache_leaves(runs, cell, r) for r in range(N_RANKS)],
                                      cfg, shape, _names(shape), B,
                                      serve.kv_cache_slots(cfg, prompt, gen))
    g, w = _flat(got), _flat(_nested(runs["ref"], f"{cell}|cache"))
    assert set(g) == set(w), (cell, sorted(set(g) ^ set(w)))
    for k in w:
        assert g[k].shape == w[k].shape, (cell, k, g[k].shape, w[k].shape)
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5, err_msg=f"{cell} {k}")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cache_conversions_round_trip(runs, cell):
    """The reference's final cache cut to every rank's share
    (``convert.lm_cache_to_rank`` at each rank's coordinates) and put back
    together (``convert.lm_cache_from_ranks``) is the reference's cache,
    bit for bit; each share has the shape of the rank's share in the run."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.optim.optimizers import tree_leaves

    _, shape, _, B, prompt, gen = CELLS[cell]
    cfg, names = _cfg(cell), _names(shape)
    mesh, slots = AbstractMesh(shape, names), serve.kv_cache_slots(cfg, prompt, gen)
    want = _nested(runs["ref"], f"{cell}|cache")
    shares = [convert.lm_cache_to_rank(want, cfg, mesh, B, slots, coords=_coords(shape, r))
              for r in range(N_RANKS)]
    for r, share in enumerate(shares):
        assert [tuple(t.shape) for t in tree_leaves(share)] == [
            a.shape for a in _cache_leaves(runs, cell, r)], (cell, r)
    got = _flat(convert.lm_cache_from_ranks(shares, cfg, shape, names, B, slots))
    w = _flat(want)
    assert set(got) == set(w) and all(np.array_equal(got[k], w[k]) for k in w), cell


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_replicas_are_bitwise_equal(runs, cell):
    """Ranks that hold the same block of a cache leaf under its spec (its
    replicas over the data or the model axes) hold it bit for bit; the
    model ranks of a data shard hold the same logits; every rank the same
    tokens."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import mesh_axes, spec_axes, spec_leaves

    _, shape, _, B, prompt, gen = CELLS[cell]
    ax = mesh_axes(AbstractMesh(shape, _names(shape)))
    specs = spec_leaves(api.cache_specs(_cfg(cell), ax, B,
                                        serve.kv_cache_slots(_cfg(cell), prompt, gen)))
    ranks = runs["ranks"]
    for j, (_, spec) in enumerate(specs):
        named = set(spec_axes(spec))
        owners = {}
        for r in range(N_RANKS):
            key = tuple(v for a, v in _coords(shape, r).items() if a in named)
            owners.setdefault(key, []).append(r)
        for group in owners.values():
            for r in group[1:]:
                assert np.array_equal(ranks[r][f"{cell}|cache|{j}"],
                                      ranks[group[0]][f"{cell}|cache|{j}"]), (cell, j, r)
    for r in range(N_RANKS):
        first = _coords(shape, r)
        first["model"] = 0
        r0 = int(np.ravel_multi_index(tuple(first[a] for a in _names(shape)), shape))
        assert np.array_equal(ranks[r][f"{cell}|logits"], ranks[r0][f"{cell}|logits"])
        assert np.array_equal(ranks[r][f"{cell}|tokens"], ranks[0][f"{cell}|tokens"])
    if cell in LAYOUTS:  # the KV cache lies over "model" as the cell says
        k_spec = dict(specs)[("k",)]
        where = {3: "heads", 2: "seq"}
        assert next((where[d] for d in where if k_spec[d] == "model"), "whole") == LAYOUTS[cell]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_held_bytes_and_the_plain_path(runs, cell):
    """Each rank's param + cache bytes are the dry run's
    (``tree_bytes_per_device`` of the param specs and the cache specs at
    the grown size); on the CPU the plain flash and SSD versions ran (one
    prefill's worth: one a layer, none in decode) and no kernel launched."""
    cfg = _cfg(cell)
    for rank, got in enumerate(runs["ranks"]):
        assert int(got[f"{cell}|held_bytes"]) == int(got[f"{cell}|held_bytes_dryrun"]), rank
        assert int(got[f"{cell}|launches"]) == 0
        if cfg.family == "ssm":
            want = {"ssd_chunk_scan_ref": cfg.num_layers, "flash_attention_ref": 0}
        elif cfg.family == "hybrid":
            want = {"ssd_chunk_scan_ref": cfg.hybrid_groups * cfg.hybrid_layers_per_group
                    + cfg.hybrid_tail_layers, "flash_attention_ref": cfg.hybrid_groups}
        else:
            want = {"ssd_chunk_scan_ref": 0, "flash_attention_ref": cfg.num_layers}
        assert {n: int(got[f"{cell}|{n}_calls"]) for n in want} == want, (cell, rank)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_prefill_and_serve_steps_follow_their_specs(runs, arch):
    """``make_prefill_step`` and ``make_serve_step`` at (2, 4): every rank's
    params have the shapes of the param specs returned, the prefill's
    cache those of the cache specs at the prompt, and the decode step,
    against the cache grown by ``fit_kv_cache``, keeps those of the cache
    specs at the grown size; the step's tokens are the rank's data shard."""
    for rank, extra in enumerate(runs["extra"]):
        got = extra[f"steps|{arch}"]
        assert got["params_follow_specs"], rank
        assert got["prefill"] == got["prefill_specs"], (rank, got)
        assert got["decode"] == got["decode_specs"], (rank, got)
        assert got["tokens"] == [BATCH // 2, 1]


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
def test_launcher_mesh_prints_the_reference_tokens(runs):
    """``serve --arch mixtral-8x7b --smoke --device cpu --mesh 2,4
    --prompt-len 64`` on 8 gloo ranks, from the reference's params: rank 0 alone prints the
    reference's lines, the ``sample[b]`` tokens the reference's at the same
    mesh; every rank returns the whole batch's tokens; the group the test
    started stays up (the launcher destroys only its own)."""
    want = runs["ref"]["L|tokens"]
    for rank, extra in enumerate(runs["extra"]):
        got = extra["launcher"]
        assert np.array_equal(np.array(got["tokens"]), want), rank
        assert got["still_initialized"]
        lines = got["printed"].splitlines()
        if rank:
            assert not lines, (rank, lines)
            continue
        assert lines[0].startswith("prefill: ") and lines[1].startswith("decode: 15 steps")
        assert lines[2:] == [f"  sample[{b}]: {want[b].tolist()}" for b in range(2)]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "phi-3-vision-4.2b", "mixtral-8x7b",
                                  "zamba2-1.2b", "mamba2-2.7b"])
def test_world_1_mesh_serve_is_the_one_card_serve(arch):
    """``serve --mesh 1,1`` (a world-1 gloo group the launcher starts and
    destroys) gives the prefill logits, the greedy tokens and the final
    cache bitwise equal to the run without a mesh: every collective of a
    world-1 group is the identity and the path keeps the one-card order of
    operations (``chip_smoke.py`` phase 26 holds the same on the card
    through NCCL, at full width)."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.optim.optimizers import tree_leaves

    out = []
    for mesh in (None, "1,1"):
        argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "6"] + (["--mesh", mesh] if mesh else [])
        with contextlib.redirect_stdout(io.StringIO()):
            out.append(serve.run_lm(serve.build_parser().parse_args(argv)))
        assert not dist.is_initialized()
    one, meshed = out
    assert torch.equal(one["logits"], meshed["logits"])
    assert np.array_equal(one["tokens"], meshed["tokens"])
    a, b = tree_leaves(one["cache"]), tree_leaves(meshed["cache"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# the pieces, on 4 gloo ranks against one rank
# --------------------------------------------------------------------------- #
UNIT_RANKS = 4
#: the decode attention over a KV cache sharded over the sequence:
#: (window, slots, position) — a ring of 12 slots at position 29 (wrapped
#: twice), and a cache of 12 slots at position 7
ATTENTION = {"ring": (12, 12, 29), "grows": (None, 12, 7)}
#: mamba2's smoke layer at a model axis of 4: config overrides
MAMBA = {"heads": {}, "groups2": {"ssm_ngroups": 2}, "mixed": {"ssm_headdim": 64}}


def _close(got, want, what, tol=1e-5):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return {"what": what, "err": err, "scale": scale, "ok": err <= tol * max(scale, 1e-30)}


def _unit_attention(mesh, r, out):
    """chatglm3-6b's smoke attention (K = 2 at a model axis of 4: its cache
    over the sequence): one decode step on this rank's shards and its block
    of slots against ``attention_decode`` on one rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import local_shard, mesh_axes

    for name, (window, S, pos) in ATTENTION.items():
        cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), sliding_window=window)
        g = torch.Generator().manual_seed(5)
        p = L.init_attention(g, cfg, torch.device("cpu"))
        p = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in p.items()}
        K, hd = cfg.num_kv_heads, cfg.head_dim
        kc = torch.randn(2, S, K, hd, generator=g)
        vc = torch.randn(2, S, K, hd, generator=g)
        x = torch.randn(2, 1, cfg.d_model, generator=g)
        want, wk, wv = L.attention_decode(p, x, pos, kc.clone(), vc.clone(), cfg)
        spec = T.layer_specs(cfg, mesh_axes(mesh))["attn"]
        mine = {k: local_shard(v, spec[k], mesh).clone() for k, v in p.items()}
        n = S // UNIT_RANKS
        blk = slice(r * n, (r + 1) * n)
        got, gk, gv = L.attention_decode(mine, x, pos, kc[:, blk].clone(), vc[:, blk].clone(),
                                         cfg, mesh, kv_slots=S)
        out[f"attention_{name}"] = [
            {**_close(got, want, "output"), "layout": L.kv_layout(mesh, K, S)},
            {"what": "k block", "ok": torch.equal(gk, wk[:, blk])},
            {"what": "v block", "ok": torch.equal(gv, wv[:, blk])}]


def _unit_mamba(mesh, r, out):
    """One mamba2 smoke decode step on this rank's shards and state share
    (``mamba2.sharded_layer_decode``) against ``mamba_layer_decode`` on one
    rank: the output, and each state leaf against the rank's share of the
    one-rank state."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import mamba2 as M
    from repro_torch.parallel.sharding import local_shard, mesh_axes

    for name, over in MAMBA.items():
        cfg = dataclasses.replace(get_smoke_config("mamba2-2.7b"), **over)
        ax = mesh_axes(mesh)
        g = torch.Generator().manual_seed(6)
        p = M.init_mamba_layer(g, cfg, torch.device("cpu"))
        state = {k: torch.randn(v.shape, generator=g)
                 for k, v in M.init_mamba_state(cfg, 2).items()}
        x = torch.randn(2, 1, cfg.d_model, generator=g)
        want, wstate = M.mamba_layer_decode(cfg, p, x, state)
        pspec, sspec = M.mamba_layer_specs(cfg, ax), M.mamba_state_specs(cfg, ax, 2)
        mine = {k: local_shard(v, pspec[k], mesh).clone() for k, v in p.items()}
        share = {k: local_shard(v, sspec[k], mesh).clone() for k, v in state.items()}
        got, gstate = M.sharded_layer_decode(cfg, mine, x, share, mesh)
        out[f"mamba_{name}"] = [_close(got, want, "output")] + [
            _close(gstate[k], local_shard(wstate[k], sspec[k], mesh), k) for k in sorted(wstate)]


def _unit_rank(rank: int, world: int, tmp: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _init_gloo(rank, world, tmp)
    out = {}
    mesh = init_device_mesh("cpu", (1, UNIT_RANKS), mesh_dim_names=("data", "model"))
    with torch.inference_mode():
        _unit_attention(mesh, rank, out)
        _unit_mamba(mesh, rank, out)
    with open(os.path.join(tmp, f"unit{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_units(tmp: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_unit_rank, args=(UNIT_RANKS, tmp), nprocs=UNIT_RANKS, join=True)


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_serve_units"))
    _run_spawned("_spawn_units", tmp)
    out = []
    for r in range(UNIT_RANKS):
        with open(os.path.join(tmp, f"unit{r}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_sequence_sharded_decode_attention_against_one_rank(units, case):
    """One decode step against a KV cache of 12 slots over 4 ranks (3 a
    rank): the output within 1e-5 of the one-rank step's largest |value|
    on every rank (the softmax partials combined in rank order), and the
    new token's k and v written, bit for bit, into the block that holds
    its slot (position 29 of a ring of 12 at slot 5: rank 1's; position 7
    of a growing cache: rank 2's) and nowhere else."""
    for r, got in enumerate(units):
        checks = got[f"attention_{case}"]
        assert checks[0]["layout"] == "seq"
        bad = [c for c in checks if not c["ok"]]
        assert not bad, (r, bad)


@pytest.mark.parametrize("layout", sorted(MAMBA))
def test_sharded_mamba_decode_against_one_rank(units, layout):
    """One mamba2 decode step at a model axis of 4, the heads over "model"
    (one group read whole, or two groups split over the ranks) or in the
    mixed layout (2 heads: every rank steps both): the output and the new
    state's shares within 1e-5 of the one-rank step's."""
    for r, got in enumerate(units):
        bad = [c for c in got[f"mamba_{layout}"] if not c["ok"]]
        assert not bad, (r, bad)
