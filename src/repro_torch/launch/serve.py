"""Serving launcher of the port: LM prefill + decode, or the DLRM embedding
lookup tier.

Port of ``repro/launch/serve.py``. LM archs (batched prefill + greedy
decode against the KV/SSM cache: ``zamba2-1.2b``, ``mamba2-2.7b``, the
dense and vlm transformers and the MoE transformers ``mixtral-8x7b`` and
``llama4-scout-17b-a16e``; an encoder-only arch exits, as in the
reference):

    python -m repro_torch.launch.serve --arch zamba2-1.2b --batch 4 \
        --prompt-len 2048 --gen 16
    python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu

``--smoke`` takes the arch's smoke config. Weights are random, drawn from
``--seed``, as in the reference. Prints the reference's ``prefill:``,
``decode:`` and ``sample[b]:`` lines. ``--mesh D,M`` (or ``P,D,M``) serves
partitioned over a mesh, as the reference always serves under one: the
params, the prompts and the decode cache cut to each rank by the
reference's specs, on torchrun's ranks (NCCL on the card, gloo with
``--device cpu``):

    python -m torch.distributed.run --nproc-per-node 8 -m \
        repro_torch.launch.serve --arch mixtral-8x7b --smoke --device cpu --mesh 2,4

Embedding serving: request micro-batches, from a synthetic scenario or a
recorded serving trace, through a read-only cache runtime (the
queue-as-lookahead pipeline):

    python -m repro_torch.launch.serve --embedding --design scratchpipe-serve \
        --scenario inference_mix --steps 64 --depth 2
    python -m repro_torch.launch.serve --embedding --trace /path/to/trace --depth 2

A trace's manifest sets the tables, rows, dim and the scratchpad's replica
precision (a trace recorded from ``launch/train.py --precision int8
--record-trace`` serves from an int8 scratchpad). ``--design static-serve``
pins the hottest rows of the first quarter of the batches. It prints the
same ``serving``/``served``/``hit_rate=`` lines as the reference. Both
modes run on the card; ``--device cpu`` runs the kernels' plain PyTorch
versions instead. ``--metrics-out``/``--trace-out`` write the
``repro_torch.obs`` snapshot and Chrome trace (spans of the serving
runtime, the request front end and the replay's prefetch thread), as the
reference's launcher does. ``--warm-start DIR`` (``scratchpipe-serve``
only) preloads the scratchpad and the host table from the newest training
checkpoint under DIR (``launch/train.py --supervise/--ckpt-every``, either
package's) and prints ``warm start: N rows preloaded from DIR (training
step S)``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

DESIGNS = ("scratchpipe-serve", "nocache-serve", "static-serve")


def scratchpad_slots(group, batch: int, lookups: int, depth: int,
                     cache_frac: float) -> int:
    """The launcher's scratchpad size: ``cache_frac`` of all rows, but at
    least every table's worst-case working set of ``depth + 2`` in-flight
    micro-batches (paper §VI-D) — the reference launcher's rule."""
    return max(
        int(group.total_rows * cache_frac),
        sum(
            min(s.rows, group.window_floor(batch * lookups, window=depth + 2))
            for s in group.tables
        ),
    )


def run_embedding(args, *, collect_bags: bool = False, host=None) -> Dict[str, Any]:
    """Build the host table, the batches (a recorded trace's, else the
    scenario's) and the runtime from parsed ``args``, serve every batch,
    print the reference's summary lines, and return ``replay_serving``'s
    result plus the ``backend``. ``host`` replaces the host table the
    launcher would build from ``--seed`` (read only: serving never writes
    it back)."""
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup
    from repro_torch.device import resolve_device
    from repro_torch.serving import replay_serving

    resolve_device(args.device)  # fail before building tables, not after
    if args.trace:
        from repro_torch.traces.format import TraceReader

        reader = TraceReader(args.trace)
        group = reader.group
        steps = reader.num_batches if args.steps is None else min(
            args.steps, reader.num_batches
        )
        batches = [reader.batch(i)[0] for i in range(steps)]
        reader.close()
        src = f"trace {args.trace} ({steps} batches)"
    else:
        from repro_torch.traces.scenarios import scenario_batches

        group = TableGroup.uniform(args.tables, args.rows, args.dim)
        steps = args.steps if args.steps is not None else 64
        batches = [
            gids
            for gids, _ in scenario_batches(
                args.scenario,
                group,
                steps,
                batch_size=args.batch,
                lookups_per_table=args.lookups,
                seed=args.seed,
            )
        ]
        src = f"scenario {args.scenario} ({steps} batches)"

    if host is None:
        host = HostEmbeddingTable(group.total_rows, group.dim, seed=args.seed + 1)
    elif host.data.shape != (group.total_rows, group.dim):
        raise ValueError(
            f"host table {host.data.shape} != ({group.total_rows}, {group.dim})"
        )
    kwargs: Dict[str, Any] = dict(device=args.device)
    if args.design == "scratchpipe-serve":
        kwargs.update(
            num_slots=scratchpad_slots(
                group, args.batch, args.lookups, args.depth, args.cache_frac
            ),
            window=args.depth,
            table_group=group,
        )
    elif args.design == "static-serve":
        from repro_torch.traces.profiling import profile_hot_ids

        kwargs.update(
            hot_ids=profile_hot_ids(batches[: max(2, len(batches) // 4)],
                                    group, args.cache_frac)
        )
    backend = make_runtime(args.design, host, None, **kwargs)
    if args.warm_start:
        warm_start(backend, args)

    print(f"serving {src} through {args.design} at queue depth {args.depth}")
    res = replay_serving(backend, batches, depth=args.depth,
                         collect_bags=collect_bags)
    lat = res["latency"]
    print(
        f"served {res['served']} micro-batches: "
        f"p50={lat['p50_ms']:.2f}ms p99={lat['p99_ms']:.2f}ms "
        f"{res['lookups_per_s']:,.0f} lookups/s"
    )
    print(
        f"hit_rate={res['hit_rate']:.3f} "
        f"hit_lookup_rate={res['hit_lookup_rate']:.3f} "
        f"emergency_rate={res['emergency_rate']:.3f} "
        f"(post-warmup, warmup={res['warmup']})"
    )
    res["backend"] = backend
    return res


def warm_start(backend, args) -> int:
    """``--warm-start``: preload ``backend`` from the newest checkpoint under
    ``args.warm_start`` (the reference launcher's checks and line)."""
    from repro_torch.checkpoint import CheckpointManager

    if args.design != "scratchpipe-serve":
        raise SystemExit(
            "--warm-start preloads the plan-ahead scratchpad; it requires "
            "--design scratchpipe-serve"
        )
    ckpt = CheckpointManager(args.warm_start)
    if ckpt.latest_step() is None:
        raise SystemExit(
            f"--warm-start: no checkpoints under {args.warm_start} "
            "(train with --supervise/--ckpt-every to produce them)"
        )
    man = ckpt.manifest()
    arrays = {name: ckpt.restore_host(name) for name in man["host"]}
    n = backend.warm_start_from_arrays(arrays)
    print(f"warm start: {n} rows preloaded from {args.warm_start} "
          f"(training step {man['step']})")
    return n


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def kv_cache_slots(cfg, prompt_len: int, gen: int) -> int:
    """The KV cache's slots for ``gen`` tokens of decode after a prompt of
    ``prompt_len``: ``prompt_len + gen`` (``+ 1`` for the hybrid family, as
    the reference grows it), at most ``cfg.sliding_window``."""
    size = prompt_len + gen + (1 if cfg.family == "hybrid" else 0)
    return size if cfg.sliding_window is None else min(size, cfg.sliding_window)


def fit_kv_cache(cfg, cache: dict, prompt_len: int, gen: int, mesh=None) -> dict:
    """The prefill's KV cache laid out for ``gen`` tokens of decode, in
    place of ``cache``'s ``"k"``/``"v"`` (an ssm cache has none): grown
    to :func:`kv_cache_slots` slots, and under ``cfg.sliding_window`` W a
    ring with position p at slot p % size (``layers.ring_kv``). The
    reference's launcher leaves a windowed cache as its prefill cut it
    (``min(prompt_len, W)`` slots in position order), so its decode
    overwrites positions still in the window; the port repairs that
    (ROADMAP.md Queue 3). With a ``mesh``, ``cache`` is this rank's share
    (``models/api.py: make_prefill_fn(cfg, mesh)``) and so is the result,
    under the cache specs at the new size (``layers.ring_kv_share``)."""
    from repro_torch.models.layers import ring_kv, ring_kv_share

    if "k" not in cache:
        return cache
    size = kv_cache_slots(cfg, prompt_len, gen)
    for key in ("k", "v"):
        if mesh is None:
            cache[key] = ring_kv(cache[key], prompt_len, size)
        else:
            prompt_slots = min(prompt_len, cfg.sliding_window or prompt_len)
            cache[key] = ring_kv_share(cache[key], prompt_len, size, mesh, cfg.num_kv_heads,
                                       prompt_slots)
    return cache


def run_lm(args, cfg=None, params=None) -> Dict[str, Any]:
    """Port of the reference's ``_serve_lm``: random params from
    ``--seed``, the reference's synthetic prompt batch, one prefill, the KV
    cache laid out for decode by :func:`fit_kv_cache`, then ``gen - 1``
    greedy decode steps. ``cfg`` overrides the arch's config
    (same arch, e.g. another dtype or depth); ``params`` (a global tree
    for ``cfg``, padded for the mesh under ``--mesh``) replaces the drawn
    params. Prints the reference's lines
    and returns the prefill logits, the cache, the generated tokens (B,
    gen) and the host-clock times (each ended by a device
    synchronization).

    ``args.mesh`` ("D,M" or "P,D,M") serves partitioned over that mesh
    (``launch/train.py: lm_mesh``: torchrun's group, NCCL on the card and
    gloo with ``--device cpu``, else a world-1 group): every rank draws the
    global params from the seed (the model padded for the mesh) and keeps
    its shards, takes its data slice of the prompts (all of them where the
    batch does not divide over the data ranks), and holds its share of the
    cache; rank 0 prints the lines, every rank returns the whole batch's
    tokens, and its own logits, params and cache. A group this call
    started is destroyed on the way out."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if not getattr(args, "mesh", None):
        return _run_lm(args, cfg, params, dev, None)
    import torch.distributed as dist

    from repro_torch.launch.train import lm_mesh, parse_mesh

    mesh, dev, started = lm_mesh(parse_mesh(args.mesh), dev)
    try:
        return _run_lm(args, cfg, params, dev, mesh)
    finally:
        if started:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dist.destroy_process_group()


def _run_lm(args, cfg, params, dev, mesh) -> Dict[str, Any]:
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import api
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import data_index, mesh_axes

    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    shape = ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    ax = None if mesh is None else mesh_axes(mesh)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = (api.init(cfg, gen, device=dev) if mesh is None
                  else api.init(cfg, gen, device=dev, ax=ax))
    batch = api.synth_batch(cfg, shape, seed=args.seed, device=dev)
    rank, split = 0, False
    if mesh is not None:
        import torch.distributed as dist

        rank, split = dist.get_rank(), args.batch % ax.data_size == 0
        params = api.local_params(params, cfg, mesh)
        if split:
            b = args.batch // ax.data_size
            batch = {k: v[data_index(mesh) * b:(data_index(mesh) + 1) * b]
                     for k, v in batch.items()}
    slots = kv_cache_slots(cfg, args.prompt_len, args.gen)
    prefill = api.make_prefill_fn(cfg, mesh)
    decode = api.make_decode_fn(cfg, mesh, slots)

    def whole(tok):  # the whole batch's tokens, on every rank
        return tok if not split else C.gather_over_data(tok, mesh)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        cache = fit_kv_cache(cfg, cache, args.prompt_len, args.gen, mesh)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        if rank == 0:
            print(f"prefill: {prefill_s:.2f}s")
        outs = [whole(tok).cpu().numpy()]
        t1 = time.perf_counter()
        for i in range(args.gen - 1):
            tok, cache = decode(params, cache, tok, args.prompt_len + i)
            outs.append(whole(tok).cpu().numpy())
        decode_s = time.perf_counter() - t1
    steps = args.gen - 1
    generated = np.concatenate(outs, axis=1)
    if rank == 0:
        print(f"decode: {steps} steps in {decode_s:.2f}s "
              f"({decode_s / max(steps, 1) * 1e3:.1f} ms/step/batch)")
        for b in range(min(args.batch, 2)):
            print(f"  sample[{b}]: {generated[b].tolist()}")
    return {"cfg": cfg, "params": params, "logits": logits, "cache": cache,
            "tokens": generated, "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_steps": steps}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default="cuda",
        help="cuda (default; raises without a card) or cpu (plain PyTorch "
        "versions of the kernels)",
    )
    lm = ap.add_argument_group("LM serving")
    lm.add_argument("--arch", default=None,
                    help="LM arch id (zamba2-1.2b, mamba2-2.7b, chatglm3-6b, "
                    "phi-3-vision-4.2b, mixtral-8x7b, llama4-scout-17b-a16e, ...)")
    lm.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)
    lm.add_argument(
        "--mesh", default=None,
        help="serve partitioned over a D,M (data, model) or P,D,M (pod, data, "
        "model) mesh; the process group comes from torchrun's environment "
        "(NCCL on the card, gloo with --device cpu), else a world-1 group",
    )
    emb = ap.add_argument_group("embedding serving")
    emb.add_argument(
        "--embedding", action="store_true",
        help="serve the DLRM embedding lookup tier",
    )
    emb.add_argument("--design", default="scratchpipe-serve", choices=DESIGNS)
    emb.add_argument("--trace", default=None,
                     help="recorded serving trace dir (repro_torch.traces format)")
    emb.add_argument("--scenario", default="inference_mix")
    emb.add_argument("--steps", type=int, default=None)
    emb.add_argument("--depth", type=int, default=2,
                     help="queue depth = look-ahead window")
    emb.add_argument("--tables", type=int, default=4)
    emb.add_argument("--rows", type=int, default=20_000)
    emb.add_argument("--dim", type=int, default=32)
    emb.add_argument("--lookups", type=int, default=8)
    emb.add_argument("--cache-frac", type=float, default=0.25)
    emb.add_argument(
        "--warm-start", default=None,
        help="training checkpoint dir (CheckpointManager layout): preload the "
        "serving scratchpad with the trained runtime's resident set and host "
        "table, so the replica starts warm instead of cold",
    )
    ap.add_argument("--metrics-out", default=None,
                    help="write an obs_metrics/v1 JSONL snapshot here at exit")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON here at exit")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    from repro_torch.launch.train import obs_export, obs_setup

    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.embedding and args.arch is None:
        ap.error("pass --arch <id> or --embedding")
    if args.mesh:
        from repro_torch.launch.train import parse_mesh

        if args.embedding:
            ap.error("--mesh serves the LM archs")
        try:
            parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    tracer, metrics = obs_setup(args.trace_out, args.metrics_out)
    try:
        return run_embedding(args) if args.embedding else run_lm(args)
    finally:
        obs_export(
            args.trace_out, args.metrics_out, tracer, metrics,
            provenance={
                "mode": "serve",
                "design": args.design if args.embedding else args.arch,
                "depth": args.depth, "device": args.device,
                "scenario": None if args.trace else args.scenario,
            },
        )


if __name__ == "__main__":
    main()
