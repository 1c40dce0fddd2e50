"""Serving launcher of the port: LM prefill + decode, or the DLRM embedding
lookup tier.

Port of ``repro/launch/serve.py``. LM archs (batched prefill + greedy
decode against the KV/SSM cache; ``zamba2-1.2b`` so far, the others raise
with their ROADMAP item):

    python -m repro_torch.launch.serve --arch zamba2-1.2b --batch 4 \
        --prompt-len 2048 --gen 16

``--smoke`` takes the arch's smoke config. Weights are random, drawn from
``--seed``, as in the reference. Prints the reference's ``prefill:``,
``decode:`` and ``sample[b]:`` lines.

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
versions instead. Warm start and the telemetry outputs are not ported yet
(ROADMAP.md Queue 1 item 12).
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


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def run_lm(args, cfg=None) -> Dict[str, Any]:
    """Port of the reference's ``_serve_lm``: random params from
    ``--seed``, the reference's synthetic prompt batch, one prefill, the KV
    cache grown by ``gen + 1`` positions, then ``gen - 1`` greedy decode
    steps. ``cfg`` overrides the arch's config (same arch, e.g. another
    dtype). Prints the reference's lines and returns the prefill logits,
    the cache, the generated tokens (B, gen) and the host-clock times (each
    ended by a device synchronization)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.device import resolve_device
    from repro_torch.models import api

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init(cfg, gen, device=dev)
    batch = api.synth_batch(cfg, shape, seed=args.seed, device=dev)
    prefill = api.make_prefill_fn(cfg)
    decode = api.make_decode_fn(cfg)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        # grow the KV caches to the full generation length (the reference
        # grows a hybrid cache by gen + 1)
        cache["k"] = F.pad(cache["k"], (0, 0, 0, 0, 0, args.gen + 1))
        cache["v"] = F.pad(cache["v"], (0, 0, 0, 0, 0, args.gen + 1))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        print(f"prefill: {prefill_s:.2f}s")
        outs = [tok.cpu().numpy()]
        t1 = time.perf_counter()
        for i in range(args.gen - 1):
            tok, cache = decode(params, cache, tok, args.prompt_len + i)
            outs.append(tok.cpu().numpy())
        decode_s = time.perf_counter() - t1
    steps = args.gen - 1
    generated = np.concatenate(outs, axis=1)
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
    lm.add_argument("--arch", default=None, help="LM arch id (zamba2-1.2b)")
    lm.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)
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
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.embedding:
        return run_embedding(args)
    if args.arch is None:
        ap.error("pass --arch <id> or --embedding")
    return run_lm(args)


if __name__ == "__main__":
    main()
