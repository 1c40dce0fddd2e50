"""Serving launcher of the port: the DLRM embedding lookup tier.

Port of the ``--embedding`` mode of ``repro/launch/serve.py``: serve a
synthetic scenario's request micro-batches through a read-only cache
runtime (the queue-as-lookahead pipeline) on the card:

    python -m repro_torch.launch.serve --embedding --design scratchpipe-serve \
        --scenario inference_mix --steps 64 --depth 2

``--device cpu`` runs the kernels' plain PyTorch versions instead. It
prints the same ``serving``/``served``/``hit_rate=`` lines as the
reference. LM serving, ``--trace`` replay, ``static-serve``, warm start and
the telemetry outputs are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

DESIGNS = ("scratchpipe-serve", "nocache-serve")


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


def run_embedding(args, *, collect_bags: bool = False) -> Dict[str, Any]:
    """Build the host table, the scenario's batches and the runtime from
    parsed ``args``, serve every batch, print the reference's summary
    lines, and return ``replay_serving``'s result plus the ``backend``."""
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup
    from repro_torch.device import resolve_device
    from repro_torch.serving import replay_serving
    from repro_torch.traces.scenarios import scenario_batches

    resolve_device(args.device)  # fail before building tables, not after
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

    host = HostEmbeddingTable(group.total_rows, group.dim, seed=args.seed + 1)
    kwargs: Dict[str, Any] = dict(device=args.device)
    if args.design == "scratchpipe-serve":
        kwargs.update(
            num_slots=scratchpad_slots(
                group, args.batch, args.lookups, args.depth, args.cache_frac
            ),
            window=args.depth,
            table_group=group,
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--device", default="cuda",
        help="cuda (default; raises without a card) or cpu (plain PyTorch "
        "versions of the kernels)",
    )
    emb = ap.add_argument_group("embedding serving")
    emb.add_argument(
        "--embedding", action="store_true",
        help="serve the DLRM embedding lookup tier (the port's only mode)",
    )
    emb.add_argument("--design", default="scratchpipe-serve", choices=DESIGNS)
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
    if not args.embedding:
        ap.error("the port serves the embedding tier only: pass --embedding")
    return run_embedding(args)


if __name__ == "__main__":
    main()
