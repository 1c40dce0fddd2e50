"""End-to-end driver: train a multi-table DLRM for a few hundred steps under
ScratchPipe, comparing cache designs (selected from the
EmbeddingCacheRuntime registry) on the same trace.

Port of ``examples/train_dlrm_scratchpipe.py``, with its flags and lines.
Model: 8 embedding tables with HETEROGENEOUS row counts (Criteo-style
geometric spread, 2x between consecutive tables; ~200M embedding params)
fused into one TableGroup + MLPerf-DLRM MLPs. Each table's lookup stream
samples its own Zipf over its own row space; the scratchpad is partitioned
into per-table slot budgets. The trace is medium-locality (calibrated to
Fig. 3). ``--device cpu`` runs the kernels' plain versions; the MLPs'
initial values are torch's (both designs start from the same ones).

    PYTHONPATH=src python -m repro_torch.examples.train_dlrm_scratchpipe [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_dlrm_scratchpipe --tables 4
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm_scratchpipe import hetero_rows
from repro_torch.core.dlrm_runtime import DLRMTrainer
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.runtime import make_runtime
from repro_torch.core.table_group import TableGroup
from repro_torch.data.lookahead import LookaheadStream
from repro_torch.data.synthetic import dlrm_batches_group, hot_ids_for_group
from repro_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--locality", default="medium")
    ap.add_argument("--cache-frac", type=float, default=0.0,
                    help="0 = auto-size by the paper's §VI-D worst-case rule")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = DLRMConfig(
        name="dlrm-100m-multitable",
        table_rows=hetero_rows(args.tables, 100_000),
        batch_size=128,
        lookups_per_table=20,
    )
    group = TableGroup.from_config(cfg)
    rows = group.total_rows
    print(f"model: {cfg.param_count() / 1e6:.1f}M params "
          f"({cfg.table_bytes / 1e9:.2f} GB of embedding tables)")
    print(f"tables: {group}")

    def batches(steps):
        return dlrm_batches_group(group, steps, batch_size=cfg.batch_size,
                                  lookups_per_table=cfg.lookups_per_table,
                                  locality=args.locality)

    # scratchpad sizing, §VI-D: >= worst-case 6-batch window working set.
    # With per-table budgets the rule applies per table: size each table's
    # budget for ITS worst-case window working set.
    if args.cache_frac > 0:
        slots = int(rows * args.cache_frac)
        # even with an explicit fraction, every table's budget must cover
        # its §VI-D window floor or the planner runs out of victims
        floor = group.window_floor(cfg.batch_size * cfg.lookups_per_table)
        need = sum(min(floor, r) for r in group.rows)
        if slots < need:
            print(f"cache-frac {args.cache_frac} below the §VI-D window "
                  f"floor; growing scratchpad {slots} -> {need} slots")
            slots = need
        budgets = group.slot_budgets(slots, min_per_table=floor)
    else:
        probes = [group.split(ids) for ids, _ in batches(4)]
        budgets = [min(group.tables[t].rows,
                       int(6 * max(np.unique(p[t]).size for p in probes) * 1.1))
                   for t in range(group.num_tables)]
        slots = sum(budgets)
        print(f"scratchpad auto-sized to {slots} slots, per-table budgets "
              f"{budgets} ({slots / rows:.1%} of the rows, §VI-D rule)")

    # ---- ScratchPipe (registry-selected) ----------------------------------
    host = HostEmbeddingTable(rows, cfg.embed_dim, seed=1)
    tr = DLRMTrainer(cfg, seed=0, lr=0.05, device=dev)
    pipe = make_runtime("scratchpipe", host, tr.train_fn, num_slots=slots,
                        table_group=group, slot_budgets=budgets, device=dev)
    stream = LookaheadStream(batches(args.steps))
    t0 = time.time()
    try:
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    finally:
        pipe.close()
    dt = time.time() - t0
    losses = [float(s.aux["loss"]) for s in stats]
    print(f"[scratchpipe] {len(stats)} steps in {dt:.1f}s "
          f"({dt / len(stats) * 1e3:.1f} ms/step wall) "
          f"loss {losses[0]:.4f}->{losses[-1]:.4f} "
          f"hit={np.mean([s.hit_rate for s in stats[6:]]):.3f}")
    traffic = pipe.traffic()
    print(f"  host {traffic['host'].total / 1e6:.0f} MB | "
          f"pcie {traffic['pcie'].total / 1e6:.0f} MB | "
          f"hbm {traffic['hbm'].total / 1e6:.0f} MB")
    last = stats[-1]
    if last.by_table is not None:
        per = ", ".join(f"{group.tables[t].name}:{int(h)}/{int(h + m)}"
                        for t, (h, m) in enumerate(zip(last.by_table["hits"],
                                                       last.by_table["misses"])))
        print(f"  final-step per-table unique hits: {per}")

    # ---- static-cache baseline on the same trace ---------------------------
    frac = slots / rows
    host2 = HostEmbeddingTable(rows, cfg.embed_dim, seed=1)
    tr2 = DLRMTrainer(cfg, seed=0, lr=0.05, device=dev)
    sc = make_runtime("static", host2, tr2.train_fn,
                      hot_ids=hot_ids_for_group(group, frac, locality=args.locality),
                      device=dev)
    stats2 = sc.run(batches(args.steps))
    sc.flush_to_host()
    losses2 = [float(s.aux["loss"]) for s in stats2]
    print(f"[static]      hit={np.mean([s.hit_rate for s in stats2]):.3f} "
          f"host {host2.traffic.total / 1e6:.0f} MB "
          f"(ScratchPipe moved {host.traffic.total / max(host2.traffic.total, 1):.2f}x "
          f"of static's host traffic)")
    # same algorithm: loss trajectories coincide (bit-tight equivalence is
    # asserted in tests/test_torch_table_group.py)
    err = max(abs(a - b) for a, b in zip(losses[:10], losses2[:10]))
    print(f"max loss diff over first 10 steps = {err:.2e} (same algorithm)")
    return {"losses": losses, "static_losses": losses2, "max_loss_diff": err,
            "slots": slots, "budgets": budgets}


if __name__ == "__main__":
    main()
