"""Quickstart: the paper's system in ~60 lines.

Builds a host-resident embedding table, wires the ScratchPipe 6-stage
pipeline around a DLRM train step, runs 40 iterations on a medium-locality
synthetic trace, and verifies the "always hits / algorithm unchanged"
property against full-table training.

Port of ``examples/quickstart.py`` (the same seeds, steps and lines; the
DLRM's MLP is drawn by torch, so the losses differ from the reference's).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.dlrm_runtime import DLRMTrainer
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.pipeline import ScratchPipe
from repro_torch.data.lookahead import LookaheadStream
from repro_torch.data.synthetic import TraceConfig, dlrm_batches
from repro_torch.device import resolve_device

STEPS = 40


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = get_smoke_config("dlrm-scratchpipe")
    tc = TraceConfig(
        num_tables=cfg.num_tables,
        rows_per_table=cfg.rows_per_table,
        lookups_per_table=cfg.lookups_per_table,
        batch_size=8,
        locality="medium",
    )
    rows = cfg.num_tables * cfg.rows_per_table

    # 1) capacity tier: the full table lives in host memory
    host = HostEmbeddingTable(rows, cfg.embed_dim, seed=1)

    # 2) the [Train] stage: any fn(storage, slots, batch) -> (storage, aux)
    trainer = DLRMTrainer(cfg, seed=0, lr=0.05, device=dev)

    # 3) ScratchPipe: a scratchpad sized at 50% of the table + look-ahead stream
    pipe = ScratchPipe(host, num_slots=1024, train_fn=trainer.train_fn, device=dev)
    stream = LookaheadStream(dlrm_batches(tc, STEPS))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()

    losses = [float(s.aux["loss"]) for s in stats]
    hits = np.mean([s.hit_rate for s in stats[6:]])
    print(f"steps={len(stats)}  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"steady-state plan hit rate: {hits:.3f}")
    print(
        f"host traffic {host.traffic.total / 1e6:.1f} MB, "
        f"pcie {pipe.pcie.total / 1e6:.1f} MB, hbm {pipe.hbm.total / 1e6:.1f} MB"
    )

    # 4) verify: identical to full-table ("GPU-only") training
    host_ref = HostEmbeddingTable(rows, cfg.embed_dim, seed=1)
    ref_trainer = DLRMTrainer(cfg, seed=0, lr=0.05, device=dev)
    storage = torch.from_numpy(host_ref.data).to(dev)
    for ids, batch in dlrm_batches(tc, STEPS):
        storage, _ = ref_trainer.train_fn(storage, ids, batch)
    err = float(np.max(np.abs(host.data - storage.cpu().numpy())))
    print(f"max |scratchpipe - full_table| = {err:.2e}  (always-hit guarantee)")
    assert err < 1e-5
    print("OK")
    return err


if __name__ == "__main__":
    main()
