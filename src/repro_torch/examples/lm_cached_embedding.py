"""The paper's technique applied to an LM (beyond-DLRM): the token-embedding
table lives in host memory; ScratchPipe keeps the active vocabulary working
set in the device scratchpad, planned from the token stream's look-ahead.

Port of ``examples/lm_cached_embedding.py``: the llama4-scout smoke config
(largest-vocab family in the pool; the full config is the
technique-representative arch, see DESIGN.md), the same seeds and lines.
``--planner``/``--executor`` pick the runtime's planner placement and
executor (``core/pipeline.py``); ``--device cpu`` runs the plain versions.

    PYTHONPATH=src python -m repro_torch.examples.lm_cached_embedding --steps 30
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.cached_embedding import CachedEmbeddingLM
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.pipeline import ScratchPipe
from repro_torch.data.lookahead import LookaheadStream
from repro_torch.data.synthetic import sample_ids
from repro_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--cache-slots", type=int, default=192)
    ap.add_argument("--planner", choices=("host", "device"), default="host")
    ap.add_argument("--executor", choices=("sync", "overlapped"), default="sync")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    V, D = cfg.vocab_size, cfg.d_model
    host = HostEmbeddingTable(V, D, seed=0)
    lm = CachedEmbeddingLM(cfg, seed=1, lr=1e-2, device=dev)

    rng = np.random.default_rng(0)

    def stream(steps):
        for _ in range(steps):
            # zipf-ish token stream (natural language is high-locality)
            toks = sample_ids(rng, V, (args.batch, args.seq), "high")
            labels = np.roll(toks, -1, axis=1).astype(np.int32)
            yield toks, {"labels": labels}

    pipe = ScratchPipe(host, num_slots=args.cache_slots, train_fn=lm.train_fn,
                       planner=args.planner, executor=args.executor, device=dev)
    s = LookaheadStream(stream(args.steps))
    try:
        stats = pipe.run(s, lookahead_fn=s.peek_ids)
    finally:
        pipe.close()
    losses = [float(st.aux["loss"]) for st in stats]
    hit = np.mean([st.hit_rate for st in stats[6:]])
    print(
        f"steps={len(stats)} loss {losses[0]:.4f}->{losses[-1]:.4f} "
        f"plan-hit={hit:.3f} (cache = {args.cache_slots / V:.1%} of vocab)"
    )
    print(
        f"host traffic {host.traffic.total / 1e6:.2f} MB vs full-table "
        f"traffic {args.steps * args.batch * args.seq * host.row_bytes / 1e6:.2f} MB"
    )
    assert losses[-1] < losses[0]
    print("OK")
    return {"losses": losses, "plan_hit": hit, "stats": stats,
            "host_traffic_bytes": host.traffic.total}


if __name__ == "__main__":
    main()
