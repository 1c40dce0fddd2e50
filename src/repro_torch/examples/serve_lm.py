"""Serve a small LM with batched requests: prefill a prompt batch, then
stream greedy decode steps against the KV/SSM cache.

Port of ``examples/serve_lm.py``: works for every decodable arch (reduced
smoke configs), random params from a seeded generator (torch's, so the
generated ids differ from the reference's). The prefill's KV cache is laid
out for decode by ``launch/serve.py: fit_kv_cache`` (grown by ``--gen``
slots, or a ring under a sliding window), where the reference pads it by
``--gen`` slots only when there is no window.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mixtral-8x7b --gen 24
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.launch.serve import fit_kv_cache
from repro_torch.models import api


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(args.device)
    shape = ShapeSpec("serve", args.prompt_len, args.batch, "prefill")

    params = api.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = api.synth_batch(cfg, shape, seed=0, device=dev)
    prefill = api.make_prefill_fn(cfg)
    decode = api.make_decode_fn(cfg)

    with torch.inference_mode():
        t0 = time.time()
        logits, cache = prefill(params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"prefill({args.batch}x{args.prompt_len}): {time.time() - t0:.2f}s")

        cache = fit_kv_cache(cfg, cache, args.prompt_len, args.gen)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        outs = [tok.cpu().numpy()]
        t1 = time.time()
        for i in range(args.gen - 1):
            tok, cache = decode(params, cache, tok, args.prompt_len + i)
            outs.append(tok.cpu().numpy())
        dt = time.time() - t1
    gen = np.concatenate(outs, axis=1)
    print(
        f"decode: {args.gen - 1} steps in {dt:.2f}s "
        f"({dt / max(args.gen - 1, 1) * 1e3:.1f} ms/step for the batch)"
    )
    for b in range(min(args.batch, 2)):
        print(f"  request[{b}] generated ids: {gen[b].tolist()}")
    return gen


if __name__ == "__main__":
    main()
