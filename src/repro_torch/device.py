"""Device selection shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: entry points
default to ``device="cuda"`` and raise when no card is visible, never
continuing on the CPU. ``device="cpu"`` runs every kernel's plain PyTorch
version (how the tests hold the port against the JAX package).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises if it is a
    CUDA device and no card is visible, or if it is neither CUDA nor CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for, but no CUDA device is "
                "available; pass device='cpu' (launcher: --device cpu) to run "
                "the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev
