"""Device selection shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: entry points
default to ``device="cuda"`` and raise when no card is visible, never
continuing on the CPU. ``device="cpu"`` runs every kernel's plain PyTorch
version (how the tests hold the port against the JAX package).
"""
from __future__ import annotations

import numpy as np
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


def widen_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 values held as their 16 bits (an int16 or uint16 array) ->
    their fp32 values, exactly (the bits are the top half of the fp32
    word). numpy has no bfloat16, so bf16 rows cross to the host so."""
    return (bits.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a host numpy array (a copy of a device tensor, a view
    of a CPU one); a bf16 tensor comes back as a new fp32 array, its exact
    widening."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return widen_bf16_bits(t.view(torch.int16).cpu().numpy())
    return t.cpu().numpy()


class HostCopy:
    """Device -> host copies that leave the main stream free.

    :meth:`start` is called on the thread that launches (it enqueues CUDA
    work); the handle's ``wait()`` may run on any thread: it waits on an
    event and touches no stream. On the card the copy goes on a dedicated
    stream into a fresh pinned buffer, ordered after ``ready`` (an event
    recorded on the producer's stream right after the producer; by default
    one recorded now on the current stream). The copy stream is recorded on
    the source, so its memory is not reused before the copy is done, and
    PyTorch's pinned allocator does not hand the buffer out again before
    the copy's event completes and every view of it is gone. On the CPU
    the tensor already is host memory: ``wait()`` returns its numpy view.
    A bf16 tensor moves as its 16 bits and ``wait()`` returns their exact
    fp32 widening (:func:`widen_bf16_bits`).
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def ready(self):
        """An event on the current stream, to order a later :meth:`start`
        after the work enqueued so far (None on the CPU)."""
        if self._stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def start(self, t: torch.Tensor, ready=None) -> "PendingCopy":
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        if self._stream is None:
            return PendingCopy(t.detach().numpy(), None, bf16)
        if ready is None:
            ready = self.ready()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._stream.wait_event(ready)
        with torch.cuda.stream(self._stream):
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        t.record_stream(self._stream)
        return PendingCopy(host.numpy(), done, bf16)


class PendingCopy:
    """A host copy in flight: ``wait()`` blocks until it has landed and
    returns it as a numpy array (which keeps its buffer alive; bf16 bits
    come back widened to fp32, a new array)."""

    __slots__ = ("_host", "_done", "_bf16")

    def __init__(self, host, done, bf16: bool = False):
        self._host = host
        self._done = done
        self._bf16 = bf16

    def wait(self):
        if self._done is not None:
            self._done.synchronize()
        return widen_bf16_bits(self._host) if self._bf16 else self._host
