"""Async, atomic checkpointing.

Port of ``repro/checkpoint/manager.py``, with the reference's on-disk
layout, so a checkpoint written by one package is read by the other:

    <dir>/step_<N>/
        manifest.json          # step, leaf names/shapes/dtypes, extra metadata
        arrays.npz             # one entry per state leaf ("/"-joined key path)
        host/<name>.npy        # host-side state (embedding tables, planner)

  * writes go to ``<dir>/.tmp_step_<N>`` and are ``os.replace()``'d into
    place — a preempted save never corrupts the latest checkpoint. The tmp
    tree (every file AND directory) is fsynced before the rename, and the
    parent directory after it, so the atomic rename is durable against
    power loss, not just process death (``durable=False`` skips the
    fsyncs);
  * saves run on a background thread (training continues; ``wait()``
    joins). A background failure is surfaced as a RuntimeError on the NEXT
    ``save()``/``wait()``/``restore()`` — it is never silently dropped;
  * every read (``restore``, ``restore_host``, ``manifest``) first joins
    a save still in flight, so "the latest step" is a finished one (the
    reference's ``manifest``/``restore_host`` do not wait, and a read
    racing a save can mix two steps);
  * state and host arrays are copied to host memory at ``save()`` call
    time: the caller's live tables keep training while the background
    thread serializes the snapshot, so the bytes on disk are the state AT
    the checkpoint step.

State is a nested dict (or list/tuple) whose leaves are numpy arrays or
tensors (a module's ``state_dict()`` nests fine); its leaves are keyed by
their "/"-joined path. ``restore(target_like)`` returns the same
structure, each leaf as the type and on the device of the ``target_like``
leaf at its path. A bfloat16 tensor is stored as float32 (numpy has no
bfloat16; the widening is exact) and comes back as bfloat16. The reference's ``shardings=`` (re-sharding onto a mesh)
is not carried over: the port runs on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict/list/tuple keyed by their "/"-joined path
    (the reference's key paths: dict keys, then sequence indices)."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(tree, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(tree, dict):
        return type(tree)((k, _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    arr = flat[prefix]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=tree.device, dtype=tree.dtype)
    return np.array(arr)


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:  # numpy has no bfloat16: widened, exactly
            v = v.float()
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(np.asarray(v))


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(root: str):
    """fsync every file and directory under ``root`` (and root itself) so a
    subsequent atomic rename is durable: data blocks, then the directory
    entries that reference them."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            _fsync_path(os.path.join(dirpath, name))
        _fsync_path(dirpath)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, durable: bool = True):
        self.dir = directory
        self.keep = keep
        self.durable = durable
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def save(
        self,
        step: int,
        state,
        *,
        host_arrays: Optional[Dict[str, np.ndarray]] = None,
        extra: Optional[dict] = None,
        blocking: bool = False,
    ):
        """Snapshot ``state`` (copied to the host now) + host state, write
        async. Raises RuntimeError here if a PREVIOUS async save failed —
        the training loop finds out at the next checkpoint, not at exit."""
        self.wait()
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        # deep-copy now: the caller keeps mutating these arrays while the
        # background thread writes
        host_arrays = {k: _to_host(v) for k, v in dict(host_arrays or {}).items()}
        extra = dict(extra or {})

        def _write():
            try:
                tmp = os.path.join(self.dir, f".tmp_step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(os.path.join(tmp, "host"), exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                for name, arr in host_arrays.items():
                    np.save(os.path.join(tmp, "host", f"{name}.npy"), arr)
                manifest = {
                    "step": step,
                    "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                               for k, v in flat.items()},
                    "host": sorted(host_arrays),
                    "extra": extra,
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f, indent=1)
                if self.durable:
                    _fsync_tree(tmp)
                shutil.rmtree(final, ignore_errors=True)
                os.replace(tmp, final)
                if self.durable:
                    # make the rename itself durable: the parent directory
                    # entry is what points a restart at step_<N>
                    _fsync_path(self.dir)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_like, step: Optional[int] = None):
        """Restore into the structure of ``target_like`` (a nested dict of
        arrays or tensors): each leaf comes back as a tensor on the device
        and of the dtype of a tensor leaf there, else as a numpy array.
        Returns (state, step)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        missing = [k for k in _flatten(target_like) if k not in flat]
        if missing:
            raise KeyError(f"checkpoint step_{step} missing leaves: {missing[:5]}")
        return _unflatten_like(target_like, flat), step

    def restore_host(self, name: str, step: Optional[int] = None) -> np.ndarray:
        self.wait()
        step = self.latest_step() if step is None else step
        return np.load(os.path.join(self.dir, f"step_{step}", "host", f"{name}.npy"))

    def manifest(self, step: Optional[int] = None) -> dict:
        self.wait()
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.dir, f"step_{step}", "manifest.json")) as f:
            return json.load(f)
