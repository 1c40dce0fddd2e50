"""Blob packing for mid-stream checkpoint state.

Port of ``repro/checkpoint/pack.py``. The hold window of a pipelined cache
runtime is a small, heterogeneous structure (per-entry ids, dense batch
payloads, a captured plan, staged rows at various pipeline stages).
``CheckpointManager`` persists flat ``{name: ndarray}`` maps, so the window
is serialized into ONE opaque uint8 array via pickle: :func:`pack_blob` /
:func:`unpack_blob` round-trip a structure of dicts, lists, tuples, scalars
and numpy arrays through a 1-D uint8 ndarray that rides the normal
``host_arrays`` path.

Everything placed in a blob is first normalized to host memory with
:func:`tree_to_host` (a tensor on the card becomes a numpy copy), so a blob
never references a device buffer and the two packages read each other's
blobs: same wrapper, same version. :func:`unpack_blob` unpickles with a
restricted loader that builds numpy arrays and builtins only, never a
class of either package, so loading a blob imports nothing and runs no
code of its own. A reference blob may hold bf16 arrays (its bf16
scratchpad's victims), whose dtype names ``ml_dtypes.bfloat16``: the loader
builds them as uint16 arrays of their bits instead (numpy has no bfloat16;
``device.widen_bf16_bits`` gives their fp32 values).
"""
from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np
import torch

# bump when the window capture layout changes incompatibly (the reference's)
BLOB_VERSION = 1

#: builtins a blob may name (containers and scalars numpy's pickles use)
_BUILTINS = frozenset({"bytearray", "bytes", "complex", "dict", "frozenset", "list",
                       "set", "slice", "tuple", "int", "float", "bool", "str"})


def tree_to_host(x: Any) -> Any:
    """Recursively convert array leaves (numpy arrays and tensors, on any
    device) to owning host ndarrays. Dicts/lists/tuples are rebuilt;
    scalars and strings pass through."""
    if isinstance(x, dict):
        return {k: tree_to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_to_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, np.ndarray):
        return np.array(x)  # snapshot: detach from any shared buffer
    return x


class _HostOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module == "_codecs" and name == "encode":  # numpy's protocol-2 bytes
            return super().find_class(module, name)
        if (module, name) == ("ml_dtypes", "bfloat16"):  # its bits, as uint16
            return np.uint16
        raise pickle.UnpicklingError(
            f"checkpoint blob names {module}.{name}: a blob holds numpy arrays "
            "and builtins only")


def pack_blob(obj: Any) -> np.ndarray:
    """Pickle ``obj`` (host-normalized) into a 1-D uint8 ndarray."""
    payload = pickle.dumps(
        {"v": BLOB_VERSION, "obj": tree_to_host(obj)},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return np.frombuffer(payload, dtype=np.uint8).copy()


def unpack_blob(arr: np.ndarray) -> Any:
    """Inverse of :func:`pack_blob` (also reads the reference's blobs)."""
    raw = np.ascontiguousarray(arr, dtype=np.uint8).tobytes()
    wrapper = _HostOnlyUnpickler(io.BytesIO(raw)).load()
    if not isinstance(wrapper, dict) or "v" not in wrapper:
        raise ValueError("not a checkpoint blob")
    if wrapper["v"] != BLOB_VERSION:
        raise ValueError(f"checkpoint blob version {wrapper['v']} != {BLOB_VERSION}")
    return wrapper["obj"]
