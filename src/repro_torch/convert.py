"""Carry state across from the JAX package into the port.

Takes plain numpy arrays only (what the reference's ``state_arrays()``
returns), so this module imports nothing of the reference:

  * :func:`host_table_from_reference` — a reference host table's rows ->
    the port's :class:`HostEmbeddingTable` (a copy; the two tables never
    share memory);
  * :func:`load_reference_server_state` — the ``state_arrays()`` dict of a
    reference ``ReadOnlyCacheServer`` (fp32, empty queue) -> the port's
    server on its device: host table, scratchpad ``storage``, planner
    state (``planner_*``), the ``landed`` mask and the serve step. Both
    servers then continue bit-identically on the same requests.

DLRM MLP weights come with the training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.serving_cache import ReadOnlyCacheServer


def host_table_from_reference(data: np.ndarray) -> HostEmbeddingTable:
    """(rows, dim) fp32 reference host-table rows -> a port host table."""
    arr = np.array(data, dtype=np.float32, copy=True, order="C")
    if arr.ndim != 2:
        raise ValueError(f"expected a (rows, dim) table, got shape {arr.shape}")
    return HostEmbeddingTable(arr.shape[0], arr.shape[1], data=arr)


def load_reference_server_state(server: ReadOnlyCacheServer, arrays: dict) -> None:
    """Load a reference ``ReadOnlyCacheServer.state_arrays()`` snapshot into
    an idle port ``server`` of the same shape (same rows, dim, num_slots
    and table layout)."""
    if "queue" in arrays:
        raise ValueError(
            "the snapshot holds queued micro-batches; carry state across "
            "only from a server whose queue is empty"
        )
    if "storage_scale" in arrays or np.asarray(arrays["storage"]).dtype != np.float32:
        raise ValueError("only fp32 scratchpads can be carried across so far")
    if server.pending or server._visible:
        raise RuntimeError("load_reference_server_state on a non-idle server")
    ht = np.asarray(arrays["host_table"])
    if ht.shape != server.host.data.shape:
        raise ValueError(
            f"snapshot host table {ht.shape} != {server.host.data.shape}"
        )
    storage = np.asarray(arrays["storage"])
    if storage.shape != tuple(server.storage.shape):
        raise ValueError(
            f"snapshot storage {storage.shape} != {tuple(server.storage.shape)}"
        )
    # every array is copied: a reference snapshot may alias the live state
    # of the server it came from (its planner arrays, a zero-copy view of
    # its scratchpad), which that server goes on mutating
    server.host.data[...] = ht
    server.host.reguard()
    server.storage = torch.from_numpy(np.array(storage, copy=True)).to(server.device)
    server.planner.load_state_dict(
        {k[len("planner_"):]: np.array(v, copy=True)
         for k, v in arrays.items() if k.startswith("planner_")}
    )
    server._landed = np.array(arrays["landed"], dtype=bool, copy=True)
    server._step = int(np.asarray(arrays["serve_state"])[0])
