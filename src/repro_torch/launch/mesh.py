"""Meshes of the port. Importing this module starts no process group and
touches no device: meshes are built only inside the factory functions.

Port of ``repro/launch/mesh.py``:

  * :func:`make_production_mesh` — the reference's production layouts,
    (data=16, model=16) and (pod=2, data=16, model=16), as an
    :class:`AbstractMesh`: names and sizes, no process group. One process
    cannot hold 256 ranks, and the dry run needs only the layout (the
    reference's ``jax.make_mesh`` there runs over 512 host-platform
    devices forced by ``XLA_FLAGS``, which torch has no counterpart of).
  * :func:`make_host_mesh` — a ``DeviceMesh`` ("data", "model"), or
    ("pod", "data", "model"), over the
    running process group: NCCL on the card, gloo only when the caller asks
    for ``device="cpu"``. With no group running and a (1, 1) mesh it starts
    a world-1 group from an in-process ``HashStore`` (no network); a larger
    mesh needs the caller's group (``torch.distributed.init_process_group``
    with its own address, rank and world size). Nothing falls back from
    NCCL to gloo.
  * :func:`abstract_rank_mesh` — one rank of a mesh of any shape, the
    production layouts included, as a ``DeviceMesh`` over a fake process
    group of the mesh's world size (torch's test backend: collectives
    complete at once and move nothing), on no device and with no network:
    the dry run (``launch/dryrun.py``) runs a rank's step on ``meta``
    shards over it. Never a path that trains or serves.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

#: the reference's production layouts
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh:
    """A mesh as names and sizes only, for specs and the dry run: it has
    the ``mesh_dim_names`` and ``shape`` of a ``DeviceMesh``, and no rank
    (``get_coordinate()`` is None)."""

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...]):
        if len(shape) != len(names):
            raise ValueError(f"shape {shape} and names {names} differ in length")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(names)

    def size(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out

    def get_coordinate(self):
        return None

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
    data=16, model=16) = 512 devices, the "pod" axis being the cross-pod
    data-parallel dimension."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    return AbstractMesh(shape, names)


def _backend(device: str) -> str:
    if device == "cuda":
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device!r}: use cuda or cpu")


def _start_world_1(device: str) -> None:
    """Start a world-1 process group from an in-process ``HashStore`` (no
    address, no network): NCCL for ``device="cuda"``, gloo for "cpu"."""
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda", pod=None):
    """A ``DeviceMesh`` of shape (data, model), names ("data", "model"), or
    with ``pod`` (pod, data, model), names ("pod", "data", "model"), over
    the running process group, whose backend must be ``device``'s
    (NCCL for "cuda", gloo for "cpu"). With no group running and a mesh of
    one rank, a world-1 group is started first (a ``HashStore``, no network);
    the caller tears it down (``torch.distributed.destroy_process_group``).
    Raises without a card for ``device="cuda"``, when the group's world
    size is not the mesh's, or when its backend is not ``device``'s."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = _backend(device)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda') needs a CUDA device; "
                           "pass device='cpu' for gloo ranks")
    shape, names = ((data, model), ("data", "model")) if pod is None else (
        (pod, data, model), ("pod", "data", "model"))
    want = 1
    for n in shape:
        want *= n
    if not dist.is_initialized():
        if want != 1:
            raise RuntimeError(
                f"a {shape} mesh needs {want} ranks: start the process "
                "group first (torch.distributed.init_process_group)")
        _start_world_1(device)
    world = dist.get_world_size()
    if world != want:
        raise RuntimeError(f"a {shape} mesh needs {want} ranks; the "
                           f"process group has {world}")
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have}; device={device!r} "
                           f"needs {backend}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


@contextlib.contextmanager
def abstract_rank_mesh(shape: Tuple[int, ...], rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` (names ("data", "model"), or with a
    leading "pod" for three dims) over a fake process group of
    ``prod(shape)`` ranks, as ``rank``: its coordinates, groups and shard
    offsets are that rank's, and its collectives complete without moving a
    byte. No device and no network; the group is torn down on exit. For
    the dry run's ``meta`` steps only. Raises when a process group is
    already running, and when this torch lacks the fake group
    (``torch.testing._internal.distributed.fake_pg``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # the one torch-internal module the port uses
        raise RuntimeError(
            "the dry run's abstract rank needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this torch build "
            f"lacks: {e}") from e
    shape = tuple(int(n) for n in shape)
    names = SINGLE_POD[1] if len(shape) == 2 else MULTI_POD[1]
    world = 1
    for n in shape:
        world *= n
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a {shape} mesh of {world} ranks")
    if dist.is_initialized():
        raise RuntimeError("a process group is running: the dry run's abstract rank "
                           "starts its own fake group, with no other running")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
