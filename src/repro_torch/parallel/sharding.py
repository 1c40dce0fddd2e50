"""Sharding rules of the port: logical axes -> mesh axes (DP/TP/EP/SP).

Port of ``repro/parallel/sharding.py``. The mesh layouts are the
reference's (``launch/mesh.py``):

  single-pod: (data=16, model=16)
  multi-pod : (pod=2, data=16, model=16)

Conventions, verbatim from the reference:
  * batch dims shard over all data-parallel axes ("pod", "data");
  * TP width dims (heads, ffn inner, vocab rows) shard over "model";
  * a dim is only sharded if divisible by the product of its mesh axes;
    otherwise it is replicated.

Torch has no sharding propagation and no ``PartitionSpec``: :class:`P` is
the port's own (a tuple whose entries are ``None``, an axis name or a tuple
of names), :func:`named` / :func:`tree_shardings` turn specs into DTensor
placements (``Shard(d)`` / ``Replicate()`` per mesh dim, for
``torch.distributed.tensor.distribute_tensor``), and :func:`local_shard`
cuts this rank's slice of a global tensor. The port shards explicitly, as
the reference's ``shard_map`` bodies do, so :func:`constraint` (the
reference's ``with_sharding_constraint``) is a documented no-op.
:func:`head_shard` says which attention heads a model rank computes (its
q heads, and the kv heads they read where K does not divide the TP
width); :func:`spec_leaves`, :func:`shard_slices` and :func:`data_index`
serve the partitioned train step's ZeRO-1 layout and its conversions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``
    (replicated), a mesh axis name, or a tuple of names (sharded over their
    product, the first name major). Compares equal to the plain tuple of
    its entries, as the reference's ``PartitionSpec`` does.

    ``lead`` holds the entries of the stacked dims the reference gives a
    layer stack and the port's per-layer lists do not have (outermost
    first); they are all ``None`` except where ZeRO-1 shards the state of
    a stack over the data axes along its layer dim (``zero1_spec`` picks
    the first free dim, and the stacked dim comes first). Such a spec
    says the list's layers are split over those axes, each layer's tensor
    whole on the ranks that hold it."""

    def __new__(cls, *entries, lead: tuple = ()):
        self = super().__new__(cls, entries)
        self.lead = tuple(lead)
        return self

    def __repr__(self) -> str:
        body = ", ".join(repr(e) for e in self)
        if any(e is not None for e in self.lead):
            body += f", lead={self.lead!r}"
        return "P(" + body + ")"


def is_spec(x) -> bool:
    return isinstance(x, P)


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Resolved axis names + sizes for the active mesh."""

    data: Tuple[str, ...]  # ("pod","data") or ("data",)
    model: str  # "model"
    sizes: Tuple[Tuple[str, int], ...]

    @property
    def data_size(self) -> int:
        d = dict(self.sizes)
        out = 1
        for a in self.data:
            out *= d[a]
        return out

    @property
    def model_size(self) -> int:
        return dict(self.sizes)[self.model]

    def size(self, axis: Union[str, Tuple[str, ...]]) -> int:
        d = dict(self.sizes)
        if isinstance(axis, str):
            return d[axis]
        out = 1
        for a in axis:
            out *= d[a]
        return out


def mesh_axes(mesh) -> MeshAxes:
    """From a ``DeviceMesh`` or the abstract mesh of ``launch/mesh.py``
    (both have ``mesh_dim_names`` and ``shape``)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(zip(names, (int(s) for s in mesh.shape)))
    data = tuple(n for n in names if n in ("pod", "data"))
    return MeshAxes(data=data, model="model", sizes=sizes)


def dp_axis(ax: MeshAxes) -> Union[str, Tuple[str, ...]]:
    """The data-parallel axis as the reference names it in a spec: the
    tuple ("pod", "data") on the multi-pod mesh, else "data"."""
    return ax.data if len(ax.data) > 1 else ax.data[0]


def shard_dim(ax: MeshAxes, dim_size: int, axis: Axis) -> Axis:
    """Return the mesh axis (or None) for a dim, honoring divisibility."""
    if axis is None:
        return None
    if dim_size % ax.size(axis) == 0:
        return axis
    return None


def batch_spec(ax: MeshAxes, batch: int, extra_dims: int = 1) -> P:
    """Spec for (batch, ...) activations: batch over the data axes."""
    b = shard_dim(ax, batch, dp_axis(ax))
    return P(b, *([None] * extra_dims))


def constraint(x, spec: P):
    """The reference's ``with_sharding_constraint``: a no-op here. Torch
    propagates no sharding; every sharded computation of the port names
    its collectives explicitly (``parallel/collectives.py``)."""
    return x


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state specs = param spec + data-axis sharding on dim 0
# ---------------------------------------------------------------------------


def zero1_spec(param_spec: P, shape: Sequence[int], ax: MeshAxes) -> P:
    """Shard optimizer state over the data axes on the first free dim.
    No-op when the param is already data-sharded (FSDP weights)."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    dp = dp_axis(ax)
    dp_axes = set(ax.data)
    for cur in spec:
        cur_axes = cur if isinstance(cur, tuple) else (cur,)
        if any(a in dp_axes for a in cur_axes if a):
            return P(*spec)  # already FSDP-sharded over data
    dp_size = ax.size(dp)
    for i, (dim, cur) in enumerate(zip(shape, spec)):
        if cur is None and dim % dp_size == 0 and dim >= dp_size:
            spec[i] = dp
            return P(*spec)
    return P(*spec)  # too small to shard: replicate over data


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------


def tree_map_specs(fn, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a tree of specs (dicts and lists, specs as
    leaves) and trees of the same structure."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(tree_map_specs(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(spec_tree))
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_factor(spec: P, ax: MeshAxes) -> int:
    """How many devices share one copy of a tensor with this spec: the
    product of the sizes of every mesh axis the spec names (its ``lead``
    entries too: a layer list split over an axis puts 1/size of its bytes
    on each rank)."""
    out = 1
    for entry in tuple(spec) + tuple(getattr(spec, "lead", ())):
        for a in _names(entry):
            out *= ax.size(a)
    return out


def named(mesh, spec: P):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one
    per mesh dim, ``Shard(d)`` where tensor dim d names it, else
    ``Replicate()``. A dim sharded over a tuple of axes is sharded over
    each, in the tuple's order (major first), as the reference's
    ``NamedSharding`` lays it out."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    place: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _names(entry):
            place[names.index(a)] = Shard(d)
    return tuple(place)


def tree_shardings(mesh, spec_tree):
    return tree_map_specs(lambda s: named(mesh, s), spec_tree)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate along each named dim of a ``DeviceMesh``."""
    coords = mesh.get_coordinate()
    if coords is None:
        raise ValueError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coords))


def shard_start(mesh, rows_local: int, axis: str = "model") -> int:
    """The first global row of this rank's block of a dim sharded over
    ``axis`` alone (contiguous blocks of ``rows_local`` rows in rank
    order)."""
    return mesh.get_local_rank(axis) * rows_local


def model_size(mesh) -> int:
    """The TP width: the size of the mesh's "model" axis (1 without one)."""
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return int(mesh.shape[tuple(mesh.mesh_dim_names).index("model")])


def data_index(mesh, coords: Optional[Dict[str, int]] = None) -> int:
    """This rank's index among the data-parallel ranks: its coordinates
    along "pod" and "data", the first major (the block of a dim sharded
    over ("pod", "data") that it holds). ``coords`` overrides the mesh's."""
    ax = mesh_axes(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    i = 0
    for a in ax.data:
        i = i * ax.size(a) + coords[a]
    return i


@dataclasses.dataclass(frozen=True)
class HeadShard:
    """The attention heads of one model rank. ``q`` is the range of global
    q heads it holds (``wq``'s column block of H / TP heads). ``kv`` lists
    the global kv heads its flash call reads, in the order the call takes
    them: with ``kv_sharded`` they are the rank's own K / TP heads (``wk`` /
    ``wv`` sharded over "model"); else ``wk`` / ``wv`` are replicated and
    ``kv`` is the slice the local q heads read, so that the kernel's group
    mapping ``h // (H_loc / K_loc)`` holds, or, where no slice does (a
    group split unevenly between ranks), one kv head per local q head."""

    q: Tuple[int, int]
    kv: Tuple[int, ...]
    kv_sharded: bool

    @property
    def kv_contiguous(self) -> bool:
        return self.kv == tuple(range(self.kv[0], self.kv[0] + len(self.kv)))


def head_shard(mesh, num_heads: int, num_kv_heads: int) -> HeadShard:
    """This model rank's :class:`HeadShard` for H = ``num_heads`` q heads
    and K = ``num_kv_heads`` kv heads (the specs' rule: q heads over
    "model", kv heads over "model" only when K divides; H a multiple of
    the TP width, as ``models/api.py: runtime_config`` pads it)."""
    tp, H, K = model_size(mesh), num_heads, num_kv_heads
    if H % tp:
        raise ValueError(f"{H} q heads do not divide over a model axis of {tp}: "
                         "pad them (models/api.py: runtime_config)")
    h_loc, group = H // tp, H // K
    q_lo = shard_start(mesh, h_loc)
    if K % tp == 0:
        k_lo = shard_start(mesh, K // tp)
        return HeadShard((q_lo, q_lo + h_loc), tuple(range(k_lo, k_lo + K // tp)), True)
    read = tuple((q_lo + i) // group for i in range(h_loc))
    if h_loc % group == 0 or group % h_loc == 0:
        read = tuple(sorted(set(read)))
    return HeadShard((q_lo, q_lo + h_loc), read, False)


def local_shard(t, spec: P, mesh, coords: Optional[Dict[str, int]] = None):
    """This rank's slice of the global tensor ``t`` under ``spec`` (a view):
    along each sharded dim, block ``i`` of ``n`` equal blocks, where ``n``
    is the product of the dim's axes' sizes and ``i`` the rank's coordinate
    along them, the first axis major. ``coords`` overrides the mesh's
    coordinates (an abstract mesh has none)."""
    if any(e is not None for e in getattr(spec, "lead", ())):
        raise ValueError(f"{spec!r} splits a layer list: cut it at the list, not the tensor")
    coords = mesh_coords(mesh) if coords is None else coords
    for d, sl in enumerate(shard_slices(spec, t.shape, mesh_axes(mesh), coords)):
        if sl.stop - sl.start != t.shape[d]:
            t = t.narrow(d, sl.start, sl.stop - sl.start)
    return t


def shard_slices(spec: P, shape, ax: MeshAxes, coords: Dict[str, int]) -> Tuple[slice, ...]:
    """Per dim of a global tensor of ``shape``, the slice of it that the
    rank at ``coords`` holds under ``spec`` (:func:`local_shard`'s rule)."""
    out = []
    for d, size in enumerate(shape):
        names = _names(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in names:
            i = i * ax.size(a) + coords[a]
            n *= ax.size(a)
        if size % n:
            raise ValueError(f"dim {d} of size {size} does not divide over {spec[d]!r}")
        out.append(slice(i * (size // n), (i + 1) * (size // n)))
    return tuple(out)


def tree_local_shards(tree, spec_tree, mesh, coords=None) -> Any:
    return tree_map_specs(lambda s, t: local_shard(t, s, mesh, coords), spec_tree, tree)


def spec_leaves(spec_tree, path: tuple = ()) -> list:
    """(path, spec) of every spec of a tree, in the order ``tree_leaves``
    visits the tree it describes (dicts in sorted key order, then lists in
    order); a path holds the dict keys and list indices."""
    if is_spec(spec_tree):
        return [(path, spec_tree)]
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree) for x in spec_leaves(spec_tree[k], path + (k,))]
    return [x for i, v in enumerate(spec_tree) for x in spec_leaves(v, path + (i,))]


def data_dims(spec: P, ax: MeshAxes) -> Tuple[int, ...]:
    """The tensor dims ``spec`` shards over a data axis ("pod" or "data")."""
    return tuple(d for d, e in enumerate(spec) if any(a in ax.data for a in _names(e)))


def spec_axes(spec: P) -> Tuple[str, ...]:
    """Every mesh axis a spec's tensor dims name (``lead`` aside)."""
    return tuple(a for e in spec for a in _names(e))
