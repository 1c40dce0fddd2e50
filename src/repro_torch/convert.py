"""Carry state across from the JAX package into the port.

Takes plain numpy arrays only (what the reference's ``state_arrays()``
returns), so this module imports nothing of the reference:

  * :func:`host_table_from_reference` — a reference host table's rows ->
    the port's :class:`HostEmbeddingTable` (a copy; the two tables never
    share memory);
  * :func:`load_reference_server_state` — the ``state_arrays()`` dict of a
    reference ``ReadOnlyCacheServer`` (at any cycle, its queue included;
    fp32, fp16 or int8) -> the port's server of the same shape, on its
    device, through ``ReadOnlyCacheServer.load_state_arrays``. Both servers
    then continue bit-identically on the same requests;
  * :func:`server_state_to_reference` — the way back: a port server's
    ``state_arrays()`` as owning numpy copies (the host table too), which
    a reference ``ReadOnlyCacheServer.load_state_arrays`` takes;
  * :func:`pipe_state_from_reference` — a reference training runtime's
    ``state_arrays()`` (``ScratchPipe``, or ``ShardedScratchPipe`` with its
    ``shard<i>_`` keys), or the host arrays of a reference checkpoint ->
    a dict the port's ``load_state_arrays`` takes: every array copied, the
    device-planner state checked, the int8 ``storage``/``storage_scale``
    pair checked, and the in-flight window blob read with the port's
    restricted unpickler (numpy and builtins only) and packed anew;
  * :func:`device_planner_state_from_reference` — a reference
    ``DevicePlanner.state_dict()`` (keys ``t{t}_{field}``, ``hold``
    uint32) -> a ``state_dict`` the port's ``DevicePlanner`` loads; both
    planners then plan the same next cycles;
  * :func:`storage_from_reference` — a reference scratchpad storage (an
    fp32/fp16 array, or an int8 ``QuantStorage`` as a ``(data, scale)``
    pair of numpy arrays) -> the port's storage on a device, copied, so
    both packages can start from identical quantized state;
  * :func:`mlps_from_reference` — the reference's DLRM ``init_mlps``
    pytree (as numpy arrays) -> the parameters of the port's
    ``models.dlrm.DLRM`` (a ``state_dict``, copied and transposed to
    ``nn.Linear``'s (out, in) layout);
  * :func:`lm_params_from_reference` — the reference's LM params (the
    nested dict of ``models/api.py: init``, as numpy arrays) -> the port's:
    for the hybrid family the stacked ``groups`` leaves (G, m, ...) and
    ``tail`` leaves (tail, ...), for the ssm and transformer families the
    stacked ``layers`` (L, ...) (mamba blocks; qkv biases, layer-norm
    weights and biases, the MoE ``mlp`` dict of ``router``/``wg``/``wu``/
    ``wd`` and all) become per-layer dicts; ``frontend_proj`` and an untied
    ``lm_head`` come as they are; every array a copy;
  * :func:`lm_cache_from_reference` — a reference hybrid, ssm or
    transformer decode cache (as numpy arrays) -> the port's, the mamba
    states unstacked per layer, the KV caches stacked as in the reference,
    so the port can decode on from a reference prefill;
  * :func:`lm_params_to_reference` — the way back for any tree shaped as
    the port's params (params, their gradients, AdamW's ``m``/``v``/
    ``master``): the per-layer lists restacked on a leading axis, as numpy
    arrays, so tests compare with the reference leaf by leaf;
  * :func:`adamw_state_from_reference` / :func:`adamw_state_to_reference`
    — an ``AdamW`` state (``m``, ``v``, ``master`` shaped as the params,
    and the step count ``t``) between the reference's stacked layout and
    the port's per-layer lists.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.checkpoint.pack import pack_blob, unpack_blob
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.quantize import QuantStorage
from repro_torch.core.serving_cache import ReadOnlyCacheServer


def host_table_from_reference(data: np.ndarray) -> HostEmbeddingTable:
    """(rows, dim) fp32 reference host-table rows -> a port host table."""
    arr = np.array(data, dtype=np.float32, copy=True, order="C")
    if arr.ndim != 2:
        raise ValueError(f"expected a (rows, dim) table, got shape {arr.shape}")
    return HostEmbeddingTable(arr.shape[0], arr.shape[1], data=arr)


def load_reference_server_state(server: ReadOnlyCacheServer, arrays: dict) -> None:
    """Load a reference ``ReadOnlyCacheServer.state_arrays()`` snapshot into
    a port ``server`` of the same shape (rows, dim, num_slots, precision
    and table layout). Every array is copied (a reference snapshot aliases
    the live planner arrays of the server it came from, and on the CPU a
    zero-copy view of its scratchpad), and the queue blob is read with the
    port's restricted unpickler."""
    server.load_state_arrays(arrays)


def server_state_to_reference(server: ReadOnlyCacheServer) -> Dict[str, np.ndarray]:
    """A port server's ``state_arrays()`` with every array an owning numpy
    copy (the host table, which ``state_arrays`` returns live, included):
    a reference ``ReadOnlyCacheServer.load_state_arrays`` takes it as it
    stands, and both servers then serve the same bags."""
    return {k: np.array(v, copy=True) for k, v in server.state_arrays().items()}


#: the reference DevicePlanner's per-table state fields and their dtypes
_PLAN_STATE = {"hitmap": np.int32, "slot_to_id": np.int32, "hold": np.uint32,
               "last_use": np.int32, "free_ptr": np.int32, "cycle": np.int32}


def device_planner_state_from_reference(state_dict: dict) -> Dict[str, np.ndarray]:
    """A reference ``DevicePlanner.state_dict()`` -> the port's: the same
    keys (``t{t}_{field}`` for tables t = 0, 1, ...), every array copied
    and checked. The port keeps ``hold`` in int32 (torch shifts no
    uint32), so a register with bit 31 set (a past window over 30 cycles)
    cannot be carried across."""
    out: Dict[str, np.ndarray] = {}
    tables = sorted({int(k[1:].split("_", 1)[0]) for k in state_dict if k.startswith("t")})
    if not tables or tables != list(range(len(tables))):
        raise ValueError("expected t{t}_{field} keys for tables 0, 1, ...")
    for t in tables:
        for f, dtype in _PLAN_STATE.items():
            key = f"t{t}_{f}"
            if key not in state_dict:
                raise ValueError(f"device-planner state lacks {key!r}")
            a = np.asarray(state_dict[key])
            if a.dtype != dtype:
                raise ValueError(f"{key}: expected {np.dtype(dtype)}, got {a.dtype}")
            out[key] = np.array(a, copy=True)
        if (out[f"t{t}_hold"] >> 31).any():
            raise ValueError(f"t{t}_hold: bit 31 set; the port's hold register is int32")
    return out


def pipe_state_from_reference(arrays: dict) -> Dict[str, np.ndarray]:
    """A reference training runtime's ``state_arrays()`` (or a reference
    checkpoint's host arrays) -> the port's, for
    ``ScratchPipe.load_state_arrays`` / ``ShardedScratchPipe.load_state_arrays``.
    The keys are the reference's; every array is copied (a reference
    snapshot aliases its live planner arrays and, on the CPU, its
    scratchpad)."""
    prefixes = sorted({k[:k.index("_") + 1] for k in arrays
                       if k.startswith("shard") and "_" in k})
    if prefixes:  # ShardedScratchPipe: one runtime's keys per shard
        out: Dict[str, np.ndarray] = {}
        for pre in prefixes:
            sub = {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}
            out.update({pre + k: v for k, v in pipe_state_from_reference(sub).items()})
        return out
    for key in ("host_table", "storage"):
        if key not in arrays:
            raise ValueError(f"not a runtime snapshot: no {key!r}")
    out = {k: np.array(v, copy=True) for k, v in arrays.items()
           if k not in ("window",) and not k.startswith("planner_")}
    if "storage_scale" in out:
        storage_from_reference((out["storage"], out["storage_scale"]))  # checks
    planner = {k[len("planner_"):]: v for k, v in arrays.items()
               if k.startswith("planner_")}
    if any(k.startswith("t0_") for k in planner):  # the device planner's
        planner = device_planner_state_from_reference(planner)
    out.update({f"planner_{k}": np.array(v, copy=True) for k, v in planner.items()})
    if "window" in arrays:
        out["window"] = pack_blob(unpack_blob(arrays["window"]))
    return out


def storage_from_reference(storage, device="cpu"):
    """A reference scratchpad storage -> the port's, on ``device``: an
    fp32/fp16 (N, D) array -> a tensor of its dtype; an int8 ``(data,
    scale)`` pair (a reference ``QuantStorage`` read as numpy arrays) -> a
    :class:`QuantStorage` of an int8 (N, D) payload and an fp32 (N, 1)
    scale column. Every array is copied."""
    if isinstance(storage, tuple):
        data, scale = (np.array(a, copy=True) for a in storage)
        if data.dtype != np.int8 or scale.dtype != np.float32:
            raise ValueError(
                f"expected int8 data and fp32 scale, got {data.dtype} and {scale.dtype}"
            )
        if data.ndim != 2 or scale.shape != (data.shape[0], 1):
            raise ValueError(f"data {data.shape} and scale {scale.shape} do not pair")
        return QuantStorage(torch.from_numpy(data).to(device),
                            torch.from_numpy(scale).to(device))
    arr = np.array(storage, copy=True)
    if arr.dtype not in (np.float32, np.float16) or arr.ndim != 2:
        raise ValueError(f"expected an fp32/fp16 (N, D) array, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr).to(device)


def mlps_from_reference(mlps: dict) -> Dict[str, torch.Tensor]:
    """``{"bottom"|"top": [{"w": (in, out), "b": (out,)}, ...]}`` (numpy
    arrays of the reference's ``dlrm.init_mlps``, or of a trained
    ``DLRMTrainer.mlps``) -> a ``state_dict`` for the port's ``DLRM``:
    ``<stack>.<i>.weight`` = ``w.T`` and ``<stack>.<i>.bias`` = ``b``, fp32
    CPU copies. Load it with ``model.load_state_dict(...)``, which copies
    onto the model's device."""
    out: Dict[str, torch.Tensor] = {}
    for stack in ("bottom", "top"):
        for i, layer in enumerate(mlps[stack]):
            w = np.asarray(layer["w"], dtype=np.float32)
            b = np.asarray(layer["b"], dtype=np.float32)
            if w.ndim != 2 or b.shape != (w.shape[1],):
                raise ValueError(
                    f"{stack}[{i}]: expected w (in, out) and b (out,), got "
                    f"{w.shape} and {b.shape}"
                )
            out[f"{stack}.{i}.weight"] = torch.from_numpy(np.array(w.T, copy=True))
            out[f"{stack}.{i}.bias"] = torch.from_numpy(np.array(b, copy=True))
    return out


def _tensor(a, device) -> torch.Tensor:
    """A copy of numpy array ``a`` as a tensor on ``device``; bfloat16
    arrays (numpy's ml_dtypes type, which torch cannot read) go through
    their 16-bit pattern."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _tree(d, device):
    if isinstance(d, dict):
        return {k: _tree(v, device) for k, v in d.items()}
    return _tensor(d, device)


def _leading(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_leading(v) for v in tree.values()))
    return {np.asarray(tree).shape[0]}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _unstack(tree: Dict[str, Any], n_lead: int, device) -> List:
    """A nested dict of stacked leaves (n0[, n1], ...) -> [[{...}, ...], ...]
    over the ``n_lead`` leading axes (1: a list of dicts; 2: a list of
    lists), each leaf a tensor copy on ``device``."""
    n = _leading(tree)
    if len(n) != 1:
        raise ValueError(f"stacked leaves disagree on their leading axis: {sorted(n)}")
    out = []
    for i in range(n.pop()):
        sub = _index(tree, i)
        out.append(_unstack(sub, n_lead - 1, device) if n_lead > 1 else _tree(sub, device))
    return out


#: stacked leaves -> how many leading axes the port unstacks into lists
_STACKED = {"groups": 2, "tail": 1, "layers": 1}


def lm_params_from_reference(params: dict, device="cpu") -> dict:
    """Reference LM params (numpy arrays) -> the port's on ``device``, every
    array copied. Hybrid (``models/hybrid.py``): ``embed``, ``groups``
    stacked (G, m, ...), ``shared``, ``final_norm``, ``lm_head``, ``tail``
    stacked (tail, ...). Ssm (``models/ssm_lm.py``) and transformer
    (``models/transformer.py``, the MoE family's ``mlp`` dict included):
    ``layers`` stacked (L, ...), ``final_norm`` (a dict of ``w``/``b`` for
    the encoder), ``embed``, ``lm_head`` unless tied, ``frontend_proj``."""
    out = {k: _tree(v, device) for k, v in params.items() if k not in _STACKED}
    for k, n_lead in _STACKED.items():
        if k in params:
            out[k] = _unstack(params[k], n_lead, device)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: widened, exactly
        t = t.float()
    return t.numpy().copy()


def _restack(tree, n_lead: int):
    """The inverse of :func:`_unstack`: ``n_lead`` levels of lists of
    (nested dicts of) tensors -> a nested dict of numpy arrays stacked on
    that many leading axes."""
    if n_lead == 0:
        return _tree_np(tree)
    items = [_restack(sub, n_lead - 1) for sub in tree]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(leaf[k] for leaf in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    return stack(*items)


def _tree_np(d):
    if isinstance(d, dict):
        return {k: _tree_np(v) for k, v in d.items()}
    return _numpy(d)


def lm_params_to_reference(tree: dict) -> dict:
    """A tree shaped as the port's LM params (the params, their gradients,
    or AdamW's ``m``/``v``/``master``) -> the reference's layout as numpy
    arrays: ``layers`` (and the hybrid's ``groups``/``tail``) restacked on
    their leading axes, every other leaf as it is; bfloat16 widened to
    float32 (exactly)."""
    out = {k: _tree_np(v) for k, v in tree.items() if k not in _STACKED}
    for k, n_lead in _STACKED.items():
        if k in tree:
            out[k] = _restack(tree[k], n_lead)
    return out


def adamw_state_from_reference(state: dict, device="cpu") -> dict:
    """A reference ``AdamW`` state (numpy arrays: ``m``, ``v`` and ``master``
    shaped as the stacked params, ``t`` a 0-dim int32) -> the port's
    (``optim/optimizers.py: AdamW``), on ``device``, every array copied."""
    out = {k: lm_params_from_reference(state[k], device)
           for k in ("m", "v", "master") if k in state}
    out["t"] = _tensor(np.asarray(state["t"], dtype=np.int32), device)
    return out


def adamw_state_to_reference(state: dict) -> dict:
    """The port's ``AdamW`` state -> the reference's layout, as numpy arrays."""
    out = {k: lm_params_to_reference(state[k]) for k in ("m", "v", "master") if k in state}
    out["t"] = _numpy(state["t"])
    return out


#: the keys of one mamba layer's decode state (``models/mamba2.py``)
_MAMBA_STATE = {"conv_x", "conv_B", "conv_C", "ssm"}


def lm_cache_from_reference(cache: dict, device="cpu") -> dict:
    """A reference decode cache (numpy arrays) -> the port's, on ``device``,
    copied: ``k``/``v`` stay stacked ((G or L), B, S, K, hd); the hybrid's
    ``x0`` as it is, its ``groups`` states (G, m, B, ...) and ``tail``
    states (tail, B, ...) unstacked per layer; the ssm family's states,
    stacked (L, B, ...) at the top level, become ``{"layers": [...]}``."""
    if set(cache) == _MAMBA_STATE:
        return {"layers": _unstack(cache, 1, device)}
    out = {k: _tensor(v, device) for k, v in cache.items() if k not in _STACKED}
    for k, n_lead in _STACKED.items():
        if k in cache:
            out[k] = _unstack(cache[k], n_lead, device)
    return out
