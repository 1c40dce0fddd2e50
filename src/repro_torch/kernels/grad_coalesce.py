"""ctypes launcher of the hand-written CUDA backward kernel in
``csrc/grad_coalesce.cu``.

Port of the ``scatter_add`` Pallas kernel of ``repro/kernels/grad_coalesce.py``
(the source file holds the kernels' bound and design note). The TPU kernel
coalesces duplicate rows because its grid runs in order; here the flat
lookup positions are stable-sorted by slot first (:func:`sort_by_slot`,
``torch.sort``, a library radix sort), and the hand-written kernels
(:func:`scatter_add_sorted`) add each row's deltas in that order: one warp
per 32 sorted positions for the segments of at most :data:`LONG_SEGMENT`
lookups; a CTA per (longer segment, column slab) for the hot rows, on a
side stream that overlaps the short kernel, from a worklist a first launch
builds on the device (:func:`long_segment_heads` is the same list in
torch). :func:`scatter_add` does the sort and the accumulation. The
launchers take CUDA tensors only (``meta`` ones too: the dry run's
footprint pass, which allocates the sort and the worklist and launches
nothing): they check device, dtype (fp32 or bf16 storage, deltas of the
storage's dtype, int32 ids), shape and contiguity, launch on the current stream
(the long kernel forked from and joined back to it on a side stream of
the calling host thread's own, so threads may launch at once on their own
streams), raise on a CUDA error
and count each accumulation (its two or three launches) once in
:data:`LAUNCHES`. The library is built and loaded at the first launch,
never at import. Natural shapes, empty operands and the CPU dispatch live
in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.gather_reduce import _check, _check_cuda, footprint

#: kernel launches since the last reset — one is added where a launch
#: succeeds, and nowhere else; ``scatter_add_bf16`` is the bf16 storage's
#: form (each add rounded to bf16)
LAUNCHES = {"scatter_add": 0, "scatter_add_bf16": 0}
#: a segment of more than this many lookups of one row gets a CTA of its own
LONG_SEGMENT = 64

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import _build

        lib = ctypes.CDLL(str(_build.library_path("grad_coalesce")))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for fn in (lib.repro_scatter_add_sorted_f32, lib.repro_scatter_add_sorted_bf16):
            fn.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i64, i32, ptr, i64, ptr]
            fn.restype = i32
        lib.repro_cuda_error_string.argtypes = [i32]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def sort_by_slot(flat_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat_ids (nb, L) int32 -> (keys (nb*L,) int32 sorted stably,
    perm (nb*L,) int64 flat positions): within one slot the positions keep
    their flat bag-major order."""
    return torch.sort(flat_ids.reshape(-1), stable=True)


def long_segment_heads(keys: torch.Tensor, n_ids: int, T: int = LONG_SEGMENT) -> torch.Tensor:
    """keys (n,) sorted -> the first positions (int64, ascending) of the
    runs of one id in [0, ``n_ids``) longer than ``T``: the segments the
    long-segment kernel takes, the list its first launch builds."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    head = torch.ones(n, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    longer = torch.zeros(n, dtype=torch.bool, device=keys.device)
    longer[: max(n - T, 0)] = keys[T:] == keys[: max(n - T, 0)]
    return pos[head & longer & (keys >= 0) & (keys < n_ids)]


def scatter_add_sorted(
    storage: torch.Tensor,
    keys: torch.Tensor,
    perm: torch.Tensor,
    bag_deltas: torch.Tensor,
    L: int,
) -> torch.Tensor:
    """In place: storage[keys[j]] += bag_deltas[perm[j] // L] for every j,
    in j order per row. storage (N, D) fp32 or bf16 (each add then rounded
    to bf16); keys (n,) int32 and perm (n,) int64 from
    :func:`sort_by_slot`; bag_deltas (n // L, D) of the storage's dtype;
    n > 0. All on one CUDA device. Returns the long-segment worklist,
    int64: ``work[0]`` heads at ``work[2:2 + work[0]]``, in no fixed order
    (as a set, they are :func:`long_segment_heads`)."""
    _check_cuda(storage)
    _check(storage, "storage", (torch.float32, torch.bfloat16), storage.device)
    _check(keys, "keys", torch.int32, storage.device)
    _check(perm, "perm", torch.int64, storage.device)
    _check(bag_deltas, "bag_deltas", storage.dtype, storage.device)
    if storage.dim() != 2 or bag_deltas.dim() != 2 or keys.dim() != 1:
        raise ValueError("expected storage (N, D), keys (n,), perm (n,), deltas (nb, D)")
    (n,) = keys.shape
    N, D = storage.shape
    if L <= 0 or perm.shape != (n,) or bag_deltas.shape != (n // L, D) or n % L:
        raise ValueError(
            f"keys {n}, perm {tuple(perm.shape)}, deltas {tuple(bag_deltas.shape)} "
            f"and L={L} do not describe (nb, L) lookups of ({N}, {D}) rows"
        )
    if n == 0 or D == 0:
        raise ValueError("empty operands launch nothing: ops.scatter_add skips them")
    if n >= 2**31:
        raise ValueError(f"{n} lookups: the kernels take fewer than 2^31")
    cap = n // (LONG_SEGMENT + 1)  # the most segments longer than LONG_SEGMENT
    work = torch.empty(2 + cap, dtype=torch.int64, device=storage.device)
    if footprint(storage):
        return work
    lib = _lib()
    bf16 = storage.dtype == torch.bfloat16
    key = "scatter_add_bf16" if bf16 else "scatter_add"
    fn = lib.repro_scatter_add_sorted_bf16 if bf16 else lib.repro_scatter_add_sorted_f32
    with torch.cuda.device(storage.device):
        err = fn(
            storage.data_ptr(), keys.data_ptr(), perm.data_ptr(),
            bag_deltas.data_ptr(), n, L, D, N, LONG_SEGMENT, work.data_ptr(), cap,
            torch.cuda.current_stream(storage.device).cuda_stream,
        )
    if err != 0:
        what = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {key} failed: {what} (cudaError {err})")
    LAUNCHES[key] += 1
    return work


def scatter_add(
    storage: torch.Tensor, flat_ids: torch.Tensor, bag_deltas: torch.Tensor
) -> None:
    """In place: storage[flat_ids[b, l]] += bag_deltas[b], duplicates in flat
    bag-major order. storage (N, D) fp32 or bf16; flat_ids (nb, L) int32
    with every id in [0, N); bag_deltas (nb, D) of the storage's dtype;
    nb, L > 0."""
    _check_cuda(storage)
    _check(flat_ids, "slot_ids", torch.int32, storage.device)
    if flat_ids.dim() != 2:
        raise ValueError(f"expected slot_ids (nb, L), got {tuple(flat_ids.shape)}")
    keys, perm = sort_by_slot(flat_ids)
    scatter_add_sorted(storage, keys, perm, bag_deltas, flat_ids.shape[1])
