"""Public wrappers of the port's kernels: dispatch by the tensor's device.

Port of ``gather_reduce``, ``gather_reduce_q``, ``fill``,
``fill_gather_reduce``, ``fill_gather_reduce_q``, ``coalesce_deltas`` and
``coalesce_apply`` of ``repro/kernels/ops.py``, for fp32, fp16, bf16 and
int8 storage, and of its LM kernels ``flash_attention`` and ``ssd_chunk_scan``,
forward and backward, for fp32 and bf16 activations. The wrappers own what
the raw launchers do not take:

  * natural shapes — leading batch/table dims of ``slot_ids`` are flattened
    to (nb, L) and restored on the way out;
  * empty operands — zero bags, zero lookups or zero fill rows launch
    nothing; the fused forward falls back to the single-kernel paths when
    it has nothing to fill or nothing to gather (a shape guard, as in the
    reference);
  * dispatch — a CUDA tensor goes to the hand-written kernel
    (``kernels/gather_reduce.py``, ``kernels/grad_coalesce.py``) or the call
    raises; a CPU tensor goes to the plain PyTorch version
    (``kernels/ref.py``), and so does a ``meta`` tensor (the dry run's
    abstract evaluation: its flops pass counts the plain versions'
    products). Inside :func:`kernel_footprint` (the dry run's memory pass)
    a ``meta`` tensor takes the kernel's route instead, whose launchers
    allocate what they allocate on the card — outputs, ``lse``, workspaces,
    the sort in front of ``scatter_add`` — and launch nothing. There is no
    knob and no fallback from one to the other;
  * differentiation — ``gather_reduce`` and ``fill_gather_reduce`` are
    ``torch.autograd.Function``s when their storage (or fill rows) require
    grad, the ports of the reference's ``custom_vjp``s: the backward is the
    coalescing scatter-add kernel into the cotangent buffer. The training
    step does not use them (it takes the bag gradients explicitly,
    ``core/dlrm_runtime.py``); the grad checks do. The quantized wrappers
    have none, as in the reference. ``flash_attention`` on CUDA tensors
    that require grad is one too (LM training): its backward is the
    hand-written ``flash_attention_bwd`` kernel; on the CPU torch's
    autograd differentiates the plain version, as the reference's
    ``_fa_bwd`` differentiates its own. So is ``ssd_chunk_scan`` (LM
    training of the mamba layers): its backward is the hand-written
    ``ssd_chunk_scan_bwd`` kernel, where the reference differentiates its
    plain chunk loop;
  * bf16 storage (the fp32 path's bf16 scratchpad) — ``gather_reduce``
    and ``fill_gather_reduce`` give bf16 bags, ``fill`` and
    ``fill_gather_reduce`` take fp32 rows and round them in the kernel,
    and ``coalesce_apply`` rounds every add, each through the kernels'
    bf16 forms;
  * quantized storage — ``gather_reduce_q`` and ``fill_gather_reduce_q``
    take the payload and its (N, 1) fp32 ``scale`` column, or
    ``scale=None`` for fp16 storage, whose kernels are the fp16 forms of
    ``gather_reduce`` and ``fill_gather_reduce``; their bags stay fp32.

The backward and the fused forward update ``storage`` IN PLACE (the
reference returns new arrays; with donation XLA updates in place too). The
autograd paths are functional: they work on a copy of the storage.

The reference pads the lane dim to its TPU tile; the CUDA kernels take any
``D``, so the port does not pad. Nor does it pad the LM kernels' sequence
dims to a block or chunk multiple: the kernels mask the ragged edge
themselves (the reference's zero-padded keys enter a non-causal softmax,
ROADMAP Queue 3).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gather_reduce as _gr
from repro_torch.kernels import grad_coalesce as _gc
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd_chunk as _ssd

_COUNTERS = (_gr.LAUNCHES, _gc.LAUNCHES, _fa.LAUNCHES, _ssd.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


#: set inside :func:`kernel_footprint`
_FOOTPRINT = [False]


@contextlib.contextmanager
def kernel_footprint():
    """Within: ``meta`` tensors take the hand-written kernels' route, whose
    launchers allocate what they allocate on the card and launch nothing —
    the dry run's memory pass counts the kernels' footprint, not the plain
    versions' temporaries (a (B, H, Sq, Skv) score tensor)."""
    _FOOTPRINT[0], saved = True, _FOOTPRINT[0]
    try:
        yield
    finally:
        _FOOTPRINT[0] = saved


def _route(t: torch.Tensor) -> str:
    """"cuda" (the hand-written kernel) or "cpu" (the plain version). A
    ``meta`` tensor takes the plain version's route: the dry run evaluates
    a step abstractly, shapes and dtypes only (``launch/dryrun.py``); inside
    :func:`kernel_footprint`, the kernel's."""
    if t.device.type == "meta":
        return "cuda" if _FOOTPRINT[0] else "cpu"
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for {t.device} tensors: use cuda or cpu")
    return t.device.type


# --------------------------------------------------------------------------- #
# device dispatch of the (nb, L)-shaped kernel calls
# --------------------------------------------------------------------------- #
def _gather_call(storage: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    if _route(storage) == "cuda":
        return _gr.gather_reduce(storage, flat).to(storage.dtype)
    return _ref.gather_reduce_ref(storage, flat)


def _scatter_call(storage: torch.Tensor, flat: torch.Tensor, deltas: torch.Tensor) -> None:
    if _route(storage) == "cuda":
        _gc.scatter_add(storage, flat, deltas)
    else:
        _ref.scatter_add_ref(storage, flat, deltas)


def _fused_call(storage, fill_slots, fill_rows, flat) -> torch.Tensor:
    if _route(storage) == "cuda":
        return _gr.fill_gather_reduce(storage, fill_slots, fill_rows, flat).to(
            storage.dtype)
    return _ref.fill_gather_reduce_ref(storage, fill_slots, fill_rows, flat)[1]


def _gather_q_call(storage, scale, flat) -> torch.Tensor:
    if _route(storage) == "cuda":
        if scale is None:
            return _gr.gather_reduce(storage, flat)
        return _gr.gather_reduce_q(storage, scale, flat)
    return _ref.gather_reduce_q_ref(storage, scale, flat)


def _fused_q_call(storage, scale, fill_slots, fill_rows, flat) -> torch.Tensor:
    if _route(storage) == "cuda":
        if scale is None:
            return _gr.fill_gather_reduce(storage, fill_slots, fill_rows, flat)
        return _gr.fill_gather_reduce_q(storage, scale, fill_slots, fill_rows, flat)
    return _ref.fill_gather_reduce_q_ref(storage, scale, fill_slots, fill_rows, flat)[1]


def _check_fill_slots(fill_slots: torch.Tensor) -> None:
    if bool((fill_slots < 0).any()):
        raise ValueError("fill_slots must be non-negative (pad with num_slots)")


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# --------------------------------------------------------------------------- #
# forward: gather + bag reduce
# --------------------------------------------------------------------------- #
class _GatherReduce(torch.autograd.Function):
    """bags = gather_reduce(storage, flat); d(storage) = the bag cotangents
    scattered (duplicated + coalesced) into a zeros buffer — the backward
    kernel, as in the reference's ``_gr_bwd``."""

    @staticmethod
    def forward(ctx, storage, flat):
        ctx.save_for_backward(flat)
        ctx.n_slots = storage.shape[0]
        return _gather_call(storage, flat)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        d_storage = torch.zeros(
            (ctx.n_slots, g.shape[-1]), dtype=g.dtype, device=g.device
        )
        _scatter_call(d_storage, flat, g.contiguous())
        return d_storage, None


def gather_reduce(storage: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """storage (N, D); slot_ids (..., L) int32 -> (..., D) summed bags."""
    lead = tuple(slot_ids.shape[:-1])
    L = slot_ids.shape[-1]
    D = storage.shape[1]
    if L == 0 or slot_ids.numel() == 0:  # empty cycle: no launch
        return torch.zeros(lead + (D,), dtype=storage.dtype, device=storage.device)
    flat = slot_ids.reshape(-1, L).contiguous()
    if _needs_grad(storage):
        out = _GatherReduce.apply(storage, flat)
    else:
        out = _gather_call(storage, flat)
    return out.reshape(*lead, D)


def gather_reduce_q(storage: torch.Tensor, scale, slot_ids: torch.Tensor) -> torch.Tensor:
    """Quantized-storage gather -> (..., D) fp32 bags (no cast back to the
    storage dtype: the MLP consumes fp32). storage (N, D) fp16 with
    ``scale=None``, or int8 with its (N, 1) fp32 ``scale`` column, whose
    addends are dequantized in the kernel."""
    lead = tuple(slot_ids.shape[:-1])
    L = slot_ids.shape[-1]
    D = storage.shape[1]
    if L == 0 or slot_ids.numel() == 0:  # empty cycle: no launch
        return torch.zeros(lead + (D,), dtype=torch.float32, device=storage.device)
    out = _gather_q_call(storage, scale, slot_ids.reshape(-1, L).contiguous())
    return out.reshape(*lead, D)


# --------------------------------------------------------------------------- #
# backward: duplicate + coalesce + scatter SGD update
# --------------------------------------------------------------------------- #
def coalesce_deltas(
    buf: torch.Tensor, slot_ids: torch.Tensor, deltas: torch.Tensor
) -> torch.Tensor:
    """In place: duplicate + coalesce PRE-COMPUTED per-bag deltas (..., D)
    into ``buf`` (N, D) at ``slot_ids`` (..., L), in flat bag-major order —
    the backward kernel itself. Returns ``buf``."""
    L = slot_ids.shape[-1]
    if L == 0 or slot_ids.numel() == 0:  # empty cycle: no launch
        return buf
    D = deltas.shape[-1]
    _scatter_call(
        buf, slot_ids.reshape(-1, L).contiguous(),
        deltas.reshape(-1, D).to(buf.dtype).contiguous(),
    )
    return buf


def coalesce_apply(
    storage: torch.Tensor, slot_ids: torch.Tensor, bag_grads: torch.Tensor, lr: float
) -> torch.Tensor:
    """In place: storage (N, D); slot_ids (..., L); bag_grads (..., D). The
    SGD delta is pre-rounded per bag (ref.scatter_deltas) so the kernel's
    sequential accumulation is bitwise equal to the reference's scatter-add
    (no FMA contraction inside the loop). Returns ``storage``."""
    L = slot_ids.shape[-1]
    D = bag_grads.shape[-1]
    if L == 0 or slot_ids.numel() == 0:  # empty cycle: no launch
        return storage
    deltas = _ref.scatter_deltas(storage, bag_grads, float(lr)).reshape(-1, D)
    _scatter_call(storage, slot_ids.reshape(-1, L).contiguous(), deltas.contiguous())
    return storage


# --------------------------------------------------------------------------- #
# [Insert]-fill (standalone) and the fused fill + gather forward
# --------------------------------------------------------------------------- #
def fill(
    storage: torch.Tensor, fill_slots: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """In place: storage (N, D); fill_slots (F,) int32 padded with positive
    sentinels (>= N, dropped); rows (F, D). Valid slots must be unique
    within the call; negative slots are rejected. Returns ``storage``."""
    if fill_slots.numel() == 0:  # empty cycle: no launch
        return storage
    _check_fill_slots(fill_slots)
    if _route(storage) == "cuda":
        _gr.fill(storage, fill_slots, rows)
        return storage
    return _ref.fill_ref(storage, fill_slots, rows)


class _FillGatherReduce(torch.autograd.Function):
    """(storage', bags) = fill_gather_reduce(storage, fill_slots, rows,
    flat), functional (on a copy of ``storage``). Both outputs are functions
    of the post-fill storage S', as in the reference's ``_fgr_bwd``:
    d(S') = g_storage + the bag cotangents scattered at ``flat`` (the
    backward kernel); d(rows) = d(S') at the valid filled slots; d(storage)
    = d(S') with the filled slots zeroed."""

    @staticmethod
    def forward(ctx, storage, fill_slots, fill_rows, flat):
        ctx.save_for_backward(fill_slots, flat)
        ctx.n_slots = storage.shape[0]
        ctx.rows_dtype = fill_rows.dtype
        st = storage.clone()
        return st, _fused_call(st, fill_slots, fill_rows, flat)

    @staticmethod
    def backward(ctx, g_storage, g_bags):
        fill_slots, flat = ctx.saved_tensors
        D = g_bags.shape[-1] if g_bags is not None else g_storage.shape[-1]
        if g_storage is None:
            ds = torch.zeros((ctx.n_slots, D), dtype=g_bags.dtype, device=g_bags.device)
        else:
            ds = g_storage.clone()
        if g_bags is not None:
            _scatter_call(ds, flat, g_bags.to(ds.dtype).contiguous())
        valid = fill_slots < ctx.n_slots
        filled = fill_slots[valid].long()
        d_rows = torch.zeros(
            (fill_slots.shape[0], D), dtype=ctx.rows_dtype, device=ds.device
        )
        d_rows[valid] = ds[filled].to(ctx.rows_dtype)
        ds[filled] = 0
        return ds, None, d_rows, None


def fill_gather_reduce(
    storage: torch.Tensor,
    fill_slots: torch.Tensor,
    fill_rows: torch.Tensor,
    slot_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused launch for a pipeline cycle's [Insert]-fill + gather/
    bag-reduce: returns (filled storage (N, D), bags (..., D)); the fill is
    in place. Degenerate operands fall back to the single-kernel paths
    (nothing to gather: fill only; nothing to fill: gather only)."""
    lead = tuple(slot_ids.shape[:-1])
    L = slot_ids.shape[-1]
    D = storage.shape[1]
    if L == 0 or slot_ids.numel() == 0:
        return (
            fill(storage, fill_slots, fill_rows),
            torch.zeros(lead + (D,), dtype=storage.dtype, device=storage.device),
        )
    if fill_slots.numel() == 0:
        return storage, gather_reduce(storage, slot_ids)
    _check_fill_slots(fill_slots)
    flat = slot_ids.reshape(-1, L).contiguous()
    if _needs_grad(storage, fill_rows):
        storage, bags = _FillGatherReduce.apply(storage, fill_slots, fill_rows, flat)
    else:
        bags = _fused_call(storage, fill_slots, fill_rows, flat)
    return storage, bags.reshape(*lead, D)


def fill_gather_reduce_q(
    storage: torch.Tensor,
    scale,
    fill_slots: torch.Tensor,
    fill_rows: torch.Tensor,
    slot_ids: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused quantized fill + gather -> (payload storage, (..., D) fp32
    bags); the fill is in place. ``scale=None`` is fp16 storage (the fp16
    form of the fused kernel); an (N, 1) ``scale`` — ALREADY holding this
    call's fill scales — is int8 storage (``fill_gather_reduce_q``).
    Degenerate operands fall back to the single-kernel paths, as in
    :func:`fill_gather_reduce`."""
    lead = tuple(slot_ids.shape[:-1])
    L = slot_ids.shape[-1]
    D = storage.shape[1]
    if L == 0 or slot_ids.numel() == 0:
        return (
            fill(storage, fill_slots, fill_rows),
            torch.zeros(lead + (D,), dtype=torch.float32, device=storage.device),
        )
    if fill_slots.numel() == 0:
        return storage, gather_reduce_q(storage, scale, slot_ids)
    _check_fill_slots(fill_slots)
    flat = slot_ids.reshape(-1, L).contiguous()
    bags = _fused_q_call(storage, scale, fill_slots, fill_rows, flat)
    return storage, bags.reshape(*lead, D)


# --------------------------------------------------------------------------- #
# LM kernels: attention and the Mamba2 / SSD chunked scan
# --------------------------------------------------------------------------- #
class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its hand-written backward: the forward saves
    q, k, v, its output and the per-row log-sum-exp; the backward kernel
    recomputes P from them (the reference's ``_fa_bwd`` recomputes through
    ``jax.vjp`` of its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        out = _fa.flash_attention(q, k, v, causal, window, q_offset, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, out, lse, g.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    window=None, q_offset: int = 0,
) -> torch.Tensor:
    """Attention: q (B, Sq, H, hd); k/v (B, Skv, K, hd) with H % K == 0 ->
    (B, Sq, H, hd) in q's dtype. Query row i sits at position ``q_offset``
    + i, key j at j; keys past Skv, past the causal frontier (``causal``)
    or outside ``window`` are masked. On the card, with grad enabled and an
    input that requires it, the call is differentiable through the
    backward kernel (``_FlashAttention``); otherwise (prefill, decode) it
    is the forward kernel alone. A CPU tensor takes the plain version,
    which torch's autograd differentiates."""
    B, Sq, H, hd = q.shape
    if min(B, Sq, H, hd) == 0:  # nothing to compute: no launch
        return q.new_empty(q.shape)
    if k.shape[1] == 0:  # every key masked: zeros, as the kernel would give
        return torch.zeros_like(q)
    if _route(q) == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashAttention.apply(q, k, v, causal, window, q_offset)
        return _fa.flash_attention(q, k, v, causal, window, q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)


class _SSDChunkScan(torch.autograd.Function):
    """The SSD kernel with its hand-written backward
    (``kernels/ssd_chunk.py: ssd_chunk_scan_bwd``): the forward saves its
    operands, from which the backward kernel recomputes each chunk's
    entering state (the reference differentiates its plain chunk loop,
    ``repro/models/mamba2.py: ssd_scan``, by ``jax.vjp``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Q):
        ctx.set_materialize_grads(False)
        y, h = _ssd.ssd_chunk_scan(x, dt, A, Bm, Cm, Q)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.Q = Q
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        return (*_ssd.ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, dh, ctx.Q), None)


def ssd_chunk_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 / SSD chunked scan from a zero state: x (B, S, nh, hd), dt
    (B, S, nh) fp32, A (nh,) fp32, Bm/Cm (B, S, ng, ds) fp32 -> (y (B, S,
    nh, hd) in x's dtype, h_final (B, nh, hd, ds) fp32), in chunks of
    ``min(chunk, S)`` (on the card at most 256 for bf16 ``x``: the
    tensor-core kernel's limit). On the card, with grad enabled and an
    input that requires it, the call is differentiable through the backward
    kernel (``_SSDChunkScan``); otherwise (prefill) it is the forward
    kernel alone, launched as before. A CPU tensor takes the plain version,
    which torch's autograd differentiates."""
    Bt, S, nh, hd = x.shape
    ds = Bm.shape[3]
    if min(Bt, S, nh, hd, ds) == 0:  # nothing to scan: no launch
        return (x.new_empty(x.shape),
                torch.zeros((Bt, nh, hd, ds), dtype=torch.float32, device=x.device))
    Q = min(chunk, S)
    if _route(x) == "cuda":
        args = [t.contiguous() for t in (x, dt, A, Bm, Cm)]
        if _needs_grad(*args):
            return _SSDChunkScan.apply(*args, Q)
        return _ssd.ssd_chunk_scan(*args, Q)
    return _ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, Q)
