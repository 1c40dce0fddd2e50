"""Dense transformer LM, MoE transformer (mixtral, llama4-scout; through
``models/moe.py``), encoder-only (hubert) and VLM backbone (phi-3-vision):
serving and training; and the token embedding the hybrid and ssm families
share.

Port of ``repro/models/transformer.py``. Its specs are ported
(:func:`layer_specs`, :func:`param_specs`, :func:`cache_spec`: the
reference's rules, per layer, without the stacked [L] dim, which no rule
shards). Training also runs partitioned over a mesh (:func:`loss_fn` with
``mesh=``: tensor-parallel attention, MLP and experts, the vocab-sharded
embedding and cross entropy, FSDP gathers inside each checkpointed
layer), and so do prefill and decode (:func:`prefill` / :func:`decode_step`
with ``mesh=``: the same partitioned layers, each rank holding its share
of the KV cache under :func:`cache_spec` — its kv heads, or a block of
slots of every head, or all of it — and the greedy pick vocab-parallel).
The reference's sequence-parallel residual
(``_sp_constraint``, under ``seq_parallel``, which no config sets) is not
carried over. The reference stacks the layers on a leading [L] axis and
scans them; the port keeps a list of per-layer parameter dicts
(``params["layers"][i]``) and loops. Prefill reaches the flash kernel once per layer
(``layers.chunked_attention``); decode is plain torch against the KV cache
``{"k", "v"}`` of shape (L, B, S, K, hd), stacked as in the reference and
written in place (a ring of slots ``pos % S`` under ``cfg.sliding_window``:
``layers.ring_kv`` lays a prefill's keys out for it). Training
(:func:`loss_fn`, the reference's) runs the same layers with the grad on,
each under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
at its default ``remat``), so the flash kernel runs forward, again in the
recompute, and its backward kernel once per layer per step.

Families: ``dense`` (RMSNorm, SwiGLU), ``moe`` (RMSNorm, the routed SwiGLU
experts of ``models/moe.py``; its aux loss is returned by ``_ffn``,
summed over the layers by training and dropped by serving, as the
reference's prefill drops it), ``encoder``
(LayerNorm with bias, the tanh GELU MLP with biases; non-causal), ``vlm``
(a dense backbone whose ``patches`` frontend is prepended to the token
embeddings). The frontends are stubs in the reference too: precomputed
frame (``FRAME_DIM``) or patch (``PATCH_DIM``) embeddings, projected by
``frontend_proj``. The fused gate/up and offloaded-embedding knobs (no
config of the port sets them) and the reference's ``scan_layers`` (a
``lax.scan`` over stacked layers; the port loops over a list) are not
carried over.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import MeshAxes, P, dp_axis, model_size, shard_dim

FRAME_DIM = 512  # audio frontend stub: precomputed frame-embedding width
PATCH_DIM = 1024  # vision frontend stub: precomputed patch-embedding width


# ---------------------------------------------------------------------------
# Layer init / forward / decode
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg, device):
    """One layer's params in ``cfg.param_dtype``, scaled as in the
    reference (draws from ``gen``)."""
    dt = getattr(torch, cfg.param_dtype)
    D, F = cfg.d_model, cfg.d_ff

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=device)

    p = {"attn": L.init_attention(gen, cfg, device=device)}
    if cfg.family == "encoder":  # LN + gelu MLP (hubert-style)
        p["attn_norm"] = {"w": ones(D), "b": zeros(D)}
        p["mlp_norm"] = {"w": ones(D), "b": zeros(D)}
        p["mlp"] = {"w1": normal((D, F), 1.0 / math.sqrt(D)), "b1": zeros(F),
                    "w2": normal((F, D), 1.0 / math.sqrt(F)), "b2": zeros(D)}
    elif cfg.family == "moe":
        p["attn_norm"] = ones(D)
        p["mlp_norm"] = ones(D)
        p["mlp"] = moe.init_moe_mlp(gen, cfg, device)
    else:
        p["attn_norm"] = ones(D)
        p["mlp_norm"] = ones(D)
        p["mlp"] = {"w_gate": normal((D, F), 1.0 / math.sqrt(D)),
                    "w_up": normal((D, F), 1.0 / math.sqrt(D)),
                    "w_down": normal((F, D), 1.0 / math.sqrt(F))}
    return p


def _norm(cfg, x, n):
    if cfg.family == "encoder":
        return L.layer_norm(x, n["w"], n["b"], cfg.norm_eps)
    return L.rms_norm(x, n, cfg.norm_eps)


def ffn(cfg, m, h, mesh=None):
    """Returns (delta, aux loss): the MoE's fp32 scalar, 0.0 otherwise.
    With a ``mesh`` the MLP is tensor-parallel where its inner dim shards
    over "model": h goes in through ``copy_to_axis``, the column-parallel
    products give this rank's inner slice, the row-parallel one a partial
    sum, summed over "model" (GELU's ``b2``, replicated, added once after
    the sum); an inner dim that does not divide runs whole on every rank."""
    if mesh is not None and cfg.family != "moe" and cfg.d_ff % model_size(mesh) == 0:
        h = C.copy_to_axis(h, mesh)
        if cfg.family == "encoder":
            y = F.gelu(h @ m["w1"] + m["b1"], approximate="tanh") @ m["w2"]
            return C.sum_over_axis(y, mesh) + m["b2"], 0.0
        return C.sum_over_axis(L.swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), mesh), 0.0
    if cfg.family == "encoder":
        return L.gelu_mlp(h, m["w1"], m["b1"], m["w2"], m["b2"]), 0.0
    if cfg.family == "moe":
        return moe.moe_ffn(cfg, m, h, mesh)
    return L.swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), 0.0


def _layer(cfg, p, x, positions, mesh=None):
    a, k, v = L.attention_forward(p["attn"], _norm(cfg, x, p["attn_norm"]), positions, cfg,
                                  mesh)
    x = x + a
    delta, aux = ffn(cfg, p["mlp"], _norm(cfg, x, p["mlp_norm"]), mesh)
    return x + delta, k, v, aux


def train_layer(cfg, p, x, positions, mesh=None, specs=None):
    """One layer of the training forward: (x, its aux loss). With a
    ``mesh``, ``p`` is this rank's shards under ``specs`` (the layer's
    :func:`layer_specs`): FSDP weights are gathered over the data axes here,
    inside the checkpointed call, so the recompute gathers them again and
    no whole layer outlives its step."""
    if mesh is not None:
        p = C.gather_tree_over_data(p, specs, mesh)
    x, _, _, aux = _layer(cfg, p, x, positions, mesh)
    return x, aux


def serve_layer(cfg, p, x, positions, mesh=None, specs=None):
    """One layer of serving's prefill over x (B, S, D) at ``positions`` (B,
    S): (x, the post-RoPE k and v the KV cache keeps of it,
    ``layers.attention_prefill``'s; the aux loss is dropped). With a ``mesh``, ``p`` is this
    rank's shards under ``specs``, FSDP weights gathered for the call (as
    :func:`train_layer` gathers them), and the attention, MLP and experts
    run tensor-parallel as in training."""
    if mesh is not None:
        p = C.gather_tree_over_data(p, specs, mesh)
    a, k, v = L.attention_prefill(p["attn"], _norm(cfg, x, p["attn_norm"]), positions, cfg,
                                  mesh)
    x = x + a
    delta, _ = ffn(cfg, p["mlp"], _norm(cfg, x, p["mlp_norm"]), mesh)
    return x + delta, k, v


def layer_decode(cfg, p, x, pos: int, kc, vc, mesh=None, specs=None, kv_slots=None):
    """One token through one layer; ``kc``/``vc`` (B, S, K, hd) written in
    place at ``pos``. With a ``mesh``: ``p`` this rank's shards under
    ``specs`` (FSDP weights gathered for the call), the caches its share of
    ``kv_slots`` global slots (``layers.attention_decode``)."""
    if mesh is not None:
        p = C.gather_tree_over_data(p, specs, mesh)
    a, kc, vc = L.attention_decode(p["attn"], _norm(cfg, x, p["attn_norm"]), pos, kc, vc, cfg,
                                   mesh, kv_slots)
    x = x + a
    delta, _ = ffn(cfg, p["mlp"], _norm(cfg, x, p["mlp_norm"]), mesh)
    return x + delta, kc, vc


def layer_specs(cfg, ax: MeshAxes):
    """Specs of one layer's params (``init_layer``'s tree; the reference's
    ``layer_specs`` without its leading [L] dim). TP: heads / FFN-inner over
    "model". FSDP (``cfg.fsdp``): the d_model dim of every layer weight also
    shards over the data axes."""
    m = ax.model
    H, K, hd, F, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.d_model
    h_ax = shard_dim(ax, H * hd, m) if H % ax.model_size == 0 else None
    k_ax = m if K % ax.model_size == 0 else None
    f_ax = shard_dim(ax, F, m)
    d_ax = shard_dim(ax, D, dp_axis(ax)) if cfg.fsdp else None
    attn = {"wq": P(d_ax, h_ax), "wk": P(d_ax, k_ax), "wv": P(d_ax, k_ax),
            "wo": P(h_ax, d_ax)}
    if cfg.qkv_bias:
        attn.update(bq=P(h_ax), bk=P(k_ax), bv=P(k_ax))
    sp = {"attn": attn}
    if cfg.family == "encoder":
        sp["attn_norm"] = {"w": P(None), "b": P(None)}
        sp["mlp_norm"] = {"w": P(None), "b": P(None)}
        sp["mlp"] = {"w1": P(d_ax, f_ax), "b1": P(f_ax), "w2": P(f_ax, d_ax), "b2": P(None)}
    else:
        sp["attn_norm"] = P(None)
        sp["mlp_norm"] = P(None)
        if cfg.family == "moe":
            sp["mlp"] = moe.moe_mlp_specs(cfg, ax)
        else:
            sp["mlp"] = {"w_gate": P(d_ax, f_ax), "w_up": P(d_ax, f_ax),
                         "w_down": P(f_ax, d_ax)}
    return sp


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_params(cfg, gen: torch.Generator, vocab_pad: int, device=None):
    """Random params from ``gen`` (draws on ``device``, the generator's by
    default), scaled as in the reference."""
    device = device or gen.device
    dt = getattr(torch, cfg.param_dtype)
    D = cfg.d_model

    def normal(shape, std):
        return L.normal(gen, shape, std, dt, device)

    params = {
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": (
            {"w": torch.ones((D,), dtype=dt, device=device),
             "b": torch.zeros((D,), dtype=dt, device=device)}
            if cfg.family == "encoder" else torch.ones((D,), dtype=dt, device=device)),
        "embed": normal((vocab_pad, D), 0.02),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, vocab_pad), 0.02)
    if cfg.frontend == "frames":
        params["frontend_proj"] = normal((FRAME_DIM, D), 0.02)
    elif cfg.frontend == "patches":
        params["frontend_proj"] = normal((PATCH_DIM, D), 0.02)
    return params


def param_specs(cfg, ax: MeshAxes, vocab_pad: int):
    """Specs of ``init_params``' tree: the vocab rows of ``embed`` and the
    vocab columns of ``lm_head`` over "model", d_model over the data axes
    under FSDP, one :func:`layer_specs` per layer."""
    v_ax = shard_dim(ax, vocab_pad, ax.model)
    d_ax = shard_dim(ax, cfg.d_model, dp_axis(ax)) if cfg.fsdp else None
    sp = {
        "layers": [layer_specs(cfg, ax) for _ in range(cfg.num_layers)],
        "final_norm": ({"w": P(None), "b": P(None)} if cfg.family == "encoder"
                       else P(None)),
        "embed": P(v_ax, d_ax),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = P(d_ax, v_ax)
    if cfg.frontend:
        sp["frontend_proj"] = P(None, None)
    return sp


def _whole_over_data(params, name, mesh, specs):
    """``params[name]`` with its FSDP dims gathered over the data axes."""
    if mesh is None:
        return params[name]
    return C.gather_tree_over_data(params[name], specs[name], mesh)


def embed_tokens(params, cfg, tokens: torch.Tensor, mesh=None, specs=None) -> torch.Tensor:
    """tokens (B, S) int -> (B, S, D) rows of ``params["embed"]`` in the
    compute dtype. With a ``mesh`` whose "model" axis is wider than 1, the
    table is this rank's row block and the lookup vocab-sharded
    (``collectives.vocab_sharded_lookup``: the reference's condition, the
    padded rows dividing over "model", holds by ``runtime_config``); its
    FSDP-sharded d_model is gathered first."""
    table = _whole_over_data(params, "embed", mesh, specs)
    if model_size(mesh) > 1:
        emb = C.vocab_sharded_lookup(table, tokens, mesh)
    else:
        emb = table[tokens.long()]
    return emb.to(getattr(torch, cfg.compute_dtype))


def build_inputs(params, cfg, batch, mesh=None, specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x (B, S, D), positions (B, S) int32). ``inputs_embeds``
    bypasses the embedding lookup; the ``frames`` frontend projects
    precomputed frames, the ``patches`` frontend prepends projected patches
    to the token embeddings."""
    dt = getattr(torch, cfg.compute_dtype)
    if "inputs_embeds" in batch:
        x = batch["inputs_embeds"].to(dt)
    elif cfg.frontend == "frames":
        x = batch["frames"].to(dt) @ params["frontend_proj"].to(dt)
    elif cfg.frontend == "patches":
        patches = batch["patches"].to(dt) @ params["frontend_proj"].to(dt)
        x = torch.cat([patches, embed_tokens(params, cfg, batch["tokens"], mesh, specs)], dim=1)
    else:
        x = embed_tokens(params, cfg, batch["tokens"], mesh, specs)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def head_weight(params, cfg, mesh=None, specs=None):
    """(D, Vpad) — with a ``mesh``, this rank's vocab column block, its FSDP
    dim gathered: the tied head is the embed shard's transpose."""
    if cfg.tie_embeddings:
        return _whole_over_data(params, "embed", mesh, specs).T
    return _whole_over_data(params, "lm_head", mesh, specs)


def run_layers(cfg, layer_params, x, positions, mesh=None, layer_specs_=None):
    """The layers in order -> (x, the aux losses summed over the layers, an
    fp32 scalar). Each layer is recomputed in the backward (non-reentrant
    ``torch.utils.checkpoint``: only its input is kept), as the reference's
    ``jax.checkpoint`` of its scan body. With a ``mesh``, each layer's
    shards and specs go to :func:`train_layer`."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(layer_params):
        extra = () if mesh is None else (mesh, layer_specs_[i])
        x, a = checkpoint(train_layer, cfg, lp, x, positions, *extra, use_reentrant=False)
        aux = aux + a
    return x, aux


def forward_hidden(params, cfg, batch, mesh=None, specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the final-normed hidden states (B, S, D), the summed aux loss)."""
    x, positions = build_inputs(params, cfg, batch, mesh, specs)
    x, aux = run_layers(cfg, params["layers"], x, positions, mesh,
                        None if specs is None else specs["layers"])
    return _norm(cfg, x, params["final_norm"]), aux


def xent_loss(cfg, x, head, batch, mesh=None, aux=None) -> torch.Tensor:
    """The training loss of the final-normed hidden states x (B, S, D): the
    chunked cross entropy through ``head`` (D, Vpad) against
    ``batch["labels"]`` (``loss_mask`` optional), plus ``aux`` (an fp32
    scalar, the MoE aux loss) where given; an fp32 scalar. Every LM
    family's loss ends here.

    With a ``mesh``, ``head`` is this rank's vocab block, x and ``batch``
    its data shard, and the loss is that of the whole batch, the same on
    every rank: this rank's addend — its masked cross-entropy sum over the
    mask count of the whole batch, plus ``aux`` over the number of data
    ranks (the reference ``pmean``s each MoE layer's over the data axes) —
    summed over the data ranks by ``collectives.sum_over_data``, whose
    backward is the identity, so each rank's gradients are those of its
    own addend."""
    labels, mask = batch["labels"], batch.get("loss_mask")
    if mesh is None:
        xent = C.sharded_xent_loss(x, head.to(x.dtype), labels, mask, true_vocab=cfg.vocab_size)
        return xent if aux is None else xent + aux
    count = (torch.sum(mask.float()) if mask is not None
             else torch.full((), labels.numel(), dtype=torch.float32, device=x.device))
    count = torch.clamp(C.sum_over_data(count.detach(), mesh), min=1.0)
    xent = C.sharded_xent_loss(x, head.to(x.dtype), labels, mask, true_vocab=cfg.vocab_size,
                               mesh=mesh, denominator=count)
    if aux is not None:
        xent = xent + aux / C.data_size(mesh)
    return C.sum_over_data(xent, mesh)


def loss_fn(params, cfg, batch, mesh=None, specs=None) -> torch.Tensor:
    """The training loss: :func:`xent_loss` of the hidden states (a vlm's
    image positions carry no loss) plus the aux loss; an fp32 scalar.

    With a ``mesh`` (``DeviceMesh`` ("data", "model") or ("pod", "data",
    "model")), ``params`` are this rank's shards under ``specs``
    (:func:`param_specs` of the padded ``cfg``) and ``batch`` its data
    shard; the loss is the whole batch's, on every rank."""
    x, aux = forward_hidden(params, cfg, batch, mesh, specs)
    if cfg.frontend == "patches":  # image positions carry no LM loss
        x = x[:, batch["patches"].shape[1]:]
    return xent_loss(cfg, x, head_weight(params, cfg, mesh, specs), batch, mesh, aux)


def cache_slots(cfg, seq_len: int) -> int:
    """The slots of a KV cache laid out for ``seq_len`` positions: capped
    at ``cfg.sliding_window`` (the ring's size)."""
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg, batch_size: int, seq_len: int, device="cpu", dtype=None):
    """Zero KV caches (L, B, S, K, hd), S capped at ``cfg.sliding_window``."""
    dt = dtype or getattr(torch, cfg.compute_dtype)
    shape = (cfg.num_layers, batch_size, cache_slots(cfg, seq_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_spec(cfg, ax: MeshAxes, batch_size: int, seq_len: int):
    """(L, B, S, K, hd): B over data if divisible; K over model if divisible,
    else S over model (sequence-parallel KV)."""
    b_ax = shard_dim(ax, batch_size, dp_axis(ax))
    S = cache_slots(cfg, seq_len)
    if cfg.num_kv_heads % ax.model_size == 0:
        spec = P(None, b_ax, None, ax.model, None)
    elif S % ax.model_size == 0:
        spec = P(None, b_ax, ax.model, None, None)
    else:
        spec = P(None, b_ax, None, None, None)
    return {"k": spec, "v": spec}


def prefill(params, cfg, batch, mesh=None, specs=None):
    """Forward over the whole prompt: (last-position logits (B, Vpad) fp32,
    the KV cache {"k", "v"} (L, B, S', K, hd) of the post-RoPE keys and
    values of positions S - S' .. S - 1, in order; S' = S, or at most
    ``cfg.sliding_window``). Decode takes it through ``layers.ring_kv``.

    With a ``mesh``, ``params`` are this rank's shards under ``specs``
    (:func:`param_specs` of the padded ``cfg``) and ``batch`` its data
    shard: each layer runs partitioned (:func:`serve_layer`), the cache is
    this rank's share under :func:`cache_spec` at S' (``layers.kv_share``),
    and the logits are vocab-parallel, gathered over "model" into the
    (B, Vpad) rows every model rank holds."""
    x, positions = build_inputs(params, cfg, batch, mesh, specs)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        x, k, v = serve_layer(cfg, lp, x, positions, mesh,
                              None if specs is None else specs["layers"][i])
        if cfg.sliding_window:
            k, v = k[:, -cfg.sliding_window:], v[:, -cfg.sliding_window:]
        ks.append(L.kv_share(k, mesh, cfg.num_kv_heads))
        vs.append(L.kv_share(v, mesh, cfg.num_kv_heads))
    x = _norm(cfg, x, params["final_norm"])
    logits = C.sharded_logits(x[:, -1], head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params, cfg, cache, tokens, pos: int, mesh=None, specs=None, kv_slots=None):
    """One greedy step: tokens (B, 1) int32 at position ``pos`` -> (next
    tokens (B, 1) int32, cache). The cache is updated in place (and
    returned). With a ``mesh``: ``params`` this rank's shards under
    ``specs``, ``tokens`` its data shard, the cache its share of a cache of
    ``kv_slots`` slots (capped at the window); the greedy pick is the
    argmax of the (B, Vpad) logits gathered over "model", so a tie breaks
    as over the whole row."""
    x = embed_tokens(params, cfg, tokens, mesh, specs)
    slots = None if kv_slots is None else cache_slots(cfg, kv_slots)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = layer_decode(cfg, lp, x, pos, cache["k"][i], cache["v"][i], mesh,
                               None if specs is None else specs["layers"][i], slots)
    x = _norm(cfg, x, params["final_norm"])
    logits = C.sharded_logits(x[:, 0], head_weight(params, cfg, mesh, specs).to(x.dtype),
                              cfg.vocab_size, mesh)
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache
