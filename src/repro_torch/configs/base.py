"""Configuration dataclasses: ``DLRMConfig``, the LM ``ModelConfig`` and
``ShapeSpec``.

Ports of the classes of the same names in ``repro/configs/base.py`` (the
reference's module is pure data too, but importing it would load the JAX
package). ``DLRMConfig`` and ``ShapeSpec`` are copied field for field;
``ModelConfig`` keeps the fields the ported LM paths and the sharding
specs read. The dry-run shape grid (``TRAIN_4K`` ... ``LONG_500K``),
``ArchEntry`` and ``lm_shape_plan`` are the reference's, copied.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-scratchpipe"
    family: str = "dlrm"
    num_tables: int = 8
    rows_per_table: int = 10_000_000
    # Heterogeneous per-table row counts (realistic Criteo-style workloads).
    # When set it overrides num_tables/rows_per_table; tables fuse into one
    # global row space at offsets cumsum(table_rows) (core.TableGroup).
    table_rows: Optional[Tuple[int, ...]] = None
    embed_dim: int = 128
    lookups_per_table: int = 20  # pooling factor (paper default 20)
    num_dense_features: int = 13
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    batch_size: int = 2048
    interaction: str = "dot"  # dot-product feature interaction (DLRM)
    param_dtype: str = "float32"  # paper uses fp32 (4-byte rows, §VI-D)
    # ScratchPipe runtime knobs
    cache_fraction: float = 0.05  # scratchpad size as fraction of table rows
    past_window: int = 3
    future_window: int = 2
    # scratchpad replica precision (fp32 host masters; fp16/int8 replicas,
    # core/quantize.py) and the re-quantization rounding of in-cache updates
    precision: str = "fp32"
    rounding: str = "stochastic"

    def __post_init__(self):
        if self.table_rows is not None:
            object.__setattr__(self, "num_tables", len(self.table_rows))
        if self.precision not in ("fp32", "fp16", "int8"):
            raise ValueError(f"bad precision {self.precision!r}")
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(f"bad rounding {self.rounding!r}")

    @property
    def table_row_list(self) -> Tuple[int, ...]:
        """Per-table row counts (uniform fallback when table_rows unset)."""
        if self.table_rows is not None:
            return self.table_rows
        return (self.rows_per_table,) * self.num_tables

    @property
    def table_offsets(self) -> Tuple[int, ...]:
        """Fused-row-space start offset of each table (len num_tables)."""
        offs, acc = [], 0
        for r in self.table_row_list:
            offs.append(acc)
            acc += r
        return tuple(offs)

    @property
    def total_rows(self) -> int:
        return sum(self.table_row_list)

    @property
    def table_bytes(self) -> int:
        return self.total_rows * self.embed_dim * 4

    def param_count(self) -> int:
        emb = self.total_rows * self.embed_dim
        dims_b = (self.num_dense_features,) + self.bottom_mlp
        bot = sum(a * b + b for a, b in zip(dims_b[:-1], dims_b[1:]))
        n_int = self.num_tables + 1
        inter_dim = n_int * (n_int - 1) // 2 + self.embed_dim
        dims_t = (inter_dim,) + self.top_mlp
        top = sum(a * b + b for a, b in zip(dims_t[:-1], dims_t[1:]))
        return emb + bot + top


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) cell of the dry-run grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the reference's ``ModelConfig`` that the ported
    serving paths (hybrid, ssm, dense, moe, encoder, vlm) and LM training
    read, with the reference's defaults, and ``scratchpipe_embedding`` (a
    flag no code reads, in the reference too), and the sharding knob the
    specs read (``fsdp``). The reference's ``zero1`` is True in every
    config, so the port has no such field and always shards the AdamW
    state with ZeRO-1 (``launch/steps.py: opt_state_specs``). Its bf16 SSD
    storage (``ssd_bf16``) has no setter in the reference and is not carried over,
    nor are two knobs of its partitioned execution: ``seq_parallel`` (no
    config sets it, and the reference's own test calls it math-preserving)
    and ``hierarchical_grad_sync`` (nothing in the reference reads it).
    Training
    always recomputes each layer in the backward and chunks the cross
    entropy by 512 tokens: no config of the reference sets ``remat`` or
    ``xent_chunk`` to another value than its default (True, 512), so they
    are not fields here."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0  # chatglm applies rotary to half the dims
    sliding_window: Optional[int] = None  # SWA: a rolling KV cache
    causal: bool = True  # False for encoder-only

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # expert hidden dim (defaults to d_ff)
    # expert capacity factor (tokens padded/dropped beyond it)
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): groups of mamba layers + shared attention block
    hybrid_groups: int = 0
    hybrid_layers_per_group: int = 0
    hybrid_tail_layers: int = 0

    # modality frontend stub: None | "frames" (audio) | "patches" (vision)
    frontend: Optional[str] = None
    frontend_positions: int = 256  # image patches prepended (vlm)

    # numerics
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # distribution: FSDP shards layer weights' d_model dim over the data axes
    fsdp: bool = False

    # the LM token-embedding table is a target of the ScratchPipe technique
    scratchpipe_embedding: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived sizes -----------------------------------------------------
    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0


# ---------------------------------------------------------------------------
# Arch entry: config + applicable shapes (with skip reasons)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: object  # ModelConfig | DLRMConfig
    smoke: object
    shapes: Tuple[ShapeSpec, ...]
    skips: Tuple[Tuple[str, str], ...] = ()  # (shape_name, reason)

    def skip_reason(self, shape_name: str) -> Optional[str]:
        for name, reason in self.skips:
            if name == shape_name:
                return reason
        return None


def lm_shape_plan(
    *, encoder_only: bool = False, subquadratic: bool = False
) -> Tuple[Tuple[ShapeSpec, ...], Tuple[Tuple[str, str], ...]]:
    """Standard shape set + documented skips for an LM-family arch."""
    shapes = [TRAIN_4K, PREFILL_32K]
    skips = []
    if encoder_only:
        skips.append(("decode_32k", "encoder-only arch has no decode step"))
        skips.append(("long_500k", "encoder-only arch has no decode step"))
    else:
        shapes.append(DECODE_32K)
        if subquadratic:
            shapes.append(LONG_500K)
        else:
            skips.append(
                (
                    "long_500k",
                    "pure full-attention arch; 500k ctx needs sub-quadratic attention",
                )
            )
    return tuple(shapes), tuple(skips)
