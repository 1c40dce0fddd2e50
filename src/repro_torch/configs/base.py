"""Configuration dataclasses: ``DLRMConfig``, the LM ``ModelConfig`` and
``ShapeSpec``.

Ports of the classes of the same names in ``repro/configs/base.py`` (the
reference's module is pure data too, but importing it would load the JAX
package). ``DLRMConfig`` and ``ShapeSpec`` are copied field for field;
``ModelConfig`` keeps the fields the ported LM paths read. The reference's
dry-run shape grid and arch registry are not ported:
``configs/__init__.py`` resolves the archs the port runs.
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


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the reference's ``ModelConfig`` that the ported
    serving paths (hybrid, ssm, dense, moe, encoder, vlm) and LM training
    read, with the reference's defaults, and ``scratchpipe_embedding`` (a
    flag no code reads, in the reference too). Its bf16 SSD storage
    (``ssd_bf16``) has no setter in the reference and is not carried over;
    its sharding and scan knobs have no meaning on one card. Training
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
