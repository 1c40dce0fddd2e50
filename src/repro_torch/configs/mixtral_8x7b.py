"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096). [arXiv:2401.04088; hf].

Port of ``config`` and ``smoke_config`` of ``repro/configs/mixtral_8x7b.py``
and its dry-run ``ENTRY`` (shape plan and skips); ``fsdp`` shards the
layer weights over the data axes of a mesh.
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        fsdp=True,
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        num_experts_per_tok=2,
        sliding_window=4096,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        num_experts=4,
        num_experts_per_tok=2,
        sliding_window=64,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=True)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
