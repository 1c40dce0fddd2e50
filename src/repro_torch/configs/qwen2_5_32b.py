"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
GQA + QKV bias. [hf:Qwen/Qwen2.5-32B].

Port of ``config`` and ``smoke_config`` of ``repro/configs/qwen2_5_32b.py`` and its
dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        fsdp=True,
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=128,
        qkv_bias=True,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=False)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
