"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. [hf:mistralai/Mistral-Large-Instruct-2407].

Port of ``config`` and ``smoke_config`` of ``repro/configs/mistral_large_123b.py`` and its
dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        fsdp=True,
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=32768,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        d_ff=160,
        vocab_size=128,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=False)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
