"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32, MHA) d_ff=8192
vocab=32064. phi3-mini backbone + CLIP frontend; frontend stubbed to
precomputed patch embeddings per the assignment brief.
[hf:microsoft/Phi-3-vision-128k-instruct].

Port of ``config`` and ``smoke_config`` of ``repro/configs/phi_3_vision_4_2b.py`` and its
dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        frontend="patches",
        frontend_positions=256,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend="patches",
        frontend_positions=8,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=False)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
