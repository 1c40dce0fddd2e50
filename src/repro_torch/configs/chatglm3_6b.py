"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
RoPE applied to half the head dims (2d rope approximated), QKV bias.
[arXiv:2406.12793; hf].

Port of ``config`` and ``smoke_config`` of ``repro/configs/chatglm3_6b.py`` and its
dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        qkv_bias=True,
        rope_fraction=0.5,  # chatglm rotary on half dims (2d rope analogue)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
        rope_fraction=0.5,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=False)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
