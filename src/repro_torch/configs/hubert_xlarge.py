"""hubert-xlarge [audio, encoder-only]: 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (k-means units). [arXiv:2106.07447]. Frontend stubbed to precomputed
frame embeddings per the assignment brief.

Port of ``config`` and ``smoke_config`` of ``repro/configs/hubert_xlarge.py`` and its
dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        frontend="frames",
        rope_theta=0.0,  # hubert uses (stubbed) conv positional embedding, not rope
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke",
        family="encoder",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        causal=False,
        frontend="frames",
        rope_theta=0.0,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(encoder_only=True)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
