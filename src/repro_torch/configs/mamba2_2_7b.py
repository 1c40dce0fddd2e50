"""mamba2-2.7b [ssm, attention-free]: 64L d_model=2560 vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060].

Port of ``config`` and ``smoke_config`` of ``repro/configs/mamba2_2_7b.py``
and its dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=128,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=16,
        tie_embeddings=True,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=True)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
