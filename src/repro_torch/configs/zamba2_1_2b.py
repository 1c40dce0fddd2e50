"""zamba2-1.2b [hybrid]: 38 mamba2 layers d_model=2048 + shared attention block
(32H kv=32, d_ff=8192) applied every 6 layers, ssm_state=64.
[arXiv:2411.15242; hf]. Structured as 6 groups x 6 mamba layers + shared-attn
application, plus a 2-layer mamba tail (6*6+2 = 38 layers).

Port of ``config`` and ``smoke_config`` of ``repro/configs/zamba2_1_2b.py``
and its dry-run ``ENTRY`` (shape plan and skips).
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=256,
        hybrid_groups=6,
        hybrid_layers_per_group=6,
        hybrid_tail_layers=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        num_layers=5,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=16,
        ssm_ngroups=1,
        ssm_conv=4,
        ssm_chunk=16,
        hybrid_groups=2,
        hybrid_layers_per_group=2,
        hybrid_tail_layers=1,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=True)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
