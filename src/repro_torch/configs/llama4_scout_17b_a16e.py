"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+ shared expert), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]. Largest embedding table in the pool ->
primary LM target for the paper's embedding-cache technique.

Port of ``config`` and ``smoke_config`` of
``repro/configs/llama4_scout_17b_a16e.py`` (the reference's model has no
shared expert either) and its dry-run ``ENTRY``; ``fsdp`` shards the layer
weights over the data axes of a mesh.
"""
from repro_torch.configs.base import ArchEntry, ModelConfig, lm_shape_plan


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        fsdp=True,
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        num_experts_per_tok=1,
        rope_theta=5e5,
        scratchpipe_embedding=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=1,
        param_dtype="float32",
        compute_dtype="float32",
    )


_shapes, _skips = lm_shape_plan(subquadratic=False)
ENTRY = ArchEntry(config=config(), smoke=smoke_config(), shapes=_shapes, skips=_skips)
