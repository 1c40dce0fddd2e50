"""Model configurations of the port: pure data, copied from ``repro/configs``
so the port never imports the JAX package.

``get_config`` / ``get_smoke_config`` resolve ``--arch`` as the reference's
registry does: ``dlrm-scratchpipe`` and every LM arch of the reference
(the hybrid ``zamba2-1.2b``, the attention-free ``mamba2-2.7b``, the dense,
encoder and vlm transformers, and the MoE transformers ``mixtral-8x7b`` and
``llama4-scout-17b-a16e``).
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "dlrm-scratchpipe": "dlrm_scratchpipe",
    "zamba2-1.2b": "zamba2_1_2b",
    "chatglm3-6b": "chatglm3_6b",
    "hubert-xlarge": "hubert_xlarge",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2-72b": "qwen2_72b",
    "mistral-large-123b": "mistral_large_123b",
    "mamba2-2.7b": "mamba2_2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
