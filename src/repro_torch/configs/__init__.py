"""Model configurations of the port: pure data, copied from ``repro/configs``
so the port never imports the JAX package.

``get_config`` / ``get_smoke_config`` resolve ``--arch`` as the reference's
registry does, for the archs the port runs: ``dlrm-scratchpipe``, the
hybrid LM ``zamba2-1.2b`` and the dense, encoder and vlm transformers. The
reference's other LM archs raise ``NotImplementedError`` naming the ROADMAP
Queue 1 item that ports their model family.
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
}

#: the reference's LM archs not ported yet -> (model family, ROADMAP Queue 1 item)
_NOT_PORTED = {
    "mamba2-2.7b": ("ssm (ssm_lm.py)", 16),
    "mixtral-8x7b": ("moe", 17),
    "llama4-scout-17b-a16e": ("moe", 17),
}


def _module(arch: str):
    if arch in _NOT_PORTED:
        family, item = _NOT_PORTED[arch]
        raise NotImplementedError(
            f"{arch} ({family}) is not ported yet: ROADMAP.md Queue 1 item {item}"
        )
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES) + sorted(_NOT_PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
