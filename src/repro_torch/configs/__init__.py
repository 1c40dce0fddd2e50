"""Model configurations of the port: pure data, copied from ``repro/configs``
so the port never imports the JAX package.

``get_entry`` / ``get_config`` / ``get_smoke_config`` resolve ``--arch`` as
the reference's registry does: ``dlrm-scratchpipe`` and every LM arch of the
reference (the hybrid ``zamba2-1.2b``, the attention-free ``mamba2-2.7b``,
the dense, encoder and vlm transformers, and the MoE transformers
``mixtral-8x7b`` and ``llama4-scout-17b-a16e``). ``dryrun_cells`` is the
reference's grid of (arch x shape) cells with their skip reasons, which
``launch/dryrun.py`` walks.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ArchEntry,
    DLRMConfig,
    ModelConfig,
    ShapeSpec,
)

#: in the reference's registry order (``dryrun_cells`` walks it)
_ARCH_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "chatglm3-6b": "chatglm3_6b",
    "qwen2-72b": "qwen2_72b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen2.5-32b": "qwen2_5_32b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "mamba2-2.7b": "mamba2_2_7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "dlrm-scratchpipe": "dlrm_scratchpipe",
}

ASSIGNED_ARCHS: List[str] = [k for k in _ARCH_MODULES if k != "dlrm-scratchpipe"]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_entry(arch: str) -> ArchEntry:
    return _module(arch).ENTRY


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def dryrun_cells(include_dlrm: bool = False) -> List[dict]:
    """Every (arch x shape) cell, with skip annotations. 40 LM cells total."""
    cells = []
    archs = list(_ARCH_MODULES) if include_dlrm else ASSIGNED_ARCHS
    for arch in archs:
        entry = get_entry(arch)
        if arch == "dlrm-scratchpipe":
            for s in entry.shapes:
                cells.append({"arch": arch, "shape": s.name, "skip": None})
            continue
        for s in ALL_SHAPES:
            reason = entry.skip_reason(s.name)
            runnable = any(sh.name == s.name for sh in entry.shapes)
            cells.append({"arch": arch, "shape": s.name,
                          "skip": reason if not runnable else None})
    return cells
