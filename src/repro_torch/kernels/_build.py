"""Build the port's CUDA sources at first use (no JAX counterpart).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, which ``kernels/gather_reduce.py`` loads with
``ctypes``. That builds in seconds, where an extension that includes
PyTorch's headers takes minutes. Libraries go to ``build/repro_torch/`` at
the root of the checkout (git-ignored), in a directory keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. Several sources build in parallel: one ``nvcc`` each, all
started together.

No ``--use_fast_math`` and no ``-ftz=true``: flushing subnormals to zero
would break the bitwise agreement with the plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when a library of the same hash already existed
    log: str  # nvcc's output (ptxas register report); empty when reused


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (neither under CUDA_HOME nor on PATH): the port's "
            "CUDA kernels are built on the machine that has the card"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the source and any .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{name}.so"


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, BuildResult]:
    """Build (or reuse) ``lib<name>.so`` for each ``csrc/<name>.cu`` —
    every source when ``names`` is None. Raises with nvcc's output if any
    build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    results: Dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            results[name] = BuildResult(name, target, 0.0, "")
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
            time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees half a file
        results[name] = BuildResult(name, target, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def library_path(name: str) -> Path:
    """Path of the built ``lib<name>.so``, building it first if needed."""
    return build_all([name])[name].path
