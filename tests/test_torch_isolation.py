"""The port stands alone: no JAX, nothing of ``repro``, card by default.

  * importing every module of ``repro_torch`` (and ``chip_smoke.py``) in a
    fresh interpreter loads neither ``jax`` nor any ``repro`` module;
  * no source file of the port, nor ``chip_smoke.py``, names them in an
    import statement;
  * the launcher and the runtimes default to ``cuda`` and raise when no
    card is visible, instead of continuing on the CPU.
"""
import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import scratchpad as sp
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.serving_cache import NoCacheServer, ReadOnlyCacheServer
from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(repro_torch.__file__)
CHIP_SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_modules():
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG_DIR], prefix="repro_torch.")
    ]


def _port_sources():
    out = [CHIP_SMOKE]
    for dirpath, _, files in os.walk(PKG_DIR):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_listed():
    mods = _port_modules()
    for m in ("repro_torch.kernels.ops", "repro_torch.core.serving_cache",
              "repro_torch.launch.serve", "repro_torch.convert"):
        assert m in mods


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_or_reference_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, node.lineno, name)


def test_entry_points_default_to_cuda():
    assert serve.build_parser().parse_args(["--embedding"]).device == "cuda"
    for fn in (ReadOnlyCacheServer.__init__, NoCacheServer.__init__,
               sp.make_storage):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = HostEmbeddingTable(50, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReadOnlyCacheServer(host, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NoCacheServer(host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.make_storage(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--embedding", "--steps", "2", "--rows", "50", "--dim", "4"])
