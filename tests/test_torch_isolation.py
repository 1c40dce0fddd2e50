"""The port stands alone: no JAX, nothing of ``repro``, card by default.

  * importing every module of ``repro_torch`` (and ``chip_smoke.py``) in a
    fresh interpreter loads neither ``jax`` nor any ``repro`` module;
  * no source file of the port, nor ``chip_smoke.py``, names them in an
    import statement;
  * the launchers, the runtimes and the trainer default to ``cuda`` and
    raise when no card is visible, instead of continuing on the CPU — at
    fp16/int8 replica precision too.
"""
import ast
import dataclasses
import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs.dlrm_scratchpipe import smoke_config
from repro_torch.core import scratchpad as sp
from repro_torch.core.dlrm_runtime import DLRMTrainer
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.pipeline import ScratchPipe
from repro_torch.core.serving_cache import (
    NoCacheServer,
    ReadOnlyCacheServer,
    StaticCacheServer,
)
from repro_torch.core.static_cache import NoCacheBaseline, StaticCacheBaseline
from repro_torch.launch import serve, train

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
              "repro_torch.launch.serve", "repro_torch.convert",
              "repro_torch.launch.train", "repro_torch.core.pipeline",
              "repro_torch.models.dlrm", "repro_torch.kernels.grad_coalesce",
              "repro_torch.core.dlrm_runtime", "repro_torch.core.static_cache",
              "repro_torch.configs.dlrm_scratchpipe", "repro_torch.data.lookahead",
              "repro_torch.core.quantize", "repro_torch.core.scratchpad",
              "repro_torch.core.plan_device", "repro_torch.traces.format",
              "repro_torch.traces.recorder", "repro_torch.traces.replay",
              "repro_torch.traces.profiling", "repro_torch.traces.criteo",
              "repro_torch.traces.scenarios", "repro_torch.serving.frontend"):
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
    args = train.build_parser().parse_args(["--arch", "dlrm-scratchpipe"])
    assert args.device == "cuda"
    for fn in (ReadOnlyCacheServer.__init__, NoCacheServer.__init__,
               StaticCacheServer.__init__,
               sp.make_storage, ScratchPipe.__init__, DLRMTrainer.__init__,
               NoCacheBaseline.__init__, StaticCacheBaseline.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = HostEmbeddingTable(50, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReadOnlyCacheServer(host, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NoCacheServer(host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCacheServer(host, [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.make_storage(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--embedding", "--steps", "2", "--rows", "50", "--dim", "4"])
    noop = lambda s, slots, b: (s, {})  # noqa: E731
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScratchPipe(host, 16, noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRMTrainer(smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NoCacheBaseline(host, noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCacheBaseline(host, [1, 2], noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "2"])


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_reduced_precision_without_a_card_raises(monkeypatch, precision):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = HostEmbeddingTable(50, 4, seed=0)
    noop = lambda s, slots, b: (s, {})  # noqa: E731
    cfg = dataclasses.replace(smoke_config(), precision=precision)
    for make in (lambda: ScratchPipe(host, 16, noop, precision=precision),
                 lambda: ReadOnlyCacheServer(host, 16, precision=precision),
                 lambda: StaticCacheBaseline(host, [1, 2], noop, precision=precision),
                 lambda: DLRMTrainer(cfg),
                 lambda: sp.make_storage(4, 4, precision=precision),
                 lambda: train.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps",
                                     "2", "--precision", precision])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


LM_MODULES = ("repro_torch.models.layers", "repro_torch.models.mamba2",
              "repro_torch.models.transformer", "repro_torch.models.hybrid",
              "repro_torch.models.api", "repro_torch.parallel.collectives",
              "repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_chunk",
              "repro_torch.configs.zamba2_1_2b")


def test_lm_modules_listed_and_import_nothing_of_jax():
    """The LM slice's modules are part of the port (so the import checks
    above cover them), and loading them alone loads no jax or repro."""
    mods = _port_modules()
    for m in LM_MODULES:
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {LM_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print('BAD', sorted(m for m in sys.modules\n"
        "                    if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_lm_serving_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    args = serve.build_parser().parse_args(["--arch", "zamba2-1.2b"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-1.2b", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cuda:0"])


@pytest.mark.parametrize("arch,item", [
    ("hubert-xlarge", 15), ("chatglm3-6b", 15), ("qwen2-72b", 15),
    ("mistral-large-123b", 15), ("qwen2.5-32b", 15), ("phi-3-vision-4.2b", 15),
    ("mamba2-2.7b", 16), ("mixtral-8x7b", 17), ("llama4-scout-17b-a16e", 17),
])
def test_other_lm_archs_name_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}$"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_unknown_arch_and_missing_mode():
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-model", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])


def _lm_training_message(capsys):
    with pytest.raises(SystemExit):
        train.main(["--arch", "zamba2-1.2b", "--device", "cpu"])
    return capsys.readouterr().err


def _adaptive_pad_message(capsys):
    with pytest.raises(SystemExit):
        train.main(["--arch", "dlrm-scratchpipe", "--smoke", "--device", "cpu",
                    "--adaptive-pad"])
    return capsys.readouterr().err


@pytest.mark.parametrize("message,item", [
    (_lm_training_message, 18),  # LM training
    (_adaptive_pad_message, 10),  # trace-derived pad buckets
], ids=["lm-training", "adaptive-pad"])
def test_not_ported_messages_name_their_roadmap_item(capsys, message, item):
    """What is not ported yet says where ROADMAP.md queues it."""
    assert f"ROADMAP.md Queue 1 item {item})" in message(capsys)
