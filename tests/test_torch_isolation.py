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
from repro_torch.core.sharded_pipeline import ShardedScratchPipe
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
              "repro_torch.traces.scenarios", "repro_torch.serving.frontend",
              "repro_torch.core.sharded_pipeline", "repro_torch.obs",
              "repro_torch.obs.metrics", "repro_torch.obs.tracing",
              "repro_torch.obs.check", "repro_torch.checkpoint.manager",
              "repro_torch.checkpoint.pack", "repro_torch.chaos.injector",
              "repro_torch.runtime.supervision", "repro_torch.runtime.fault_tolerance",
              "repro_torch.models.transformer", "repro_torch.configs.chatglm3_6b",
              "repro_torch.configs.hubert_xlarge", "repro_torch.configs.phi_3_vision_4_2b",
              "repro_torch.configs.qwen2_5_32b", "repro_torch.configs.qwen2_72b",
              "repro_torch.configs.mistral_large_123b", "repro_torch.optim",
              "repro_torch.optim.optimizers", "repro_torch.launch.steps",
              "repro_torch.parallel.collectives"):
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
               NoCacheBaseline.__init__, StaticCacheBaseline.__init__,
               ShardedScratchPipe.__init__):
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
        ShardedScratchPipe(host, 16, 2, noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRMTrainer(smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NoCacheBaseline(host, noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticCacheBaseline(host, [1, 2], noop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "dlrm-scratchpipe", "--smoke", "--steps", "2", "--tables", "4"])


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
              "repro_torch.configs.zamba2_1_2b", "repro_torch.configs.chatglm3_6b",
              "repro_torch.configs.hubert_xlarge", "repro_torch.configs.phi_3_vision_4_2b",
              "repro_torch.configs.qwen2_5_32b", "repro_torch.configs.qwen2_72b",
              "repro_torch.configs.mistral_large_123b", "repro_torch.models.moe",
              "repro_torch.models.ssm_lm", "repro_torch.configs.mamba2_2_7b",
              "repro_torch.configs.mixtral_8x7b",
              "repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.core.serving_cache",
              "repro_torch.chaos.injector", "repro_torch.convert")


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


@pytest.mark.parametrize("arch,module", [
    ("mamba2-2.7b", "ssm_lm"), ("mixtral-8x7b", "transformer"),
    ("llama4-scout-17b-a16e", "transformer"),
])
def test_ssm_and_moe_archs_default_to_cuda_and_raise_without_a_card(monkeypatch, arch,
                                                                    module):
    """The attention-free and MoE archs serve on the card by default and
    raise without one; their families are no longer refused."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    assert serve.build_parser().parse_args(["--arch", arch]).device == "cuda"
    cfg = get_smoke_config(arch)
    assert api.family_module(cfg).__name__ == f"repro_torch.models.{module}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke", "--device", "cuda:0"])


@pytest.mark.parametrize("arch", [
    "hubert-xlarge", "chatglm3-6b", "qwen2-72b", "mistral-large-123b", "qwen2.5-32b",
    "phi-3-vision-4.2b",
])
def test_transformer_archs_default_to_cuda_and_raise_without_a_card(monkeypatch, arch):
    """The dense, encoder and vlm archs serve on the card by default and
    raise without one (the encoder too, before it would exit for want of
    a decode step); their families are no longer refused."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api

    assert serve.build_parser().parse_args(["--arch", arch]).device == "cuda"
    cfg = get_smoke_config(arch)
    assert api.family_module(cfg).__name__ == "repro_torch.models.transformer"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke", "--device", "cuda:0"])


def test_warm_start_without_a_card_raises(monkeypatch, tmp_path):
    """``--warm-start`` fails on the missing card before it reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--embedding", "--steps", "2", "--rows", "50", "--dim", "4",
                    "--warm-start", str(tmp_path)])


def test_unknown_arch_and_missing_mode():
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "no-such-model", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])


def _lm_training_message(capsys):
    """LM training of the transformer families is ported (item 18); the
    hybrid's waits for a backward of the SSD kernel (item 20)."""
    with pytest.raises(NotImplementedError) as e:
        train.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu"])
    return str(e.value)


def _supervise_message(capsys):
    """The LM supervisor is ported (item 18); the train step it would
    supervise for the ssm family waits for the SSD backward (item 20)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps

    with pytest.raises(NotImplementedError) as e:
        steps.make_train_step(get_smoke_config("mamba2-2.7b"))
    return str(e.value)


@pytest.mark.parametrize("message,item", [
    (_lm_training_message, 20),  # LM training of the hybrid family
    (_supervise_message, 20),  # the ssm family's supervised train step
], ids=["lm-training", "supervise"])
def test_not_ported_messages_name_their_roadmap_item(capsys, message, item):
    """What is not ported yet says where ROADMAP.md queues it."""
    assert f"ROADMAP.md Queue 1 item {item})" in message(capsys)
