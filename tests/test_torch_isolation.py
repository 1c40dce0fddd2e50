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
              "repro_torch.parallel.collectives", "repro_torch.parallel.sharding",
              "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
              "repro_torch.launch.hlo_stats", "repro_torch.runtime.elastic",
              "repro_torch.runtime.straggler"):
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


def _dry_run_message(capsys):
    """LM training and serving are ported for every family, at one card
    and over a mesh (items 18-23), and so is the dry run of a rank's
    partitioned step, its peak, temp and collectives (item 24): its
    docstring names no item."""
    from repro_torch.launch import dryrun, hlo_stats

    return dryrun.__doc__ + hlo_stats.__doc__


def _supervise_message(capsys):
    """The supervised LM step is ported (items 18 and 20), over a mesh too,
    its ZeRO-1 state split along either stacked dim of a layer list (items
    21 and 22), and so is the cached-embedding LM, trained outside it, over
    a mesh (item 24): its docstring names no item."""
    from repro_torch.core import cached_embedding

    return cached_embedding.__doc__


def _ssd_scan_message(capsys):
    """The reference's ``ssd_scan`` from a given state or in low precision
    (``h0``, ``low_prec``) is not carried over (item 16)."""
    import inspect

    from repro_torch.models import mamba2

    return inspect.getsource(mamba2)


@pytest.mark.parametrize("message,item", [
    (_dry_run_message, None),  # item 24, done: a rank's step measured on meta
    (_supervise_message, None),  # item 24, done: the cached-embedding LM over a mesh
    (_ssd_scan_message, 16),  # not carried over
], ids=["lm-training", "supervise", "ssd-scan"])
def test_not_ported_messages_name_their_roadmap_item(capsys, message, item):
    """What is not ported yet says where ROADMAP.md queues it; a done item
    is named nowhere."""
    text = message(capsys)
    if item is None:
        assert "ROADMAP.md Queue 1 item" not in text
    else:
        assert f"ROADMAP.md Queue 1 item {item}," in text


#: the cached-embedding LM and the examples (ports of ``examples/*.py``)
EXAMPLES = ("repro_torch.examples.lm_cached_embedding", "repro_torch.examples.quickstart",
            "repro_torch.examples.serve_lm", "repro_torch.examples.train_dlrm_scratchpipe")


def test_cached_embedding_and_examples_listed_and_default_to_cuda(monkeypatch):
    """``core/cached_embedding.py`` and the four examples are modules of
    the port (so the import checks above cover them); they run on the card
    by default and raise without one."""
    import importlib

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cached_embedding import CachedEmbeddingLM

    mods = _port_modules()
    for m in ("repro_torch.core.cached_embedding",) + EXAMPLES:
        assert m in mods
    assert inspect.signature(CachedEmbeddingLM.__init__).parameters["device"].default == "cuda"
    lm_example = importlib.import_module(EXAMPLES[0])
    assert lm_example.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CachedEmbeddingLM(get_smoke_config("llama4-scout-17b-a16e"), seed=0)
    for m in EXAMPLES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            importlib.import_module(m).main([])


@pytest.mark.parametrize("module,argv,expect", [
    ("lm_cached_embedding", ["--steps", "8", "--batch", "2", "--seq", "16"], "OK"),
    ("lm_cached_embedding", ["--steps", "8", "--batch", "2", "--seq", "16", "--planner",
                             "device", "--executor", "overlapped"], "OK"),
    ("quickstart", [], "max |scratchpipe - full_table| = 0.00e+00"),
    ("serve_lm", ["--batch", "2", "--prompt-len", "8", "--gen", "3"], "request[1] generated"),
    ("train_dlrm_scratchpipe", ["--steps", "8", "--tables", "1"],
     "max loss diff over first 10 steps = 0.00e+00 (same algorithm)"),
], ids=["lm_cached_embedding", "lm_cached_embedding-device-overlapped", "quickstart",
        "serve_lm", "train_dlrm_scratchpipe"])
def test_examples_run_on_the_cpu(capsys, module, argv, expect):
    """Each example's ``main`` with ``--device cpu`` at a tiny size prints
    its reference's lines (the quickstart keeps its own assertion: the
    cached run equals full-table training; the multi-table DLRM's
    scratchpipe and static runs from the registry give equal losses)."""
    import importlib

    importlib.import_module(f"repro_torch.examples.{module}").main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out
    if module == "lm_cached_embedding":
        assert "plan-hit=" in out and "host traffic" in out and "OK" in out


def test_make_host_mesh_raises_without_a_card_instead_of_choosing_gloo(monkeypatch):
    """``make_host_mesh`` builds an NCCL mesh for the card (its default)
    and raises when no card is visible: it never falls back to gloo, and it
    starts no process group on the way."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert inspect.signature(make_host_mesh).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for shape in ((1, 1), (2, 4)):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make_host_mesh(*shape)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        make_host_mesh(2, 4, device="cpu")  # no group: a mesh > 1 is the caller's
    with pytest.raises(ValueError, match="no process-group backend"):
        make_host_mesh(1, 1, device="xla")
    assert not dist.is_initialized()


def test_lm_mesh_launcher_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    """``train_lm --mesh`` runs on the card by default (NCCL); without a card
    it raises before it starts a process group, instead of taking gloo."""
    import torch.distributed as dist

    args = train.build_parser().parse_args(["--arch", "mixtral-8x7b", "--mesh", "2,4"])
    assert args.device == "cuda" and args.mesh == "2,4"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in ("1,1", "2,4", "2,2,2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "mixtral-8x7b", "--smoke", "--steps", "1", "--mesh", mesh])
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv", [
    ["--arch", "mixtral-8x7b", "--mesh", "2"],
    ["--arch", "mixtral-8x7b", "--mesh", "2,x"],
    ["--arch", "mixtral-8x7b", "--mesh", "0,4"],
    ["--arch", "dlrm-scratchpipe", "--mesh", "1,1"],
], ids=["one-size", "not-a-number", "zero", "dlrm"])
def test_lm_mesh_flag_is_checked(argv):
    with pytest.raises(SystemExit):
        train.main(argv + ["--device", "cpu", "--smoke", "--steps", "1"])


def test_cuda_mesh_never_falls_back_to_gloo(monkeypatch):
    """With a gloo group running, a CUDA mesh (``make_host_mesh`` and the
    launcher's ``lm_mesh``) raises: nothing falls back from NCCL to gloo."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    make_host_mesh(1, 1, device="cpu")
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="runs gloo"):
            make_host_mesh(1, 1, device="cuda")
        with pytest.raises(RuntimeError, match="runs gloo"):
            train.lm_mesh((1, 1), torch.device("cuda", 0))
        with pytest.raises(RuntimeError, match="runs gloo"):
            make_host_mesh(1, 1, device="cuda", pod=1)
    finally:
        dist.destroy_process_group()
