"""The port's dry run (``python -m repro_torch.launch.dryrun``).

  * the CLI at ``--arch chatglm3-6b --shape train_4k --mesh single`` and the
    DLRM cell write their JSON into the directory ``--out`` names: the
    per-device argument bytes by group, the step's flops (> 0), whether
    one device's arguments fit a card, and how each number was obtained
    (``tests/test_torch_dryrun_memory.py`` holds the memory and collectives
    of rank 0's step);
  * the hand-written kernels' wrappers send ``meta`` tensors to their plain
    versions (the dry run's abstract evaluation), and a CUDA tensor still
    never reaches a plain version.
"""
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from repro_torch.kernels import gather_reduce as gr
from repro_torch.kernels import grad_coalesce as gc
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                           "--out", str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=120, cwd=str(tmp_path))


def test_cli_lm_cell_writes_its_json(tmp_path):
    r = _cli(tmp_path, "--arch", "chatglm3-6b", "--shape", "train_4k", "--mesh", "single")
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "chatglm3-6b__train_4k__16x16.json") as f:
        rec = json.load(f)
    assert rec["ok"] and rec["devices"] == 256 and rec["rank"] == 0
    assert rec["method"]["arg_bytes_per_device"].startswith("computed")
    assert "fake process group of 256 ranks" in rec["method"]["memory"]
    b = rec["arg_bytes_per_device"]
    assert set(b) == {"params", "opt", "batch", "total"}
    assert b["total"] == b["params"] + b["opt"] + b["batch"] > 0
    # ZeRO-1: m, v and the fp32 master over 16 data ranks as well as TP 16
    assert b["opt"] < 6 * b["params"]
    assert rec["flops"] > 0 and rec["flops_per_device"] == rec["flops"] / 256
    assert rec["fits_card"] is True
    # the default output stays out of benchmarks/: a git-ignored build dir
    assert dryrun.RESULTS_DIR == os.path.join("build", "dryrun")


def test_cli_dlrm_cell_writes_its_json(tmp_path):
    r = _cli(tmp_path, "--arch", "dlrm-scratchpipe", "--mesh", "both")
    assert r.returncode == 0, r.stderr[-3000:]
    for mesh, devices in (("16x16", 256), ("2x16x16", 512)):
        with open(tmp_path / f"dlrm-scratchpipe__dlrm_train__{mesh}.json") as f:
            rec = json.load(f)
        assert rec["ok"] and rec["devices"] == devices and rec["flops"] > 0
        # 8 x 10M x 128 fp32 tables row-sharded over 16 model ranks
        assert rec["arg_bytes_per_device"]["params"] >= 40_960_000_000 // 16


def test_meta_goes_to_the_plain_versions(monkeypatch):
    called = {"gather": 0, "scatter": 0}
    real_g, real_s = ref.gather_reduce_ref, ref.scatter_add_ref

    def spy_g(*a, **k):
        called["gather"] += 1
        return real_g(*a, **k)

    def spy_s(*a, **k):
        called["scatter"] += 1
        return real_s(*a, **k)

    monkeypatch.setattr(ref, "gather_reduce_ref", spy_g)
    monkeypatch.setattr(ref, "scatter_add_ref", spy_s)
    flops = dryrun.step_flops("dlrm-scratchpipe", "dlrm_train",
                              make_production_mesh(multi_pod=False))
    assert flops > 0 and called == {"gather": 1, "scatter": 1}
    assert ops._route(torch.empty(2, device="meta")) == "cpu"


def test_cuda_tensors_still_never_take_a_plain_version(monkeypatch):
    """A tensor on the card goes to the kernel's launcher; no plain version
    runs (here the launchers are stubs: there is no card)."""
    fake = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float32)
    assert ops._route(fake) == "cuda"
    launched = []
    monkeypatch.setattr(gr, "gather_reduce", lambda s, f: launched.append("gather") or
                        torch.zeros(1))
    monkeypatch.setattr(gc, "scatter_add", lambda s, f, d: launched.append("scatter"))

    def never(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(ref, "gather_reduce_ref", never)
    monkeypatch.setattr(ref, "scatter_add_ref", never)
    ops._gather_call(fake, None)
    ops._scatter_call(fake, None, None)
    assert launched == ["gather", "scatter"]
    with pytest.raises(ValueError):
        ops._route(types.SimpleNamespace(device=torch.device("xla")))


def test_hlo_stats_counts_ops_launches_and_collectives():
    from repro_torch.launch import hlo_stats
    from repro_torch.parallel import collectives

    a = torch.ones(4, 3)
    assert hlo_stats.op_counts(lambda: a @ a.T + 1) == {"aten.permute": 1, "aten.mm": 1,
                                                         "aten.add": 1}
    # the plain versions run on the CPU: no hand-written launch
    assert hlo_stats.kernel_launch_count(ops.gather_reduce, a, torch.zeros(2, 2,
                                         dtype=torch.int32)) == 0
    recs = {"all-reduce": {"count": 2, "bytes_in": 64, "bytes_out": 64},
            "all-gather": {"count": 1, "bytes_in": 8, "bytes_out": 16}}
    stats = hlo_stats.collective_stats(recs)
    assert stats["total"] == {"count": 3, "bytes_in": 72, "bytes_out": 80}
    assert hlo_stats.collective_bytes(recs) == 72
    collectives.reset_collective_records()
    assert hlo_stats.collective_stats() == {"total": {"count": 0, "bytes_in": 0,
                                                      "bytes_out": 0}}
