"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here carries the ``cuda`` marker and skips where no CUDA device
is visible (decided in a fixture, at run time). The file imports neither
JAX nor the JAX package — the plain versions were held against those by
tests/test_torch_kernels.py on the CPU — so it runs on a machine without
JAX. There, skip the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Comparisons are bitwise (``torch.equal``): the kernels do the same fp32 adds
in the same order as the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gather_reduce as tgr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(0)


def _storage(N, D):
    return RNG.standard_normal((N, D)).astype(np.float32)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where none is visible (decided here, at
    run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m cuda")
    tops.reset_launch_counts()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20, 40])
def test_cuda_gather_reduce_bitwise(cuda, D, L):
    N = 500
    st = torch.from_numpy(_storage(N, D)).to(cuda)
    ids = torch.from_numpy(RNG.integers(0, N // 10, (37, L)).astype(np.int32)).to(cuda)
    out = tops.gather_reduce(st, ids)
    want = tref.gather_reduce_ref(st, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert tops.launch_counts()["gather_reduce"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 40, 128, 192])
def test_cuda_fill_bitwise(cuda, D):
    N = 300
    st = torch.from_numpy(_storage(N, D)).to(cuda)
    slots = np.concatenate([RNG.permutation(N)[:100], [N] * 28]).astype(np.int32)
    rows = torch.from_numpy(
        RNG.standard_normal((slots.size, D)).astype(np.float32)
    ).to(cuda)
    slots_t = torch.from_numpy(slots).to(cuda)
    got = tops.fill(st.clone(), slots_t, rows)
    want = tref.fill_ref(st.clone(), slots_t, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tops.launch_counts()["fill"] == 1


@pytest.mark.cuda
def test_cuda_empty_operands_launch_nothing(cuda):
    st = torch.zeros(8, 40, device=cuda)
    assert tops.gather_reduce(st, torch.zeros(0, 5, dtype=torch.int32, device=cuda)).shape == (0, 40)
    tops.fill(st, torch.zeros(0, dtype=torch.int32, device=cuda), torch.zeros(0, 40, device=cuda))
    assert tops.launch_counts() == {"gather_reduce": 0, "fill": 0}


@pytest.mark.cuda
def test_cuda_launchers_check_operands(cuda):
    st = torch.zeros(8, 40, device=cuda)
    with pytest.raises(TypeError):
        tgr.gather_reduce(st, torch.zeros(2, 3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tgr.gather_reduce(st, torch.zeros(3, 2, dtype=torch.int32, device=cuda).t())
    with pytest.raises(ValueError, match="expected"):
        tgr.fill(st, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 40, device=cuda))
