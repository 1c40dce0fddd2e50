"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions; each is held
BITWISE against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode (``repro.kernels.ops`` with ``interpret=True``), over the
sweep of tests/test_kernels.py: duplicates within and across bags, drop
sentinels, empty operands, ragged widths D in {8, 40, 192}. The wrappers'
leading-dim and empty-operand behaviour is checked too, with the launch
counters staying 0 (nothing launches on the CPU).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gather_reduce as tgr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(0)


def _storage(N, D):
    return RNG.standard_normal((N, D)).astype(np.float32)


def _both_gather(st, ids):
    """(port plain version, JAX xla ref, JAX pallas interpret) bags."""
    port = tops.gather_reduce(torch.from_numpy(st), torch.from_numpy(ids)).numpy()
    want_ref = np.asarray(jref.gather_reduce_ref(jnp.asarray(st), jnp.asarray(ids)))
    want_pl = np.asarray(
        jops.gather_reduce(jnp.asarray(st), jnp.asarray(ids), interpret=True)
    )
    return port, want_ref, want_pl


def assert_bitwise(out, want, msg=""):
    out, want = np.asarray(out), np.asarray(want)
    assert out.dtype == want.dtype, (msg, out.dtype, want.dtype)
    assert out.shape == want.shape, (msg, out.shape, want.shape)
    np.testing.assert_array_equal(out, want, err_msg=msg)


@pytest.fixture(autouse=True)
def _fresh_counts():
    tops.reset_launch_counts()
    yield


# ---------------------------------------------------------------------------
# gather_reduce: plain version vs the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [8, 40, 192])
@pytest.mark.parametrize("shape", [(4, 5), (2, 3, 7), (1, 1)])
def test_gather_reduce_matches_reference(D, shape):
    N = 24
    st = _storage(N, D)
    ids = RNG.integers(0, N, shape).astype(np.int32)
    port, want_ref, want_pl = _both_gather(st, ids)
    assert_bitwise(port, want_ref, "vs repro.kernels.ref")
    assert_bitwise(port, want_pl, "vs pallas interpret")
    assert port.shape == shape[:-1] + (D,)


def test_gather_reduce_duplicates_within_and_across_bags():
    st = _storage(16, 40)
    ids = np.array([[3, 3, 3, 5], [5, 3, 5, 3], [0, 0, 0, 0]], np.int32)
    port, want_ref, want_pl = _both_gather(st, ids)
    assert_bitwise(port, want_ref)
    assert_bitwise(port, want_pl)


def test_gather_reduce_sums_in_l_order():
    """The fp32 bag sum is sequential in l, starting from the l=0 row: with
    magnitudes chosen so that reassociation changes the rounding, the port
    still equals the reference bit for bit (and a reassociated sum would
    not)."""
    st = np.array([[1e8], [1.0], [-1e8], [1.0]], np.float32).repeat(8, axis=1)
    ids = np.array([[0, 1, 2, 3], [1, 3, 0, 2]], np.int32)
    port, want_ref, want_pl = _both_gather(st, ids)
    assert_bitwise(port, want_ref)
    assert_bitwise(port, want_pl)
    reassoc = st[ids].astype(np.float64).sum(axis=1).astype(np.float32)
    assert not np.array_equal(port, reassoc)


@pytest.mark.parametrize("shape", [(0, 5), (3, 0), (0, 0), (2, 0, 4)])
def test_gather_reduce_empty_operands(shape):
    st = _storage(8, 40)
    ids = np.zeros(shape, np.int32)
    port, want_ref, _ = _both_gather(st, ids)
    assert_bitwise(port, want_ref)
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def test_gather_reduce_leading_dims_restored():
    st = torch.from_numpy(_storage(30, 8))
    ids = torch.from_numpy(RNG.integers(0, 30, (2, 3, 5, 4)).astype(np.int32))
    out = tops.gather_reduce(st, ids)
    assert out.shape == (2, 3, 5, 8)
    flat = tops.gather_reduce(st, ids.reshape(-1, 4))
    assert torch.equal(out.reshape(-1, 8), flat)
    assert not any(tops.launch_counts().values()), tops.launch_counts()


# ---------------------------------------------------------------------------
# fill: plain version vs the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [8, 40, 192])
def test_fill_drop_mode_sentinel(D):
    """Slots == num_slots are the planner's pad sentinel: dropped."""
    N = 32
    st = _storage(N, D)
    slots = np.array([1, 5, N, 9, N, 2], np.int32)
    rows = RNG.standard_normal((slots.size, D)).astype(np.float32)
    port_st = torch.from_numpy(st.copy())
    out = tops.fill(port_st, torch.from_numpy(slots), torch.from_numpy(rows))
    assert out is port_st  # in place
    want_ref = jref.fill_ref(jnp.asarray(st), jnp.asarray(slots), jnp.asarray(rows))
    want_pl = jops.fill(
        jnp.asarray(st), jnp.asarray(slots), jnp.asarray(rows), interpret=True
    )
    assert_bitwise(port_st.numpy(), want_ref, "vs repro.kernels.ref")
    assert_bitwise(port_st.numpy(), want_pl, "vs pallas interpret")
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def test_fill_empty_operands():
    st = _storage(8, 40)
    port_st = torch.from_numpy(st.copy())
    tops.fill(port_st, torch.zeros(0, dtype=torch.int32), torch.zeros(0, 40))
    assert_bitwise(port_st.numpy(), st)
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def test_fill_rejects_negative_slots():
    st = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="non-negative"):
        tops.fill(st, torch.tensor([1, -1], dtype=torch.int32), torch.ones(2, 8))


def test_fill_ref_unique_valid_slots_precondition():
    """The kernel relies on unique valid slots per call (the planner assigns
    each slot once per plan); with that precondition the plain version's
    result does not depend on write order, so the racing CUDA blocks agree
    with the Pallas kernel's in-order writes."""
    N, D = 40, 8
    st = _storage(N, D)
    slots = np.concatenate([RNG.permutation(N)[:12], [N] * 4]).astype(np.int32)
    valid = slots[slots < N]
    assert np.unique(valid).size == valid.size
    rows = RNG.standard_normal((slots.size, D)).astype(np.float32)
    perm = RNG.permutation(slots.size)
    a = tref.fill_ref(torch.from_numpy(st.copy()), torch.from_numpy(slots),
                      torch.from_numpy(rows))
    b = tref.fill_ref(torch.from_numpy(st.copy()), torch.from_numpy(slots[perm]),
                      torch.from_numpy(rows[perm]))
    assert torch.equal(a, b)


def test_cuda_launchers_refuse_cpu_tensors():
    st = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgr.gather_reduce(st, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tgr.fill(st, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 8))
