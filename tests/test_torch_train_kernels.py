"""The port's training kernels (repro_torch.kernels) against the JAX package's.

On the CPU the port's wrappers run the plain PyTorch versions
(``scatter_add_ref``, ``coalesce_apply_ref``, ``fill_gather_reduce_ref``);
each is held BITWISE against ``repro.kernels.ref`` and against the Pallas
kernels in interpret mode (``repro.kernels.ops`` with ``interpret=True``),
over the sweep of tests/test_kernels.py: duplicates within and across
bags, a slot repeated all through one bag, drop sentinels, fills gathered
in the same call, empty operands, ragged widths D in {8, 40, 192}. The two
``torch.autograd.Function``s (ports of the reference's ``custom_vjp``s)
give gradients bitwise equal to ``jax.grad`` through ``repro.kernels.ops``.
Nothing launches on the CPU (the launch counters stay 0).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import grad_coalesce as tgc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RNG = np.random.default_rng(12)
LR = 0.05


def _f32(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def assert_bitwise(out, want, msg=""):
    out, want = np.asarray(out), np.asarray(want)
    assert out.dtype == want.dtype, (msg, out.dtype, want.dtype)
    assert out.shape == want.shape, (msg, out.shape, want.shape)
    np.testing.assert_array_equal(out, want, err_msg=msg)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    tops.reset_launch_counts()
    yield
    assert not any(tops.launch_counts().values()), tops.launch_counts()


def _dup_ids(shape, N):
    """Ids with heavy duplicates within and across bags (ids < N // 2)."""
    return RNG.integers(0, max(1, N // 2), shape).astype(np.int32)


# ---------------------------------------------------------------------------
# backward: scatter-add / coalesce_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [8, 40, 192])
@pytest.mark.parametrize("shape", [(6, 4), (2, 3, 5), (1, 1), (5, 1)])
def test_coalesce_apply_matches_reference(D, shape):
    N = 12
    st, g = _f32(N, D), _f32(*shape[:-1], D)
    ids = _dup_ids(shape, N)
    port = tops.coalesce_apply(torch.from_numpy(st.copy()), torch.from_numpy(ids),
                               torch.from_numpy(g), LR).numpy()
    want_ref = jref.coalesce_apply_ref(jnp.asarray(st), jnp.asarray(ids), jnp.asarray(g), LR)
    want_pl = jops.coalesce_apply(jnp.asarray(st), jnp.asarray(ids), jnp.asarray(g), LR,
                                  interpret=True)
    assert_bitwise(port, want_ref, "vs repro.kernels.ref")
    assert_bitwise(port, want_pl, "vs pallas interpret")
    plain = tref.coalesce_apply_ref(torch.from_numpy(st.copy()), torch.from_numpy(ids),
                                    torch.from_numpy(g), LR).numpy()
    assert_bitwise(plain, want_ref, "plain version")


def test_scatter_add_duplicate_patterns():
    """A slot repeated all through one bag, the same slot in every bag, and
    magnitudes where the order of the adds changes the rounding: the rows
    must come out as row + d_first + d_next + ... in flat bag-major order."""
    N, D = 10, 40
    st = _f32(N, D)
    ids = np.array([[3, 3, 3, 3], [3, 7, 3, 7], [0, 1, 2, 3], [7, 7, 7, 7]], np.int32)
    deltas = np.stack([np.full(D, v, np.float32) for v in (1e8, 1.0, -1e8, 3.0)])
    deltas += _f32(4, D)
    port = tops.coalesce_deltas(torch.from_numpy(st.copy()), torch.from_numpy(ids),
                                torch.from_numpy(deltas)).numpy()
    want = jref.coalesce_deltas_ref(jnp.asarray(st), jnp.asarray(ids), jnp.asarray(deltas))
    want_pl = jops.coalesce_deltas(jnp.asarray(st), jnp.asarray(ids), jnp.asarray(deltas),
                                   interpret=True)
    assert_bitwise(port, want)
    assert_bitwise(port, want_pl)
    # the explicit left-to-right order, in numpy fp32
    row3 = st[3].copy()
    for b, l in [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 2), (2, 3)]:
        row3 = row3 + deltas[b]
    np.testing.assert_array_equal(port[3], row3)


@pytest.mark.parametrize("D", [8, 40, 192])
def test_scatter_add_ref_random_sweep(D):
    """scatter_add_ref alone (no SGD scaling) against the reference's
    coalescing scatter, at a larger size with every kind of duplicate."""
    N = 64
    for nb, L in ((33, 20), (50, 3), (7, 1)):
        st, deltas = _f32(N, D), _f32(nb, D)
        ids = RNG.integers(0, N, (nb, L)).astype(np.int32)
        port = tref.scatter_add_ref(torch.from_numpy(st.copy()), torch.from_numpy(ids),
                                    torch.from_numpy(deltas)).numpy()
        want = jref.coalesce_deltas_ref(jnp.asarray(st), jnp.asarray(ids), jnp.asarray(deltas))
        assert_bitwise(port, want, f"nb={nb} L={L}")


@pytest.mark.parametrize("shape", [(7, 5), (300, 20), (1, 1)])
def test_sort_by_slot_is_stable(shape):
    """The sort the CUDA backward runs first: keys ascending, and within one
    slot the flat positions in order (numpy's stable argsort)."""
    flat = RNG.integers(0, 9, shape).astype(np.int32)
    keys, perm = tgc.sort_by_slot(torch.from_numpy(flat))
    want = np.argsort(flat.reshape(-1), kind="stable")
    assert keys.dtype == torch.int32 and perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(keys.numpy(), flat.reshape(-1)[want])


def _long_heads_np(keys, n_ids, T):
    """First positions of the runs of one id in [0, n_ids) longer than T."""
    heads, i = [], 0
    while i < keys.size:
        j = i
        while j < keys.size and keys[j] == keys[i]:
            j += 1
        if j - i > T and 0 <= keys[i] < n_ids:
            heads.append(i)
        i = j
    return np.asarray(heads, dtype=np.int64)


@pytest.mark.parametrize("T", [3, tgc.LONG_SEGMENT])
@pytest.mark.parametrize("lens", [(), (64,), (65,), (65, 192, 5, 63, 2000, 1), (3, 4) * 9])
def test_long_segment_heads_matches_numpy(T, lens):
    """The long-segment worklist in torch (which the CUDA backward's first
    launch builds on the card): runs longer than T, ids outside [0, N)
    (-1 and N, each in a run longer than T) never listed."""
    N = 500
    ids = np.concatenate([np.full(n, 7 * i + 3) for i, n in enumerate(lens)]
                         + [np.full(T + 2, -1), np.full(T + 5, N),
                            RNG.integers(0, N, 40)]).astype(np.int32)
    keys, _ = tgc.sort_by_slot(torch.from_numpy(RNG.permutation(ids)).reshape(1, -1))
    got = tgc.long_segment_heads(keys, N, T)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _long_heads_np(keys.numpy(), N, T))


def test_scatter_deltas_rounding_matches_reference():
    st, g = _f32(4, 40), _f32(9, 40) * 1e3
    for lr in (0.05, 3e-4, 1.0 / 3.0):
        port = tref.scatter_deltas(torch.from_numpy(st), torch.from_numpy(g), lr).numpy()
        want = jref.scatter_deltas(jnp.asarray(st), jnp.asarray(g), lr)
        assert_bitwise(port, want, f"lr={lr}")


@pytest.mark.parametrize("shape", [(0, 5), (3, 0), (0, 0), (2, 0, 4)])
def test_backward_empty_operands_are_no_ops(shape):
    st = torch.from_numpy(_f32(8, 40))
    before = st.clone()
    ids = torch.zeros(shape, dtype=torch.int32)
    g = torch.zeros(shape[:-1] + (40,))
    assert tops.coalesce_apply(st, ids, g, LR) is st
    assert tops.coalesce_deltas(st, ids, g) is st
    assert torch.equal(st, before)


# ---------------------------------------------------------------------------
# fused forward: fill_gather_reduce
# ---------------------------------------------------------------------------
def _fill_case(N, F, n_valid, D):
    slots = np.full(F, N, np.int32)  # drop sentinels
    pos = RNG.permutation(F)[:n_valid]
    slots[pos] = RNG.permutation(N)[:n_valid]
    return slots, _f32(F, D)


@pytest.mark.parametrize("D", [8, 40, 192])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_fill_gather_reduce_matches_reference(D, lead):
    N, L = 24, 4
    st = _f32(N, D)
    slots, rows = _fill_case(N, 16, 10, D)
    # half the lookups hit slots filled in this very call
    filled = slots[slots < N]
    ids = np.where(RNG.random(lead + (L,)) < 0.5,
                   RNG.choice(filled, lead + (L,)),
                   RNG.integers(0, N, lead + (L,))).astype(np.int32)
    p_st, p_bags = tops.fill_gather_reduce(
        torch.from_numpy(st.copy()), torch.from_numpy(slots), torch.from_numpy(rows),
        torch.from_numpy(ids))
    w_st, w_bags = jref.fill_gather_reduce_ref(
        jnp.asarray(st), jnp.asarray(slots), jnp.asarray(rows), jnp.asarray(ids))
    pl_st, pl_bags = jops.fill_gather_reduce(
        jnp.asarray(st), jnp.asarray(slots), jnp.asarray(rows), jnp.asarray(ids),
        interpret=True)
    for got, want, pl, what in ((p_st, w_st, pl_st, "storage"), (p_bags, w_bags, pl_bags, "bags")):
        assert_bitwise(got.numpy(), want, f"{what} vs repro.kernels.ref")
        assert_bitwise(got.numpy(), pl, f"{what} vs pallas interpret")
    assert p_bags.shape == lead + (D,)


def test_fill_gather_reduce_degenerate_operands():
    """Nothing to gather: the fill alone; nothing to fill: the gather alone
    (the reference's shape guards); both bitwise equal to the reference."""
    N, D = 20, 40
    st = _f32(N, D)
    slots, rows = _fill_case(N, 8, 5, D)
    ids = RNG.integers(0, N, (3, 4)).astype(np.int32)
    empty_ids = np.zeros((3, 0), np.int32)
    for s, r, i in ((slots, rows, empty_ids),
                    (np.zeros(0, np.int32), np.zeros((0, D), np.float32), ids)):
        p_st, p_bags = tops.fill_gather_reduce(
            torch.from_numpy(st.copy()), torch.from_numpy(s), torch.from_numpy(r),
            torch.from_numpy(i))
        w_st, w_bags = jops.fill_gather_reduce(
            jnp.asarray(st), jnp.asarray(s), jnp.asarray(r), jnp.asarray(i), interpret=True)
        assert_bitwise(p_st.numpy(), w_st)
        assert_bitwise(p_bags.numpy(), w_bags)


def test_fill_gather_reduce_rejects_negative_slots():
    st = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="non-negative"):
        tops.fill_gather_reduce(st, torch.tensor([1, -1], dtype=torch.int32),
                                torch.zeros(2, 4), torch.zeros(2, 3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# gradients: autograd.Function vs jax.grad through repro.kernels.ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [8, 40])
def test_gather_reduce_grad_matches_jax(D):
    N = 16
    st = _f32(N, D)
    ids = _dup_ids((4, 3, 5), N)
    w = _f32(4, 3, D)

    def jloss(s):
        return jnp.sum(jops.gather_reduce(s, jnp.asarray(ids), interpret=True) * jnp.asarray(w))

    want = jax.grad(jloss)(jnp.asarray(st))
    s_t = torch.from_numpy(st.copy()).requires_grad_(True)
    bags = tops.gather_reduce(s_t, torch.from_numpy(ids))
    (got,) = torch.autograd.grad(bags, s_t, grad_outputs=torch.from_numpy(w))
    assert_bitwise(got.numpy(), want)
    # the same cotangent, scattered by the plain backward directly
    zeros = torch.zeros(N, D)
    tref.scatter_add_ref(zeros, torch.from_numpy(ids.reshape(-1, 5)),
                         torch.from_numpy(w.reshape(-1, D)))
    assert_bitwise(got.numpy(), zeros.numpy())


@pytest.mark.parametrize("D", [8, 40])
def test_fill_gather_reduce_grad_matches_jax(D):
    N = 20
    st = _f32(N, D)
    slots, rows = _fill_case(N, 8, 5, D)
    filled = slots[slots < N]
    ids = np.where(RNG.random((6, 4)) < 0.5, RNG.choice(filled, (6, 4)),
                   RNG.integers(0, N, (6, 4))).astype(np.int32)
    w_bags, w_st = _f32(6, D), _f32(N, D)

    def jloss(s, r):
        st2, bags = jops.fill_gather_reduce(s, jnp.asarray(slots), r, jnp.asarray(ids),
                                            interpret=True)
        return jnp.sum(bags * jnp.asarray(w_bags)) + jnp.sum(st2 * jnp.asarray(w_st))

    want_s, want_r = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(st), jnp.asarray(rows))
    s_t = torch.from_numpy(st.copy()).requires_grad_(True)
    r_t = torch.from_numpy(rows.copy()).requires_grad_(True)
    st2, bags = tops.fill_gather_reduce(s_t, torch.from_numpy(slots), r_t,
                                        torch.from_numpy(ids))
    got_s, got_r = torch.autograd.grad(
        [bags, st2], [s_t, r_t],
        grad_outputs=[torch.from_numpy(w_bags), torch.from_numpy(w_st)])
    assert_bitwise(got_s.numpy(), want_s, "d storage")
    assert_bitwise(got_r.numpy(), want_r, "d fill_rows")
    # the autograd path is functional: the input storage is untouched
    assert_bitwise(s_t.detach().numpy(), st)
