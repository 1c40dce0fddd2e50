"""The port's quantization (repro_torch.core.quantize) against the JAX package's.

Inputs are made from numpy seeds and handed to both packages:

  * ``requantize_update`` at ``rounding="nearest"`` is BITWISE equal to
    ``repro.core.quantize.requantize_update`` for fp16 and int8 storage:
    untouched rows come back bit-exact, zero rows keep a 1.0 scale,
    saturated rows re-scale, subnormal maxima clamp to the smallest normal
    scale, a subnormal maximum counts as zero (scale 1.0: XLA flushes
    subnormals to zero), fp16 overflow clips to 65504. The port takes the unique touched
    rows and their (U, D) delta where the reference takes a dense delta and
    a mask;
  * ``_snap_scale`` is bitwise equal to the numpy ``_snap_scale_np``;
  * stochastic rounding is unbiased (the reference's Q3 bounds,
    tests/test_quantize.py, with ``torch.Generator``s) and is a function
    of the generator's seed;
  * the numpy half is the reference's, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro_torch.core import quantize as tqz

RNG = np.random.default_rng(21)


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _int8_storage(N, D, rng):
    x = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    data, scale = jqz.quantize_rows_np(x, "int8")
    return data, scale


def _cases(N, D, rng):
    """(delta (N, D) fp32, touched (N,) bool) over the edge cases: some rows
    untouched, a touched row whose update makes it all zero, a saturating
    update, a scale below the normal range, a subnormal row maximum, an
    fp16 overflow (rows 0-4)."""
    delta = (rng.standard_normal((N, D)) * 1e-2).astype(np.float32)
    touched = rng.random(N) < 0.6
    touched[:5] = True
    delta[1] *= 1e4  # saturates: the int8 scale must re-range
    delta[2] = 1e-40  # subnormal maximum: counts as zero
    delta[3] = 1e-37  # absmax / 127 is subnormal: the scale clamps to 2^-126
    delta[4] = 7e4  # beyond the fp16 range: clips to 65504
    delta[~touched] = 0.0
    return delta, touched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_requantize_update_int8_nearest_bitwise(seed):
    rng = np.random.default_rng(seed)
    N, D = 40, 24
    data, scale = _int8_storage(N, D, rng)
    delta, touched = _cases(N, D, rng)
    # row 0 updated to exactly zero: the dequantized row minus itself;
    # rows 2 and 3 start at zero, so the tiny updates set their maxima
    delta[0] = -(data[0].astype(np.float32) * scale[0])
    data[2:4] = 0
    want = jqz.requantize_update(
        jqz.QuantStorage(jnp.asarray(data), jnp.asarray(scale)), jnp.asarray(touched),
        jnp.asarray(delta), "int8", "nearest", jax.random.key(0))
    rows = np.flatnonzero(touched)
    got = tqz.requantize_update(
        tqz.QuantStorage(torch.from_numpy(data.copy()), torch.from_numpy(scale.copy())),
        torch.from_numpy(rows), torch.from_numpy(delta[rows]), "int8", "nearest")
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(want.scale).view(np.uint32))
    for zero_row in (0, 2):
        assert not got.data.numpy()[zero_row].any()
        assert got.scale.numpy()[zero_row, 0] == 1.0
    assert got.scale.numpy()[3, 0] == np.float32(2.0 ** -126)
    assert np.abs(got.data.numpy()[1]).max() == 127
    untouched = ~touched
    np.testing.assert_array_equal(got.data.numpy()[untouched], data[untouched])
    np.testing.assert_array_equal(got.scale.numpy()[untouched], scale[untouched])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_requantize_update_fp16_nearest_bitwise(seed):
    rng = np.random.default_rng(seed)
    N, D = 40, 24
    storage = (rng.standard_normal((N, D)) * 0.1).astype(np.float16)
    delta, touched = _cases(N, D, rng)
    delta[0] = -storage[0].astype(np.float32)
    storage[2:4] = 0
    want = jqz.requantize_update(jnp.asarray(storage), jnp.asarray(touched),
                                 jnp.asarray(delta), "fp16", "nearest", jax.random.key(0))
    rows = np.flatnonzero(touched)
    got = tqz.requantize_update(torch.from_numpy(storage.copy()), torch.from_numpy(rows),
                                torch.from_numpy(delta[rows]), "fp16", "nearest")
    np.testing.assert_array_equal(got.numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))
    assert got.numpy()[4].max() == np.float16(65504.0)
    np.testing.assert_array_equal(got.numpy()[~touched], storage[~touched])


def test_requantize_update_no_rows_is_a_noop():
    data = torch.ones(4, 3, dtype=torch.int8)
    st = tqz.QuantStorage(data, torch.ones(4, 1))
    out = tqz.requantize_update(st, torch.zeros(0, dtype=torch.int64),
                                torch.zeros(0, 3), "int8", "stochastic", _gen(0))
    assert out is st and torch.equal(out.data, torch.ones(4, 3, dtype=torch.int8))


def test_snap_scale_bitwise_against_numpy():
    raw = np.concatenate([
        RNG.standard_normal(500).astype(np.float32) * 10.0 ** RNG.integers(-40, 30, 500),
        np.array([0.0, 1e-45, 1e-39, 2.0 ** -126, 1.0, 3.4e38, 127.0 / 3], np.float32),
    ]).astype(np.float32)
    raw = np.abs(raw)[:, None]
    got = tqz._snap_scale(torch.from_numpy(raw)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), jqz._snap_scale_np(raw).view(np.uint32))
    np.testing.assert_array_equal(
        got.view(np.uint32), np.asarray(jqz._snap_scale_jnp(jnp.asarray(raw))).view(np.uint32))


def test_int8_scale_and_quantize_match_reference():
    x = (RNG.standard_normal((30, 16)) * 10.0 ** RNG.integers(-3, 3, (30, 1))).astype(np.float32)
    x[0] = 0.0
    s = tqz._int8_scale(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jqz._int8_scale(jnp.asarray(x))))
    q = tqz.quantize_int8(torch.from_numpy(x), s, "nearest")
    want = jqz.quantize_int8_jnp(jnp.asarray(x), jnp.asarray(s.numpy()), "nearest",
                                 jax.random.key(0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))
    # half-way values round to even, as jnp.round
    half = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5]])
    np.testing.assert_array_equal(
        tqz.quantize_int8(half, torch.ones(1, 1), "nearest").numpy(),
        np.asarray(jqz.quantize_int8_jnp(jnp.asarray(half.numpy()), jnp.ones((1, 1)),
                                         "nearest", jax.random.key(0))))


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_numpy_half_matches_reference(precision):
    rows = (RNG.standard_normal((50, 12)) * 3).astype(np.float32)
    rows[0] = 0.0
    got, want = tqz.quantize_rows_np(rows, precision), jqz.quantize_rows_np(rows, precision)
    if precision == "int8":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tqz.dequantize_rows_np(got, precision),
                                  jqz.dequantize_rows_np(want, precision))
    assert tqz.row_bytes(12, precision) == jqz.row_bytes(12, precision)
    assert tqz.SLOT_MULTIPLIER == jqz.SLOT_MULTIPLIER and tqz.ROUNDINGS == jqz.ROUNDINGS


def test_int8_stochastic_rounding_is_unbiased():
    # a value 0.3 quantization steps above an integer: nearest always snaps
    # down; stochastic must land 0.3 of the mass up (tests/test_quantize.py)
    scale = torch.full((1, 1), 0.5)
    x = torch.full((1, 64), 0.5 * 10.3)  # y = 10.3 steps
    acc = np.zeros((1, 64), np.float64)
    n = 200
    for i in range(n):
        acc += tqz.quantize_int8(x, scale, "stochastic", _gen(i)).numpy() * 0.5
    mean = acc / n
    assert np.all(np.abs(mean - 0.5 * 10.3) < 0.5 * 0.12), mean.mean()
    np.testing.assert_array_equal(tqz.quantize_int8(x, scale, "nearest").numpy(), 10)


def test_fp16_stochastic_rounding_is_unbiased():
    lo = np.float16(1.0)
    hi = np.nextafter(lo, np.float16(2.0), dtype=np.float16)
    x32 = np.float32(lo) + (np.float32(hi) - np.float32(lo)) * np.float32(0.25)
    x = torch.full((256,), float(x32))
    acc = np.zeros((256,), np.float64)
    n = 200
    for i in range(n):
        acc += tqz.quantize_f16(x, "stochastic", _gen(i)).numpy().astype(np.float64)
    mean = acc / n
    step = float(hi) - float(lo)
    assert abs(mean.mean() - float(x32)) < 0.05 * step
    qn = tqz.quantize_f16(x, "nearest").numpy()
    assert np.all(qn == qn[0]) and qn[0] in (lo, hi)


@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_stochastic_rounding_is_a_function_of_the_seed(precision):
    x = torch.from_numpy(RNG.standard_normal((6, 16)).astype(np.float32))

    def run(seed):
        if precision == "fp16":
            return tqz.quantize_f16(x * 1e-3, "stochastic", _gen(seed))
        return tqz.quantize_int8(x, tqz._int8_scale(x), "stochastic", _gen(seed))

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))


def test_roundings_checked():
    with pytest.raises(ValueError, match="rounding"):
        tqz.check_rounding("up")
    with pytest.raises(ValueError, match="rounding"):
        tqz.quantize_f16(torch.zeros(2), "truncate")
