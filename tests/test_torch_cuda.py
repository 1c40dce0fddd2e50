"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here carries the ``cuda`` marker and skips where no CUDA device
is visible (decided in a fixture, at run time). The file imports neither
JAX nor the JAX package — the plain versions were held against those by
tests/test_torch_kernels.py on the CPU — so it runs on a machine without
JAX. There, skip the repository's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Comparisons are bitwise (``torch.equal``): the kernels do the same fp32 adds
in the same order as the plain versions — the backward ``scatter_add`` too
(its duplicates in flat bag-major order, with no float atomics, in both its
short- and long-segment classes), and the fused
``fill_gather_reduce`` gathers the rows it has just filled. The fp16 and
int8 forms (``gather_reduce_q``, ``fill_gather_reduce_q``, the byte-copy
``fill``) are held the same way: the int8 dequant product is exact.

The LM kernels ``flash_attention`` (bf16 on the tensor cores, fp32 on
FMAs) and ``ssd_chunk_scan`` (bf16 ``x`` on the tensor cores, fp32 on FMAs) sum in
another order than their plain versions, so they are held to the reference's own
tolerances (tests/test_kernels.py): flash atol 2e-5 at fp32 and 3e-2 at
bf16 (compared in fp32), SSD atol 2e-4 at fp32. SSD with bf16 ``x`` rounds
its output to bf16, whose step is 2^-8 relative: there |kernel - plain|
<= 3e-2 + 1e-2 |plain| (two bf16 steps plus flash's bf16 bound); its fp32
state keeps atol 2e-4.

The device planner's ``plan_step`` (plain torch, no kernel of its own) is
held equal to its CPU run on every output and on the new state (the dummy
elements that take padded writes aside), and must run with no host sync
under ``torch.cuda.set_sync_debug_mode("error")``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import plan_device as tpd
from repro_torch.core import quantize as tqz
from repro_torch.core import scratchpad as tsp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gather_reduce as tgr
from repro_torch.kernels import grad_coalesce as tgc
from repro_torch.kernels import ssd_chunk as tssd
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
    tops.coalesce_apply(st, torch.zeros(0, 5, dtype=torch.int32, device=cuda),
                        torch.zeros(0, 40, device=cuda), 0.1)
    tops.fill_gather_reduce(st, torch.zeros(0, dtype=torch.int32, device=cuda),
                            torch.zeros(0, 40, device=cuda),
                            torch.zeros(3, 0, dtype=torch.int32, device=cuda))
    assert not any(tops.launch_counts().values()), tops.launch_counts()


@pytest.mark.cuda
def test_cuda_launchers_check_operands(cuda):
    st = torch.zeros(8, 40, device=cuda)
    with pytest.raises(TypeError):
        tgr.gather_reduce(st, torch.zeros(2, 3, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tgr.gather_reduce(st, torch.zeros(3, 2, dtype=torch.int32, device=cuda).t())
    with pytest.raises(ValueError, match="expected"):
        tgr.fill(st, torch.zeros(2, dtype=torch.int32), torch.zeros(2, 40, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20])
@pytest.mark.parametrize("id_hi", [8, 64, 500])
def test_cuda_scatter_add_bitwise(cuda, D, L, id_hi):
    """Heavy duplicates within and across bags (small id_hi) down to few."""
    N, nb = 500, 97
    st = torch.from_numpy(_storage(N, D)).to(cuda)
    ids = torch.from_numpy(RNG.integers(0, id_hi, (nb, L)).astype(np.int32)).to(cuda)
    deltas = torch.from_numpy(RNG.standard_normal((nb, D)).astype(np.float32)).to(cuda)
    got = tops.coalesce_deltas(st.clone(), ids, deltas)
    want = tref.scatter_add_ref(st.clone(), ids, deltas)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tops.launch_counts()["scatter_add"] == 1


@pytest.mark.cuda
def test_cuda_scatter_add_long_segments(cuda):
    """One row looked up by every lookup of every bag (a 4000-long segment)
    and a slot repeated all through one bag: order matters at these
    magnitudes, so any reordering shows."""
    N, D, nb, L = 64, 128, 200, 20
    st = torch.from_numpy(_storage(N, D)).to(cuda)
    ids = torch.full((nb, L), 7, dtype=torch.int32)
    ids[1] = 3
    deltas = torch.from_numpy(
        (RNG.standard_normal((nb, D)) * 10.0 ** RNG.integers(-4, 8, (nb, 1))).astype(np.float32))
    got = tops.coalesce_apply(st.clone(), ids.to(cuda), deltas.to(cuda), 0.05)
    want = tref.coalesce_apply_ref(st.clone(), ids.to(cuda), deltas.to(cuda), 0.05)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _scatter_vs_plain(cuda, N, D, ids, scale=1e3):
    """coalesce_deltas on the card against scatter_add_ref, bitwise. ids may
    hold N, which the kernel drops: the plain version (ids in [0, N) only)
    adds those to a row N past the kernel's storage."""
    st = torch.from_numpy(_storage(N + 1, D)).to(cuda)
    deltas = torch.from_numpy(
        (RNG.standard_normal((ids.shape[0], D)) * scale).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(ids).to(cuda)
    got = tops.coalesce_deltas(st[:N].clone(), ids, deltas)
    want = tref.scatter_add_ref(st.clone(), ids, deltas)[:N]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _segments(lens, N, extra=0):
    """Runs of one id per length in ``lens`` (ids 7 i + 3), ``extra`` ids ==
    N, shuffled, in bags of 4 (padded with ids == N)."""
    ids = np.concatenate([np.full(n, 7 * i + 3) for i, n in enumerate(lens)] + [[N] * extra])
    ids = RNG.permutation(ids)
    ids = np.concatenate([ids, np.full((-ids.size) % 4, N)])
    return ids.astype(np.int32).reshape(-1, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 40, 128, 192])
@pytest.mark.parametrize("case", ["T-1", "T", "T+1", "several long", "id N"])
def test_cuda_scatter_add_segment_classes(cuda, D, case):
    """Segments just under, at and over the long-segment threshold T, several
    long segments in one launch, and ids == N (dropped), bitwise."""
    T = tgc.LONG_SEGMENT
    lens = {"T-1": (T - 1,), "T": (T,), "T+1": (T + 1,),
            "several long": (T + 1, 3 * T, 5, T - 1, 2000, 1, 700),
            "id N": (T + 1, 2, 9)}[case]
    _scatter_vs_plain(cuda, 4096, D, _segments(lens, 4096, extra=5 if case == "id N" else 0))
    assert tops.launch_counts()["scatter_add"] == 1


@pytest.mark.cuda
def test_cuda_scatter_add_hot_row_among_short(cuda):
    """One row looked up 4,000 times among 10^5 lookups of mostly distinct
    rows, bitwise."""
    N = 1_000_000
    ids = RNG.integers(0, N, 100_000)
    ids[RNG.permutation(100_000)[:4000]] = 17
    _scatter_vs_plain(cuda, N, 128, ids.astype(np.int32).reshape(-1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [(), (65,), (65, 200, 64, 3000), (1000,) * 7])
def test_cuda_scatter_add_worklist(cuda, lens):
    """The long-segment heads the first launch lists on the card are
    long_segment_heads' (as a set)."""
    N = 4096
    flat = torch.from_numpy(_segments(lens + (30, 1, 64), N, extra=100)).to(cuda)
    keys, perm = tgc.sort_by_slot(flat)
    st = torch.zeros(N, 8, device=cuda)
    work = tgc.scatter_add_sorted(st, keys, perm, torch.zeros(flat.shape[0], 8, device=cuda),
                                  flat.shape[1])
    torch.cuda.synchronize()
    n = int(work[0])
    assert n == sum(1 for x in lens if x > tgc.LONG_SEGMENT)
    assert torch.equal(torch.sort(work[2:2 + n]).values, tgc.long_segment_heads(keys, N))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 40, 128, 192])
@pytest.mark.parametrize("L", [1, 3, 20])
def test_cuda_fill_gather_reduce_bitwise(cuda, D, L):
    """Sentinels in the fill, and lookups of the slots filled in the call."""
    N, F, nb = 600, 256, 113
    st = torch.from_numpy(_storage(N, D)).to(cuda)
    slots = np.full(F, N, np.int32)
    slots[RNG.permutation(F)[:200]] = RNG.permutation(N)[:200]
    filled = slots[slots < N]
    ids = np.where(RNG.random((nb, L)) < 0.5, RNG.choice(filled, (nb, L)),
                   RNG.integers(0, N, (nb, L))).astype(np.int32)
    rows = torch.from_numpy(RNG.standard_normal((F, D)).astype(np.float32)).to(cuda)
    slots_t, ids_t = torch.from_numpy(slots).to(cuda), torch.from_numpy(ids).to(cuda)
    got_st, got = tops.fill_gather_reduce(st.clone(), slots_t, rows, ids_t)
    want_st, want = tref.fill_gather_reduce_ref(st.clone(), slots_t, rows, ids_t)
    torch.cuda.synchronize()
    assert torch.equal(got_st, want_st)
    assert torch.equal(got, want)
    assert tops.launch_counts()["fill_gather_reduce"] == 1
    assert tops.launch_counts()["fill"] == tops.launch_counts()["gather_reduce"] == 0


@pytest.mark.cuda
def test_cuda_fill_gather_reduce_grid_stride(cuda):
    """More fill rows and bags than the persistent grid has warps."""
    N, D, F, nb, L = 300_000, 128, 131_072, 40_000, 3
    g = torch.Generator(device="cpu").manual_seed(3)
    st = torch.randn(N, D, generator=g).to(cuda)
    slots = torch.randperm(N, generator=g)[:F].to(torch.int32)
    rows = torch.randn(F, D, generator=g).to(cuda)
    ids = slots[torch.randint(0, F, (nb, L), generator=g)].to(cuda)
    slots = slots.to(cuda)
    got_st, got = tops.fill_gather_reduce(st.clone(), slots, rows, ids)
    want_st, want = tref.fill_gather_reduce_ref(st.clone(), slots, rows, ids)
    torch.cuda.synchronize()
    assert torch.equal(got_st, want_st) and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_training_launchers_check_operands(cuda):
    st = torch.zeros(8, 40, device=cuda)
    ids = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tgc.scatter_add(st, ids, torch.zeros(2, 40, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="describe"):
        tgc.scatter_add(st, ids, torch.zeros(3, 40, device=cuda))
    with pytest.raises(ValueError, match="rows"):
        tgr.fill_gather_reduce(st, torch.zeros(2, dtype=torch.int32, device=cuda),
                               torch.zeros(3, 40, device=cuda), ids)


# ---------------------------------------------------------------------------
# reduced precision: the fp16/int8 forms and the dequantizing kernels
# ---------------------------------------------------------------------------
def _quantized(precision, N, D):
    """(payload, scale or None) quantized as the host [Collect] does."""
    rows = (RNG.standard_normal((N, D)) * 10.0 ** RNG.integers(-2, 1, (N, 1))).astype(
        np.float32)
    rows[1] = 0.0
    q = tqz.quantize_rows_np(rows, precision)
    if precision == "int8":
        return torch.from_numpy(q[0]), torch.from_numpy(q[1])
    return torch.from_numpy(q), None


_Q_KEYS = {"fp16": ("gather_reduce_f16", "fill_f16", "fill_gather_reduce_f16"),
           "int8": ("gather_reduce_q", "fill_i8", "fill_gather_reduce_q")}


def _offset_view(t, offset):
    """A contiguous copy of ``t`` whose data starts ``offset`` bytes past a
    64-byte-aligned address (offset 4: aligned to 4 bytes, not to 16)."""
    n_bytes = t.numel() * t.element_size()
    buf = torch.empty(n_bytes + 64, dtype=torch.uint8, device=t.device)
    base = (-buf.data_ptr()) % 64 + offset
    view = buf[base:base + n_bytes].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("D", [8, 40, 128, 192, 256, 1024])
@pytest.mark.parametrize("L", [1, 3, 20, 33, 40, 64])
def test_cuda_gather_reduce_q_bitwise(cuda, precision, D, L, offset):
    """Rows of one and of several warp loads, one and several 32-lookup
    groups, one slot all through a bag, and (offset 4) a payload 4 but not
    16 bytes aligned, which keeps the int8 gather off the whole-bag path."""
    N = 500
    data, scale = _quantized(precision, N, D)
    data = _offset_view(data.to(cuda), offset)
    scale = None if scale is None else scale.to(cuda)
    ids = RNG.integers(0, N // 10, (37, L)).astype(np.int32)
    ids[0] = 7
    ids = torch.from_numpy(ids).to(cuda)
    out = tops.gather_reduce_q(data, scale, ids)
    want = tref.gather_reduce_q_ref(data, scale, ids)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.equal(out, want)
    assert tops.launch_counts()[_Q_KEYS[precision][0]] == 1
    if precision == "fp16":  # the fp16 form of the plain gather casts back
        assert torch.equal(tops.gather_reduce(data, ids), tref.gather_reduce_ref(data, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("D", [8, 40, 128, 192, 256, 1024, 3])
def test_cuda_fill_reduced_precision_bitwise(cuda, precision, D):
    """The byte-copy fill at every chunk width (D=3 int8: 1-byte chunks),
    rows narrower than a warp load (several per warp, the last group
    ragged) and wider."""
    N = 300
    st = _quantized(precision, N, D)[0].to(cuda)
    slots = np.concatenate([RNG.permutation(N)[:100], [N] * 29]).astype(np.int32)
    rows = _quantized(precision, slots.size, D)[0].to(cuda)
    slots_t = torch.from_numpy(slots).to(cuda)
    got = tops.fill(st.clone(), slots_t, rows)
    want = tref.fill_ref(st.clone(), slots_t, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert tops.launch_counts()[_Q_KEYS[precision][1]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("D", [8, 40, 128, 192, 256, 1024])
@pytest.mark.parametrize("L", [1, 3, 20, 33, 64])
@pytest.mark.parametrize("n_valid", [200, 0])
def test_cuda_fill_gather_reduce_q_bitwise(cuda, precision, D, L, n_valid):
    """Sentinels in the fill (n_valid 0: every fill a sentinel), and lookups
    of the slots filled in the call; the int8 scale column holds the fill
    rows' scales before the launch."""
    N, F, nb = 600, 256, 113
    data, scale = _quantized(precision, N, D)
    slots = np.full(F, N, np.int32)
    slots[RNG.permutation(F)[:n_valid]] = RNG.permutation(N)[:n_valid]
    filled = slots[slots < N]
    ids = RNG.integers(0, N, (nb, L))
    if n_valid:
        ids = np.where(RNG.random((nb, L)) < 0.5, RNG.choice(filled, (nb, L)), ids)
    ids = ids.astype(np.int32)
    rows, rows_scale = _quantized(precision, F, D)
    if scale is not None:
        keep = torch.from_numpy(slots < N)
        scale[torch.from_numpy(slots)[keep].long()] = rows_scale[keep]
        scale = scale.to(cuda)
    data, rows = data.to(cuda), rows.to(cuda)
    slots_t, ids_t = torch.from_numpy(slots).to(cuda), torch.from_numpy(ids).to(cuda)
    got_st, got = tops.fill_gather_reduce_q(data.clone(), scale, slots_t, rows, ids_t)
    want_st, want = tref.fill_gather_reduce_q_ref(data.clone(), scale, slots_t, rows, ids_t)
    torch.cuda.synchronize()
    assert torch.equal(got_st, want_st)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    counts = tops.launch_counts()
    assert counts[_Q_KEYS[precision][2]] == 1
    assert counts[_Q_KEYS[precision][0]] == counts[_Q_KEYS[precision][1]] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "int8"])
@pytest.mark.parametrize("D, L", [(128, 3), (128, 33), (1024, 3)])
def test_cuda_quantized_grid_stride(cuda, precision, D, L):
    """More fill rows and bags than the persistent grid has warps, at the
    training width, past one 32-lookup group, and at rows of 8 warp loads."""
    N, F, nb = 300_000, 131_072, 40_000
    data, scale = _quantized(precision, N, D)
    g = torch.Generator(device="cpu").manual_seed(3)
    slots = torch.randperm(N, generator=g)[:F].to(torch.int32)
    rows, rows_scale = _quantized(precision, F, D)
    if scale is not None:
        scale[slots.long()] = rows_scale
        scale = scale.to(cuda)
    ids = slots[torch.randint(0, F, (nb, L), generator=g)].to(cuda)
    data, rows, slots = data.to(cuda), rows.to(cuda), slots.to(cuda)
    got_st, got = tops.fill_gather_reduce_q(data.clone(), scale, slots, rows, ids)
    want_st, want = tref.fill_gather_reduce_q_ref(data.clone(), scale, slots, rows, ids)
    torch.cuda.synchronize()
    assert torch.equal(got_st, want_st) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_cuda_apply_grad_q_matches_cpu(cuda, precision):
    """The quantized backward on the card (scatter kernel + torch epilogue)
    at nearest rounding equals the CPU run of the same code."""
    N, D, nb, L = 400, 40, 64, 5
    st = tsp.make_storage(N, D, precision=precision, device="cpu")
    rows = RNG.standard_normal((N, D)).astype(np.float32) * 0.1
    tsp.fill(st, torch.arange(N, dtype=torch.int32),
             tuple(torch.from_numpy(a) for a in tqz.quantize_rows_np(rows, precision))
             if precision == "int8" else torch.from_numpy(tqz.quantize_rows_np(rows, precision)))
    ids = torch.from_numpy(RNG.integers(0, N // 4, (nb, L)).astype(np.int32))
    g = torch.from_numpy(RNG.standard_normal((nb, D)).astype(np.float32))
    on_card = tqz.QuantStorage(*(t.to(cuda) for t in st)) if precision == "int8" else st.to(cuda)
    tsp.apply_grad_q(on_card, ids.to(cuda), g.to(cuda), 0.05, rounding="nearest")
    tsp.apply_grad_q(st, ids, g, 0.05, rounding="nearest")
    torch.cuda.synchronize()
    for a, b in zip(*((x,) if precision == "fp16" else x for x in (on_card, st))):
        assert torch.equal(a.cpu(), b)
    assert tops.launch_counts()["scatter_add"] == 1


@pytest.mark.cuda
def test_cuda_quantized_launchers_check_operands(cuda):
    data = torch.zeros(8, 40, dtype=torch.int8, device=cuda)
    ids = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        tgr.gather_reduce_q(data, torch.ones(7, 1, device=cuda), ids)
    with pytest.raises(TypeError):
        tgr.gather_reduce_q(data, torch.ones(8, 1, dtype=torch.float16, device=cuda), ids)
    with pytest.raises(TypeError):
        tgr.gather_reduce(data, ids)  # int8 needs its scale: gather_reduce_q
    with pytest.raises(TypeError):
        tgr.fill(torch.zeros(8, 40, dtype=torch.float16, device=cuda),
                 torch.zeros(2, dtype=torch.int32, device=cuda),
                 torch.zeros(2, 40, device=cuda))


# --------------------------------------------------------------------------- #
# LM kernels: flash_attention and ssd_chunk_scan (held to tolerances)
# --------------------------------------------------------------------------- #
_BF16_ATOL, _BF16_RTOL = 3e-2, 1e-2
# flash is also held in the Frobenius norm relative to the plain output's
# size: a bf16 row averaging over hundreds of keys is not much larger than
# the atol (a correct bf16 kernel reads a few 1e-3)
_FLASH_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_flash_close(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    atol = 2e-5 if dtype == torch.float32 else _BF16_ATOL
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.float())).item()
    assert err <= atol and rel <= _FLASH_REL[dtype], (err, rel)


def _lm_tensor(shape, dtype, cuda, lo=None, hi=None):
    a = (RNG.standard_normal(shape) if lo is None else RNG.uniform(lo, hi, shape))
    return torch.from_numpy(a.astype(np.float32)).to(cuda).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window",
    [
        (2, 128, 128, 8, 2, 64, True, None),  # GQA
        (2, 160, 160, 4, 1, 32, True, None),  # MQA, ragged
        (2, 256, 256, 8, 2, 64, True, 64),  # causal + window
        (1, 300, 300, 4, 4, 64, False, 100),  # non-causal window
        (2, 200, 200, 4, 4, 64, False, None),  # non-causal, ragged Skv > block
        (2, 70, 300, 4, 2, 64, False, None),  # Sq != Skv, neither a block multiple
        (1, 100, 100, 4, 4, 128, True, None),  # hd 128, Sq not a block multiple
        (2, 96, 96, 2, 2, 16, False, None),
        (1, 512, 512, 32, 32, 64, True, None),  # the zamba2 head layout
    ],
)
def test_cuda_flash_attention_vs_plain(cuda, dtype, B, Sq, Skv, H, K, hd, causal, window):
    q = _lm_tensor((B, Sq, H, hd), dtype, cuda)
    k = _lm_tensor((B, Skv, K, hd), dtype, cuda)
    v = _lm_tensor((B, Skv, K, hd), dtype, cuda)
    got = tops.flash_attention(q, k, v, causal, window)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, dtype)
    assert tops.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window",
    [
        (2, 127, 127, 8, 2, 64, True, None),  # around the 128-row q tile
        (2, 129, 129, 8, 2, 64, True, None),
        (1, 255, 255, 8, 2, 64, True, None),
        (1, 257, 257, 8, 2, 64, True, None),
        (2, 257, 257, 8, 2, 64, True, 100),  # the window crosses 64-key blocks
        (1, 257, 257, 8, 2, 64, False, 70),
        (2, 300, 70, 8, 2, 64, True, None),  # Sq != Skv
        (1, 129, 257, 8, 2, 64, False, None),
        (2, 200, 200, 8, 2, 16, True, None),  # hd padded to 32, 64, 128
        (2, 200, 200, 8, 2, 32, False, None),
        (2, 200, 200, 8, 2, 48, True, 64),
        (1, 257, 257, 8, 2, 128, True, None),
        (1, 100, 100, 4, 4, 20, True, None),  # rows not 16-byte multiples
    ],
)
def test_cuda_flash_attention_tile_edges(cuda, dtype, B, Sq, Skv, H, K, hd, causal, window):
    """The edges of the bf16 tensor-core kernel's tiles (and the fp32
    kernel's at the same shapes), GQA H/K = 4, against the plain version."""
    q = _lm_tensor((B, Sq, H, hd), dtype, cuda)
    k = _lm_tensor((B, Skv, K, hd), dtype, cuda)
    v = _lm_tensor((B, Skv, K, hd), dtype, cuda)
    got = tops.flash_attention(q, k, v, causal, window)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, dtype)
    assert tops.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window,q_offset",
    [
        # the dense, encoder and vlm configs' head layouts: hd 80 and 96 are
        # zero-padded to 128 inside the kernel; GQA ratios 16, 5, 8 and 12
        (1, 300, 300, 32, 2, 128, True, None, 0),  # chatglm3-6b
        (1, 300, 300, 16, 16, 80, False, None, 0),  # hubert-xlarge, non-causal
        (1, 333, 333, 8, 8, 80, True, None, 0),
        (1, 300, 300, 8, 8, 96, True, None, 0),  # phi-3-vision (MHA)
        (1, 200, 200, 4, 4, 96, False, None, 0),
        (1, 300, 300, 40, 8, 128, True, None, 0),  # qwen2.5-32b, GQA 5
        (1, 300, 300, 64, 8, 128, True, None, 0),  # qwen2-72b, GQA 8
        (1, 300, 300, 96, 8, 128, True, None, 0),  # mistral-large, GQA 12
        (2, 257, 257, 10, 2, 128, False, None, 0),  # GQA 5, non-causal
        (2, 257, 257, 24, 2, 80, True, 100, 0),  # GQA 12, window
        # q_offset: a query chunk after a prefix of keys
        (2, 100, 300, 8, 2, 64, True, None, 200),
        (1, 129, 400, 12, 4, 96, True, 150, 271),
        (1, 70, 200, 16, 16, 80, False, None, 130),
        # mixtral-8x7b's layout (32/8 x 128) with a window that cuts, and
        # with a window after a prefix of keys
        (1, 700, 700, 32, 8, 128, True, 256, 0),
        (1, 300, 500, 32, 8, 128, True, 128, 200),
    ],
)
def test_cuda_flash_attention_lm_head_layouts(cuda, dtype, B, Sq, Skv, H, K, hd, causal,
                                              window, q_offset):
    """flash_attention at the transformer configs' head dims and GQA ratios,
    causal and not, and with q_offset, against the plain version."""
    rng = np.random.default_rng(hd * 1000 + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               .to(dtype) for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    got = tops.flash_attention(q, k, v, causal, window, q_offset)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    torch.cuda.synchronize()
    _assert_flash_close(got, want, dtype)
    assert tops.launch_counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,S,ng,hpg,hd,ds,Q",
    [
        (2, 32, 1, 4, 8, 16, 8),  # the reference's sweep (tests/test_kernels.py)
        (1, 64, 2, 3, 16, 8, 16),
        (1, 40, 1, 2, 8, 8, 16),
        (2, 300, 1, 4, 64, 64, 64),  # S not a multiple of Q
        (1, 600, 2, 2, 64, 128, 256),
        (2, 512, 1, 4, 64, 64, 256),  # the zamba2 widths per head
        (1, 130, 2, 2, 128, 128, 64),
        # the tensor-core kernel's edges: head dims not a multiple of its
        # 64-dim slab (20: rows not 16-byte multiples), ds padded to 16 /
        # 128, S below, at and one past the chunk at Q = 64, 128, 256 (one
        # chunk: nc = 1), several heads reading one G, 16 chunks of state
        (1, 200, 1, 2, 16, 64, 64), (1, 200, 1, 2, 20, 64, 64),
        (1, 200, 1, 2, 48, 64, 64), (1, 200, 1, 2, 96, 64, 64),
        (1, 300, 1, 2, 64, 16, 128), (1, 300, 1, 2, 64, 128, 128),
        (1, 50, 1, 2, 64, 64, 64), (1, 64, 1, 2, 64, 64, 64), (1, 65, 1, 2, 64, 64, 64),
        (1, 100, 1, 2, 64, 64, 128), (1, 128, 1, 2, 64, 64, 128),
        (1, 129, 1, 2, 64, 64, 128),
        (1, 200, 1, 2, 64, 64, 256), (2, 256, 1, 4, 64, 64, 256),
        (1, 257, 1, 2, 64, 64, 256),
        (2, 700, 2, 8, 64, 64, 256),  # ng = 2, hpg = 8
        (1, 4096, 1, 4, 64, 64, 256),  # the state after 16 chunks
        # mamba2-2.7b's per-head widths (hd 64, ds 128, ng 1, Q 256), more
        # heads per group, a ragged last chunk
        (1, 1024, 1, 16, 64, 128, 256), (2, 600, 1, 8, 64, 128, 256),
    ],
)
def test_cuda_ssd_chunk_scan_vs_plain(cuda, dtype, B, S, ng, hpg, hd, ds, Q):
    nh = ng * hpg
    x = _lm_tensor((B, S, nh, hd), dtype, cuda)
    dt = _lm_tensor((B, S, nh), torch.float32, cuda, 0.05, 1.0)
    A = -_lm_tensor((nh,), torch.float32, cuda, 0.3, 4.0)
    Bm = _lm_tensor((B, S, ng, ds), torch.float32, cuda)
    Cm = _lm_tensor((B, S, ng, ds), torch.float32, cuda)
    y, h = tops.ssd_chunk_scan(x, dt, A, Bm, Cm, Q)
    y_ref, h_ref = tref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, Q)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape and h.shape == (B, nh, hd, ds)
    dy = (y.float() - y_ref.float()).abs()
    if dtype == torch.float32:
        assert dy.max().item() <= 2e-4, dy.max().item()
    else:
        assert bool((dy <= _BF16_ATOL + _BF16_RTOL * y_ref.float().abs()).all()), (
            dy.max().item())
    assert (h - h_ref).abs().max().item() <= 2e-4
    assert tops.launch_counts()["ssd_chunk_scan"] == 1


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt", [("mamba2-2.7b", 40), ("mixtral-8x7b", 96),
                                         ("llama4-scout-17b-a16e", 24)])
def test_cuda_lm_serve_ssm_and_moe_match_cpu(cuda, monkeypatch, arch, prompt):
    """The smoke configs (fp32) served through the launcher on the card
    (the kernels) and on the CPU (the plain versions) from the same params:
    16 greedy tokens equal, logits within 1e-3 of the largest; one kernel
    launch per layer per prefill (the SSD scan for mamba2, flash for the
    MoE configs; mixtral's 96-token prompt cuts its 64-key window and its
    decode wraps the ring), none in decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import api

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_smoke_config(arch)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(api, "init", lambda c, g, device=None: _to(params, device))
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", str(prompt),
            "--gen", "16"]
    got = serve.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    kernel = "ssd_chunk_scan" if cfg.family == "ssm" else "flash_attention"
    counts = tops.launch_counts()
    assert counts[kernel] == cfg.num_layers and sum(counts.values()) == cfg.num_layers
    want = serve.main(argv + ["--device", "cpu"])
    assert got["logits"].device.type == "cuda"
    diff = (got["logits"].cpu() - want["logits"]).abs().max().item()
    assert diff <= 1e-3 * want["logits"].abs().max().item(), diff
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.cuda
def test_cuda_lm_empty_operands_launch_nothing(cuda):
    q = torch.zeros(2, 0, 4, 16, device=cuda)
    k = torch.zeros(2, 5, 4, 16, device=cuda)
    assert tops.flash_attention(q, k, k).shape == q.shape
    out = tops.flash_attention(k, q, q)  # no keys: every row masked
    assert out.shape == k.shape and not out.any()
    x = torch.zeros(2, 0, 4, 8, device=cuda)
    y, h = tops.ssd_chunk_scan(x, torch.zeros(2, 0, 4, device=cuda),
                               -torch.ones(4, device=cuda),
                               torch.zeros(2, 0, 1, 16, device=cuda),
                               torch.zeros(2, 0, 1, 16, device=cuda), 8)
    assert y.shape == x.shape and h.shape == (2, 4, 8, 16) and not h.any()
    assert not any(tops.launch_counts().values()), tops.launch_counts()


@pytest.mark.cuda
def test_cuda_lm_launchers_check_operands(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q.bfloat16(), q, True, None)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2), q, q, True, None)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 8, 1, 192, device=cuda)
        tfa.flash_attention(big, big, big, True, None)
    with pytest.raises(ValueError, match="pair"):
        tfa.flash_attention(q, torch.zeros(1, 8, 3, 16, device=cuda),
                            torch.zeros(1, 8, 3, 16, device=cuda), True, None)
    x = torch.zeros(1, 8, 2, 16, device=cuda)
    dt, A = torch.zeros(1, 8, 2, device=cuda), torch.zeros(2, device=cuda)
    bc = torch.zeros(1, 8, 1, 16, device=cuda)
    with pytest.raises(TypeError):
        tssd.ssd_chunk_scan(x, dt.double(), A, bc, bc, 4)
    with pytest.raises(ValueError, match="pair"):
        tssd.ssd_chunk_scan(x, dt, torch.zeros(3, device=cuda), bc, bc, 4)
    with pytest.raises(ValueError, match="shared"):
        tssd.ssd_chunk_scan(x, dt, A, bc, bc, 1 << 16)


@pytest.mark.cuda
def test_cuda_ssd_bf16_refuses_long_chunks(cuda):
    """The tensor-core route takes chunks of at most 256 positions (16 row
    tiles, two per warp); a longer one raises before anything launches."""
    x = torch.zeros(1, 300, 2, 16, dtype=torch.bfloat16, device=cuda)
    dt, A = torch.zeros(1, 300, 2, device=cuda), torch.zeros(2, device=cuda)
    bc = torch.zeros(1, 300, 1, 16, device=cuda)
    with pytest.raises(ValueError, match="chunk 300"):
        tssd.ssd_chunk_scan(x, dt, A, bc, bc, 300)
    assert tops.launch_counts()["ssd_chunk_scan"] == 0


# --------------------------------------------------------------------------- #
# the device-resident planner's plan_step on the card
# --------------------------------------------------------------------------- #
def _plan_trace(rows, slots, n, steps, seed):
    """(state before the last step, its ids, its look-ahead union) after
    ``steps - 1`` CPU cycles of a random trace that evicts."""
    rng = np.random.default_rng(seed)
    batches = [rng.integers(0, rows, size=n).astype(np.int32) for _ in range(steps + 2)]
    st = tpd.init_state(rows, slots)
    for t in range(steps):
        ids = torch.from_numpy(batches[t])
        fut = torch.from_numpy(np.concatenate(batches[t + 1:t + 3]))
        if t == steps - 1:
            return st, ids, fut
        st, _ = tpd.plan_step(st, ids, fut)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,slots,n,steps", [(200, 96, 12, 40), (50_000, 20_000, 3_000, 12)])
def test_cuda_plan_step_equals_cpu(cuda, rows, slots, n, steps):
    state, ids, fut = _plan_trace(rows, slots, n, steps, seed=rows)
    want_state, want = tpd.plan_step(state, ids, fut)
    got_state, got = tpd.plan_step(tpd.PlanState(*(t.to(cuda) for t in state)),
                                   ids.to(cuda), fut.to(cuda))
    torch.cuda.synchronize()
    assert int(want["n_evict"]) > 0
    for k, v in want.items():
        assert got[k].device.type == "cuda" and torch.equal(got[k].cpu(), v), k
    for f, a, b in zip(tpd.PlanState._fields, got_state, want_state):
        a = a.cpu()
        if a.ndim:  # the dummy element takes padded writes in any order
            a, b = a[:-1], b[:-1]
        assert torch.equal(a, b), f


@pytest.mark.cuda
def test_cuda_plan_step_makes_no_host_sync(cuda):
    state, ids, fut = _plan_trace(50_000, 20_000, 3_000, 12, seed=1)
    state = tpd.PlanState(*(t.to(cuda) for t in state))
    ids, fut = ids.to(cuda), fut.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpd.plan_step(state, ids, fut)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# serving on the card: fp16/int8 replicas, static-serve, the front end
# --------------------------------------------------------------------------- #
def _serving_batches(steps=14):
    from repro_torch.core.table_group import TableGroup
    from repro_torch.traces.scenarios import scenario_batches

    group = TableGroup.uniform(2, 400, 16)
    return [g for g, _ in scenario_batches("flash_crowd", group, steps, batch_size=8,
                                           lookups_per_table=3, seed=7)]


def _serve(dev, design, precision="fp32", depth=2, hot=None):
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.serving_cache import (
        NoCacheServer,
        ReadOnlyCacheServer,
        StaticCacheServer,
    )
    from repro_torch.core.table_group import TableGroup
    from repro_torch.serving import replay_serving

    host = HostEmbeddingTable(800, 16, seed=7)
    if design == "static":
        srv = StaticCacheServer(host, hot, device=dev)
    elif design == "nocache":
        srv = NoCacheServer(host, device=dev)
    else:
        # 160 rows: above the depth-2 window's 3 x 24 ids per table, and
        # evicting over 14 micro-batches
        num_slots = 160 // {"fp32": 1, "fp16": 2, "int8": 4}[precision]
        srv = ReadOnlyCacheServer(host, num_slots, window=2, device=dev,
                                  table_group=TableGroup.uniform(2, 400, 16,
                                                                 precision=precision))
    return replay_serving(srv, _serving_batches(), depth=depth, collect_bags=True)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("precision", ["fp16", "int8"])
def test_cuda_reduced_precision_serving(cuda, precision, depth):
    """Bags bitwise equal to the same server's on the CPU; one gather of the
    precision's form per micro-batch, fills of its form, no fp32 gather."""
    want = _serve("cpu", "scratchpipe", precision, depth)
    tops.reset_launch_counts()
    got = _serve(cuda, "scratchpipe", precision, depth)
    counts = tops.launch_counts()
    for a, b in zip(got["bags"], want["bags"]):
        assert np.array_equal(a, b)
    assert sum(s.n_evict for s in got["stats"]) > 0
    gather, fill = (("gather_reduce_q", "fill_i8") if precision == "int8"
                    else ("gather_reduce_f16", "fill_f16"))
    assert counts[gather] == got["served"] == 14 and counts[fill] > 0
    assert sum(counts.values()) == counts[gather] + counts[fill], counts


@pytest.mark.cuda
def test_cuda_static_serve_one_gather_per_micro_batch(cuda):
    batches = _serving_batches()
    hot = np.unique(np.concatenate([b.ravel() for b in batches[:3]]))[:100]
    want = _serve("cpu", "nocache", depth=0)
    tops.reset_launch_counts()
    got = _serve(cuda, "static", depth=0, hot=hot)
    counts = tops.launch_counts()
    for a, b in zip(got["bags"], want["bags"]):
        assert np.array_equal(a, b)
    assert counts["gather_reduce"] == got["served"] == 14
    assert sum(counts.values()) == 14, counts


@pytest.mark.cuda
def test_cuda_frontend_launches_from_its_worker_only(cuda, monkeypatch):
    """Several host threads submit single requests to the front end over an
    int8 scratchpipe-serve on the card: every kernel launch comes from the
    front end's worker thread, and every request's bags equal its CPU
    oracle's."""
    import threading

    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.serving_cache import ReadOnlyCacheServer
    from repro_torch.core.table_group import TableGroup
    from repro_torch.serving import EmbeddingServer

    threads = set()
    for name in ("gather_reduce", "gather_reduce_q", "fill", "fill_gather_reduce",
                 "fill_gather_reduce_q"):
        real = getattr(tgr, name)

        def spy(*a, _real=real):
            threads.add(threading.get_ident())
            return _real(*a)
        monkeypatch.setattr(tgr, name, spy)
    group = TableGroup.uniform(2, 400, 16, precision="int8")
    rng = np.random.default_rng(3)
    reqs = {t: [group.globalize(rng.integers(0, 400, (1, 2, 3)))[0] for _ in range(20)]
            for t in range(4)}

    def run(dev):
        srv = ReadOnlyCacheServer(HostEmbeddingTable(800, 16, seed=7), 64, window=2,
                                  table_group=group, device=dev)
        out = {}

        def client(t):
            futs = [fe.lookup(r) for r in reqs[t]]
            out[t] = [f.result(timeout=60.0) for f in futs]

        with EmbeddingServer(srv, max_batch=8) as fe:
            ths = [threading.Thread(target=client, args=(t,)) for t in reqs]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=60.0)
            worker = fe._thread.ident
        return out, worker

    want, _ = run("cpu")
    assert not threads
    tops.reset_launch_counts()
    got, worker = run(cuda)
    torch.cuda.synchronize()
    assert threads == {worker}
    assert tops.launch_counts()["gather_reduce_q"] > 0
    for t in reqs:
        for a, b in zip(got[t], want[t]):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# multi-table (per-table slot ranges) and sharded runtimes on the card
# ---------------------------------------------------------------------------
class _KernelTrainer:
    """A [Train] that runs the port's training kernels with no MLP: the
    bags (``gather_reduce``, or ``fill_gather_reduce`` fused), then
    ``apply_grad`` (``scatter_add``) of 1e-3 x the bags. Elementwise
    products are rounded alike on both devices, so a run on the card equals
    the plain versions' run on the CPU bit for bit."""

    @staticmethod
    def _slots(storage, slots):
        if not isinstance(slots, torch.Tensor):
            slots = torch.from_numpy(np.ascontiguousarray(slots, np.int32))
        return slots.to(storage.device)

    def train_fn(self, storage, slots, batch):
        s = self._slots(storage, slots)
        bags = tsp.gather_reduce(storage, s)
        return tsp.apply_grad(storage, s, bags * 1e-3, 1.0), {}

    def fused_train_fn(self, storage, fill_slots, fill_rows, slots, batch):
        s = self._slots(storage, slots)
        fs = self._slots(storage, fill_slots)
        storage, bags = tsp.fill_gather_reduce(storage, fs, fill_rows, s)
        return tsp.apply_grad(storage, s, bags * 1e-3, 1.0), {}

    def sharded_train_fn(self, storages, slots_all, batch):
        """The fp32 shards train (one lookup per bag); the others keep
        their rows."""
        for storage, slots in zip(storages, slots_all):
            if isinstance(storage, torch.Tensor) and storage.dtype == torch.float32:
                s = self._slots(storage, slots).reshape(-1, 1)
                if s.numel():
                    self.train_fn(storage, s, batch)
        return storages, None


def _stats(stats):
    """StepStats as plain values (``by_table`` holds numpy arrays)."""
    return [{k: (v if k != "by_table" else {n: np.asarray(a).tolist() for n, a in v.items()})
             for k, v in dataclasses.asdict(st).items()} for st in stats]


def _multi_table_pipe(dev, fused, planner, executor, pad_buckets=None, **kw):
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.pipeline import ScratchPipe
    from repro_torch.core.table_group import TableGroup, TableSpec

    group = TableGroup([TableSpec("a", 4000, 40), TableSpec("b", 1500, 40),
                        TableSpec("c", 300, 40)])
    floor = group.window_floor(8 * 5)
    budgets = group.slot_budgets(3 * floor, min_per_table=floor)
    host = HostEmbeddingTable(group.total_rows, 40, seed=4)
    tr = _KernelTrainer()
    pipe = ScratchPipe(host, sum(budgets), tr.train_fn, table_group=group,
                       slot_budgets=budgets, planner=planner, executor=executor,
                       fused_train_fn=tr.fused_train_fn if fused else None,
                       pad_buckets=pad_buckets, device=dev, **kw)
    return group, host, pipe


def _multi_table_batches(group):
    from repro_torch.data.synthetic import dlrm_batches_group

    return list(dlrm_batches_group(group, 20, batch_size=8, lookups_per_table=5, seed=6))


def _multi_table_run(dev, fused, planner, executor, pad_buckets=None, hook=None, **kw):
    from repro_torch.data.lookahead import LookaheadStream

    group, host, pipe = _multi_table_pipe(dev, fused, planner, executor, pad_buckets, **kw)
    if hook is not None:
        hook(pipe)
    stream = LookaheadStream(iter(_multi_table_batches(group)))
    stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
    pipe.flush_to_host()
    pipe.close()
    return stats, host.data


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("planner,executor,pad", [
    ("host", "sync", None), ("device", "overlapped", None), ("device", "overlapped", (40, 72)),
], ids=["host-sync", "device-overlapped", "device-overlapped-buckets"])
def test_cuda_multi_table_pipeline_equals_plain(cuda, fused, planner, executor, pad):
    """Per-table slot ranges: fills (pad sentinel = the effective slot
    count), gathers and scatters on the card equal the CPU's plain run."""
    want = _multi_table_run("cpu", fused, "host", "sync")
    tops.reset_launch_counts()
    got = _multi_table_run(cuda, fused, planner, executor, pad)
    counts = tops.launch_counts()
    assert sum(s.n_evict for s in got[0]) > 0
    assert _stats(got[0]) == _stats(want[0])
    assert np.array_equal(got[1], want[1])
    assert counts["scatter_add"] == 20
    if fused:
        assert counts["fill_gather_reduce"] > 0 and counts["gather_reduce"] < 20
    else:
        assert counts["gather_reduce"] == 20 and counts["fill"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_cuda_traced_and_chaos_overlapped_equal_plain(cuda, fused):
    """A traced overlapped run and a supervised chaos run (worker kills, a
    stalled d2h past its timeout) on the card equal the CPU's untraced
    sync run bit for bit; the spans land on the worker threads."""
    from repro_torch.chaos import ChaosInjector, ChaosPlan
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.runtime import SupervisePolicy

    want = _multi_table_run("cpu", fused, "host", "sync")
    tr = Tracer()
    traced = _multi_table_run(cuda, fused, "device", "overlapped", tracer=tr,
                              metrics=MetricsRegistry())
    names = {(t.rsplit("_", 1)[0], n) for t, n in tr.totals()}
    assert {("scratchpipe-host", "collect.gather"), ("scratchpipe-d2h", "exchange.d2h"),
            ("scratchpipe-d2h", "plan.materialize")} <= names
    injected = []

    def arm(pipe):
        injected.append(ChaosInjector(ChaosPlan.parse(
            "kill-gather@3;fail-writeback@2;kill-d2h@3;stall-d2h@5:0.5"), seed=0).attach(pipe))

    chaos = _multi_table_run(cuda, fused, "device", "overlapped", hook=arm,
                             supervise=SupervisePolicy(op_timeout=0.1, backoff=0.0))
    assert len(injected[0].fired) == 4
    for got in (traced, chaos):
        assert _stats(got[0]) == _stats(want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("planner,executor", [("host", "sync"), ("device", "overlapped")])
def test_cuda_midwindow_state_roundtrip_equals_plain(cuda, planner, executor):
    """state_arrays mid-window on the card, loaded into a fresh runtime on
    the card: the resumed run equals the CPU's uninterrupted plain run."""
    from repro_torch.data.lookahead import LookaheadStream

    want = _multi_table_run("cpu", True, "host", "sync")
    group, _, pipe = _multi_table_pipe(cuda, True, planner, executor)
    batches = _multi_table_batches(group)
    stream = LookaheadStream(iter(batches))
    for i, (ids, b) in enumerate(stream):
        if i == 9:
            break
        pipe.run_one_cycle(ids, b, stream.peek_ids)
    assert pipe._window
    state = pipe.state_arrays()
    head = list(pipe.stats)
    pipe.close()
    _, host, pipe = _multi_table_pipe(cuda, True, planner, executor)
    pipe.load_state_arrays(state)
    stream = LookaheadStream(iter(batches[9:]))
    for ids, b in stream:
        pipe.run_one_cycle(ids, b, stream.peek_ids)
    while pipe._window:
        pipe.drain_one_cycle()
    pipe.flush_to_host()
    pipe.close()
    assert _stats(head + pipe.stats) == _stats(want[0])
    assert np.array_equal(host.data, want[1])


def _sharded_run(dev, precisions, planner, executor):
    from repro_torch.core.host_table import HostEmbeddingTable
    from repro_torch.core.runtime import make_runtime
    from repro_torch.core.table_group import TableGroup, TableSpec
    from repro_torch.data.lookahead import LookaheadStream
    from repro_torch.data.synthetic import dlrm_batches_group

    group = TableGroup([TableSpec(n, r, 40, precision=p) for (n, r), p in
                        zip((("a", 3000), ("b", 2000), ("c", 1500)), precisions)])
    budgets = [240 // tqz.SLOT_MULTIPLIER[p] for p in precisions]  # 6 x 8 x 5 rows
    host = HostEmbeddingTable(group.total_rows, 40, seed=5)
    rt = make_runtime("sharded", host, _KernelTrainer().sharded_train_fn, num_slots=0,
                      table_group=group, slot_budgets=budgets, planner=planner,
                      executor=executor, device=dev)
    stream = LookaheadStream(dlrm_batches_group(group, 16, batch_size=8,
                                                lookups_per_table=5, seed=9))
    rt.run(stream, lookahead_fn=stream.peek_ids)
    rt.flush_to_host()
    rt.close()
    return [p.stats for p in rt.pipes], host.data


@pytest.mark.cuda
@pytest.mark.parametrize("precisions", [("fp32", "fp32", "fp32"), ("int8", "fp16", "fp32")])
@pytest.mark.parametrize("planner,executor", [("host", "sync"), ("device", "overlapped")])
def test_cuda_sharded_fills_equal_plain(cuda, precisions, planner, executor):
    """One manager per table, each with its own storage form: the per-shard
    fills (and the fp32 shards' gathers and scatters) on the card equal the
    CPU's plain run; one fill of the shard's form per cycle with misses."""
    want = _sharded_run("cpu", precisions, "host", "sync")
    tops.reset_launch_counts()
    got = _sharded_run(cuda, precisions, planner, executor)
    counts = tops.launch_counts()
    assert np.array_equal(got[1], want[1])
    assert all(sum(s.n_evict for s in st) > 0 for st in got[0])
    form = {"fp32": "fill", "fp16": "fill_f16", "int8": "fill_i8"}
    for p in set(precisions):
        fills = sum(sum(1 for s in st if s.n_miss) for st, q in zip(got[0], precisions)
                    if q == p)
        assert counts[form[p]] == fills > 0, (p, counts)


# --------------------------------------------------------------------------- #
# the flash backward (LM training): lse from the forward, then the backward
# kernel against the explicit formulas of ref.flash_attention_bwd_ref, on
# the same lse. Limits: fp32 relative (Frobenius) 1e-5 and max |diff| 1e-4
# of the largest |plain| (the sums run in another order); bf16 1e-2 and
# 2e-2 (the outputs are rounded to bf16, 2^-9 relative). lse: within 1e-5
# at fp32 and 1e-3 at bf16 (the tensor-core forward's exp2.approx).
# --------------------------------------------------------------------------- #
_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
_BWD_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
_LSE_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _assert_bwd_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        diff = g.float() - w.float()
        scale = w.float().abs().max().item()
        err = diff.abs().max().item()
        rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(w.float())).item()
        assert err <= _BWD_MAX[dtype] * scale and rel <= _BWD_REL[dtype], (name, err, rel)


def _bwd_operands(dtype, cuda, B, Sq, Skv, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda).to(dtype)
            for shape in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd), (B, Sq, H, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize(
    "B,Sq,Skv,H,K,hd,causal,window,q_offset",
    [
        (2, 128, 128, 8, 2, 64, True, None, 0),  # GQA
        (2, 160, 160, 4, 1, 32, True, None, 0),  # MQA, ragged
        (2, 257, 257, 8, 2, 64, True, 100, 0),  # the window crosses key blocks
        (1, 300, 300, 4, 4, 64, False, 100, 0),  # non-causal window
        (2, 200, 200, 4, 4, 64, False, None, 0),  # non-causal, Skv not a block multiple
        (2, 70, 300, 4, 2, 64, False, None, 0),  # Sq != Skv
        (2, 100, 300, 8, 2, 64, True, None, 200),  # q_offset: a chunk after a prefix
        (1, 129, 400, 12, 4, 96, True, 150, 271),
        (1, 300, 300, 32, 2, 128, True, None, 0),  # chatglm3-6b's heads
        (1, 300, 300, 16, 16, 80, False, None, 0),  # hubert-xlarge's, non-causal
        (1, 700, 700, 32, 8, 128, True, 256, 0),  # mixtral's, a window that cuts
        (2, 96, 96, 2, 2, 16, False, None, 0),
        (1, 100, 100, 4, 4, 20, True, None, 0),  # hd not a multiple of 16
        # the bf16 kernels' edges: GQA groups the split does not divide evenly
        # (3 = 12/4 in 3 parts, 12 = 24/2 in 12), MHA (no split, no sum),
        # lengths one below and above the 64-row steps and 128-row blocks, a
        # window that ends inside a step, hd 16, 20, 80, 96, 128
        (1, 300, 300, 12, 4, 128, True, None, 0),
        (1, 191, 191, 24, 2, 128, True, None, 0),
        (2, 129, 129, 8, 8, 128, True, None, 0),
        (1, 63, 65, 8, 2, 64, False, None, 0),
        (1, 65, 63, 8, 2, 128, False, None, 0),
        (2, 127, 129, 6, 2, 96, True, None, 2),
        (1, 191, 191, 4, 4, 80, True, None, 0),
        (1, 320, 320, 8, 2, 128, True, 40, 0),
        (1, 300, 300, 4, 2, 64, False, 77, 0),
        (2, 129, 129, 4, 2, 16, True, 100, 0),
        (1, 191, 127, 6, 3, 20, False, None, 0),
    ],
)
def test_cuda_flash_attention_bwd_vs_plain(cuda, dtype, B, Sq, Skv, H, K, hd, causal,
                                           window, q_offset):
    q, k, v, do = _bwd_operands(dtype, cuda, B, Sq, Skv, H, K, hd, hd * 1000 + H + Sq)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda)
    o = tfa.flash_attention(q, k, v, causal, window, q_offset, lse=lse)
    want_lse = tref.flash_attention_lse_ref(q, k, causal, window, q_offset)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal, window, q_offset)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, q_offset)
    torch.cuda.synchronize()
    assert (lse - want_lse).abs().max().item() <= _LSE_ATOL[dtype]
    _assert_bwd_close(got, want, dtype)
    assert tops.launch_counts()["flash_attention_bwd"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,Sq,H,K,hd,causal,window,splits",
    [
        (1, 300, 12, 4, 128, True, None, 2),  # a group of 3 in parts of 1 and 2
        (1, 191, 24, 2, 128, True, None, 5),  # 12 in 2, 2, 3, 2, 3
        (2, 257, 32, 2, 64, True, 100, 3),  # 16 in 5, 5, 6, a window
        (1, 129, 24, 2, 96, False, None, 7),
    ],
)
def test_cuda_flash_attention_bwd_uneven_splits(cuda, monkeypatch, B, Sq, H, K, hd, causal,
                                                window, splits):
    """The bf16 dK/dV pass with its GQA group cut into parts that do not
    divide it evenly (``bwd_splits`` forced): within the limits of the
    plain version, and the same bits from two calls."""
    monkeypatch.setattr(tfa, "bwd_splits", lambda *_a: splits)
    q, k, v, do = _bwd_operands(torch.bfloat16, cuda, B, Sq, Sq, H, K, hd, 7 * splits + hd)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=cuda)
    o = tfa.flash_attention(q, k, v, causal, window, lse=lse)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal, window)
    want = tref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_flash_attention_lse_leaves_the_output_unchanged(cuda, dtype):
    """Serving passes no lse; training passes one: the output is bitwise
    the same, and a row with every key masked gets lse = +inf."""
    q, k, v, _ = _bwd_operands(dtype, cuda, 2, 200, 150, 8, 2, 64, 3)
    lse = torch.empty((2, 8, 200), dtype=torch.float32, device=cuda)
    for causal, window, q_offset in ((True, None, 0), (False, None, 0), (True, 64, 0)):
        a = tfa.flash_attention(q, k, v, causal, window, q_offset)
        b = tfa.flash_attention(q, k, v, causal, window, q_offset, lse=lse)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        assert bool(torch.isfinite(lse).all())
    # keys 0..149 at positions 0..149; rows at 200.. with a window of 10 see none
    tfa.flash_attention(q, k, v, True, 10, 200, lse=lse)
    torch.cuda.synchronize()
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cuda_flash_attention_autograd(cuda, dtype):
    """ops.flash_attention on CUDA tensors that require grad: one forward
    launch (with lse) and one backward call; the gradients are the
    backward kernel's. Under no_grad the forward alone launches."""
    q, k, v, do = _bwd_operands(dtype, cuda, 2, 130, 130, 8, 2, 64, 11)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tops.flash_attention(q, k, v, True, 48)
    out.backward(do)
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == 1
    assert tops.launch_counts()["flash_attention_bwd"] == 1
    lse = tref.flash_attention_lse_ref(q.detach(), k.detach(), True, 48)
    want = tref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                        lse, do, True, 48)
    _assert_bwd_close((q.grad, k.grad, v.grad), want, dtype)
    with torch.no_grad():
        tops.flash_attention(q, k, v, True, 48)
    assert tops.launch_counts()["flash_attention"] == 2
    assert tops.launch_counts()["flash_attention_bwd"] == 1


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_is_deterministic(cuda):
    """GQA's sum over a kv head's query heads runs in a fixed order (bf16: in
    order inside each split's CTA, then the splits' fp32 sums in split order;
    no float atomics): two backward calls give the same bits."""
    q, k, v, do = _bwd_operands(torch.bfloat16, cuda, 2, 300, 300, 32, 2, 128, 5)
    lse = torch.empty((2, 32, 300), dtype=torch.float32, device=cuda)
    o = tfa.flash_attention(q, k, v, True, None, lse=lse)
    a = tfa.flash_attention_bwd(q, k, v, o, lse, do, True, None)
    b = tfa.flash_attention_bwd(q, k, v, o, lse, do, True, None)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_checks_operands(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    lse = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd(q, q, q, q, lse[:, :, :4], q, True, None)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, q, q, q, lse.double(), q, True, None)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, q, q, q.bfloat16(), lse, q, True, None)
    with pytest.raises(ValueError, match="do"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q[:, :4], True, None)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention(q, q, q, True, None, lse=lse[:, :2])
