"""The bf16 flash backward's split of a GQA group across CTAs
(``kernels/flash_attention.py: bwd_splits``, ``bwd_workspace_shape``): how
many parts the dK/dV pass cuts each kv head's group of query heads into,
and the fp32 workspace the wrapper allocates for their sums. Plain Python,
held here on the CPU; the kernels that read them are held on the card by
tests/test_torch_cuda.py."""
import pytest

from repro_torch.kernels import flash_attention as tfa

# (B, Skv, H, K, hd): PERF.md's rows 7-bwd, 7a-bwd, 7h-bwd and 7c, and the
# test_torch_cuda.py cases at the split's edges
SHAPES = [
    (4, 4096, 32, 2, 128),  # chatglm3-6b, the main path
    (4, 2048, 32, 2, 128),
    (1, 8192, 32, 8, 128),  # mixtral-8x7b
    (4, 2048, 16, 16, 80),  # hubert-xlarge: MHA
    (1, 300, 12, 4, 128),  # a group of 3
    (1, 191, 24, 2, 128),  # a group of 12
    (2, 129, 8, 8, 128),  # MHA
    (1, 300, 32, 2, 128),
    (2, 128, 8, 2, 64),
    (1, 63, 8, 2, 64),
    (1, 700, 32, 8, 128),
]


def _head_ranges(G, n):
    return [(i * G // n, (i + 1) * G // n) for i in range(n)]


@pytest.mark.parametrize("B,Skv,H,K,hd", SHAPES)
def test_bwd_splits_cut_the_group_in_order(B, Skv, H, K, hd):
    """Between 1 and G parts; each part's heads (the kernel's [i G / n,
    (i + 1) G / n)) are non-empty and the parts cover the group once, in
    order; the workspace holds dK's and dV's fp32 sums of every part, and
    is absent exactly when there is one part."""
    G = H // K
    n = tfa.bwd_splits(B, Skv, H, K)
    assert 1 <= n <= G
    ranges = _head_ranges(G, n)
    assert all(lo < hi for lo, hi in ranges)
    assert [h for lo, hi in ranges for h in range(lo, hi)] == list(range(G))
    shape = tfa.bwd_workspace_shape(B, Skv, H, K, hd)
    if n == 1:
        assert shape is None
    else:
        assert shape == (2, n, B, Skv, K, hd)


@pytest.mark.parametrize("B,Skv,H,K,hd", SHAPES)
def test_bwd_splits_fill_the_card_or_the_group(B, Skv, H, K, hd):
    """As few parts as give BWD_CTAS_PER_SM CTAs on each of BWD_SMS SMs:
    one part fewer would not, unless the group is used up."""
    G = H // K
    n = tfa.bwd_splits(B, Skv, H, K)
    blocks = -(-Skv // tfa.BWD_KEYS_PER_CTA) * K * B
    target = tfa.BWD_SMS * tfa.BWD_CTAS_PER_SM
    assert blocks * n >= target or n == G
    assert n == 1 or blocks * (n - 1) < target


def test_bwd_splits_at_the_main_path():
    """chatglm3-6b at 4 x 4096 (32 query heads on 2 kv heads): 2 parts of 8
    heads, 512 CTAs; the workspace 2 x 33.5 MB (dK's and dV's fp32 sums of
    a part). At 4 x 2048, 3 parts of 5, 5 and 6 heads; mixtral-8x7b at 1 x
    8192 and MHA (hubert-xlarge) one part and no workspace."""
    assert tfa.bwd_splits(4, 4096, 32, 2) == 2
    assert _head_ranges(16, 2) == [(0, 8), (8, 16)]
    shape = tfa.bwd_workspace_shape(4, 4096, 32, 2, 128)
    n_bytes = 4
    for d in shape:
        n_bytes *= d
    assert n_bytes == 2 * 2 * 4 * 4096 * 2 * 128 * 4 == 67_108_864
    assert tfa.bwd_splits(4, 2048, 32, 2) == 3
    assert _head_ranges(16, 3) == [(0, 5), (5, 10), (10, 16)]
    assert tfa.bwd_splits(1, 8192, 32, 8) == 1
    assert tfa.bwd_splits(4, 2048, 16, 16) == 1
    assert tfa.bwd_workspace_shape(4, 2048, 16, 16, 80) is None


def test_bwd_splits_do_not_depend_on_the_card():
    """The split, and with it the order of dK's and dV's sums, is a function
    of the shape alone: no device is asked."""
    assert tfa.BWD_SMS == 132
    assert [tfa.bwd_splits(*s[:4]) for s in SHAPES] == [tfa.bwd_splits(*s[:4]) for s in SHAPES]
