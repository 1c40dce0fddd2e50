"""The look-forward cache on an LM's token embedding: the port's
``CachedEmbeddingLM`` against the JAX package's, on the CPU.

llama4-scout-17b-a16e's smoke config (fp32, vocab 256, d_model 64, 2 MoE
layers), 10 steps of 4 x 16 tokens drawn from a numpy seed, lr 1e-2 for the
params and the rows. The reference's params (``jax.random.key(1)``) are
carried over by ``convert.lm_params_from_reference``; the host tables are
both packages' ``HostEmbeddingTable(V, D, seed=0)``, which are equal.

  * the port's ``train_fn`` over the full table with identity slots
    against the reference's, run as the reference's own test runs it
    (``tests/test_hlo_and_launch.py``, the ``mesh1`` fixture): losses at
    rtol 1e-4, the table within 2e-5, the params within 2e-4, that test's
    limits (fp32 in another summation order);
  * ``ScratchPipe`` over the port's ``train_fn`` — host planner and sync
    executor, device planner and overlapped executor, at a budget of 192
    slots (55 evictions) and at 232 (one) — bitwise equal to the port's
    full-table run: the losses, the params and the flushed host table (the
    paper's "algorithm unchanged" claim), each [Train] reading from slots
    inside the scratchpad the rows the full table holds for its tokens
    (every lookup hits); the 192-slot run also against the reference's
    ``ScratchPipe`` run, within the limits above;
  * a tied head and a family without ``inputs_embeds`` are refused; two
    runs are bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.cached_embedding import CachedEmbeddingLM as RefCachedEmbeddingLM
from repro.core.host_table import HostEmbeddingTable as RefHostTable
from repro.core.pipeline import ScratchPipe as RefScratchPipe
from repro.data.lookahead import LookaheadStream as RefLookaheadStream
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core.cached_embedding import CachedEmbeddingLM, unique_inverse
from repro_torch.core.host_table import HostEmbeddingTable
from repro_torch.core.pipeline import ScratchPipe
from repro_torch.data.lookahead import LookaheadStream
from repro_torch.models import api
from repro_torch.optim.optimizers import tree_leaves

ARCH = "llama4-scout-17b-a16e"
STEPS, B, S, LR = 10, 4, 16, 1e-2
SLOTS = 192  # the reference test's budget
LOSS_RTOL, TABLE_ATOL, PARAM_ATOL = 1e-4, 2e-5, 2e-4
_CACHE = {}


def _data():
    cfg = ref_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(STEPS, B, S), dtype=np.int64)
    return toks, np.roll(toks, -1, axis=2).astype(np.int32)


def _reference(mesh):
    """The reference's full-table and cached runs, once per session:
    {"params0" (numpy, before training), "full"/"cached": (losses, table,
    params as numpy)}."""
    if "ref" in _CACHE:
        return _CACHE["ref"]
    cfg = ref_smoke_config(ARCH)
    V, D = cfg.vocab_size, cfg.d_model
    toks, labels = _data()
    out = {}
    with jax.set_mesh(mesh):
        lm = RefCachedEmbeddingLM(cfg, mesh, jax.random.key(1), lr=LR, emb_lr=LR)
        out["params0"] = jax.tree.map(np.array, lm.params)
        table = jax.device_put(RefHostTable(V, D, seed=0).data)
        losses = []
        for i in range(STEPS):
            table, aux = lm.train_fn(table, jnp.asarray(toks[i]),
                                     {"labels": jnp.asarray(labels[i])})
            losses.append(float(aux["loss"]))
        out["full"] = (losses, np.array(table), jax.tree.map(np.array, lm.params))

        lm = RefCachedEmbeddingLM(cfg, mesh, jax.random.key(1), lr=LR, emb_lr=LR)
        host = RefHostTable(V, D, seed=0)
        pipe = RefScratchPipe(host, num_slots=SLOTS, train_fn=lm.train_fn)
        stream = RefLookaheadStream(iter(
            [(toks[i], {"labels": jnp.asarray(labels[i])}) for i in range(STEPS)]))
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
        out["cached"] = ([float(s.aux["loss"]) for s in stats], host.data.copy(),
                         jax.tree.map(np.array, lm.params))
    _CACHE["ref"] = out
    return out


def _port_lm(params0):
    return CachedEmbeddingLM(get_smoke_config(ARCH), lr=LR, emb_lr=LR, device="cpu",
                             params=convert.lm_params_from_reference(params0))


def _port_full(params0):
    """The port's train_fn over the full table, identity slots ->
    (losses, table, params, the rows each step read)."""
    cfg = get_smoke_config(ARCH)
    toks, labels = _data()
    lm = _port_lm(params0)
    table = torch.from_numpy(HostEmbeddingTable(cfg.vocab_size, cfg.d_model, seed=0).data)
    losses, seen = [], []
    for i in range(STEPS):
        seen.append(table[torch.from_numpy(toks[i])].clone())
        table, aux = lm.train_fn(table, toks[i], {"labels": labels[i]})
        losses.append(float(aux["loss"]))
    return losses, table.numpy(), lm.params, seen


def _port_cached(params0, num_slots=SLOTS, planner="host", executor="sync"):
    """The port's ScratchPipe run -> (losses, flushed table, params, stats,
    the rows each [Train] read from its slots, each slot checked to lie in
    the scratchpad)."""
    cfg = get_smoke_config(ARCH)
    toks, labels = _data()
    lm = _port_lm(params0)
    seen = []

    def train_fn(storage, slots, batch):
        s = torch.as_tensor(np.asarray(slots)).long()
        assert 0 <= int(s.min()) and int(s.max()) < num_slots
        seen.append(storage[s].clone())
        return lm.train_fn(storage, slots, batch)

    host = HostEmbeddingTable(cfg.vocab_size, cfg.d_model, seed=0)
    pipe = ScratchPipe(host, num_slots, train_fn, planner=planner, executor=executor,
                       device="cpu")
    stream = LookaheadStream(iter([(toks[i], {"labels": labels[i]}) for i in range(STEPS)]))
    try:
        stats = pipe.run(stream, lookahead_fn=stream.peek_ids)
        pipe.flush_to_host()
    finally:
        pipe.close()
    return [float(s.aux["loss"]) for s in stats], host.data.copy(), lm.params, stats, seen


def _ref_params_close(got, want):
    got = convert.lm_params_to_reference(got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=PARAM_ATOL)


def _bitwise(a, b):
    (la, ta, pa), (lb, tb, pb) = a[:3], b[:3]
    assert la == lb
    assert np.array_equal(ta, tb)
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(x, y)


def test_reference_params_convert_without_the_embedding(mesh1):
    """The reference's params (no ``embed``) convert as they are, into the
    tree the port's constructor draws."""
    params0 = _reference(mesh1)["params0"]
    got = convert.lm_params_from_reference(params0)
    cfg = get_smoke_config(ARCH)
    drawn = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    drawn.pop("embed")
    assert "embed" not in got and sorted(got) == sorted(drawn)
    assert [t.shape for t in tree_leaves(got)] == [t.shape for t in tree_leaves(drawn)]
    lm = CachedEmbeddingLM(cfg, seed=0, device="cpu")
    assert "embed" not in lm.params
    assert [t.shape for t in tree_leaves(lm.params)] == [t.shape for t in tree_leaves(drawn)]


def test_full_table_train_fn_matches_reference(mesh1):
    ref = _reference(mesh1)
    losses, table, params, _ = _port_full(ref["params0"])
    want_losses, want_table, want_params = ref["full"]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(table, want_table, atol=TABLE_ATOL)
    _ref_params_close(params, want_params)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("planner,executor,num_slots", [
    ("host", "sync", SLOTS),
    ("device", "overlapped", SLOTS),
    ("host", "sync", 232),
    ("device", "overlapped", 232),
], ids=["host-sync-192", "device-overlapped-192", "host-sync-232", "device-overlapped-232"])
def test_cached_training_equals_full_table(mesh1, planner, executor, num_slots):
    """Cached training == full-table training, bitwise, at both planner
    placements and executors. Both budgets evict: 192 slots (the
    smallest the window's working set allows) 55 rows, 232 slots one.
    Every lookup hits: each [Train] reads, from slots inside the
    scratchpad, exactly the rows the full table holds for its tokens."""
    ref = _reference(mesh1)
    full = _port_full(ref["params0"])
    cached = _port_cached(ref["params0"], num_slots, planner, executor)
    _bitwise(cached, full)
    stats = cached[3]
    assert sum(s.n_evict for s in stats) > 0
    assert len(cached[4]) == len(full[3]) == STEPS
    for got, want in zip(cached[4], full[3]):
        assert torch.equal(got, want)
    if num_slots == SLOTS:  # and the reference's own cached run
        want_losses, want_table, want_params = ref["cached"]
        np.testing.assert_allclose(cached[0], want_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(cached[1], want_table, atol=TABLE_ATOL)
        _ref_params_close(cached[2], want_params)


def test_two_runs_are_bitwise_equal(mesh1):
    params0 = _reference(mesh1)["params0"]
    _bitwise(_port_cached(params0, planner="device", executor="overlapped"),
             _port_cached(params0, planner="device", executor="overlapped"))


@pytest.mark.parametrize("arch,match", [
    ("mamba2-2.7b", "untied head"),
    ("zamba2-1.2b", "takes no inputs_embeds"),
])
def test_refused_configs(arch, match):
    """A tied head (mamba2-2.7b, as the reference asserts) and a family
    whose loss takes no ``inputs_embeds`` are refused, naming the config."""
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match=match) as e:
        CachedEmbeddingLM(cfg, seed=0, device="cpu")
    assert cfg.name in str(e.value)


def test_params_with_an_embedding_or_no_seed_are_refused():
    cfg = get_smoke_config(ARCH)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="must not hold the embedding"):
        CachedEmbeddingLM(cfg, device="cpu", params=params)
    with pytest.raises(ValueError, match="give gen="):
        CachedEmbeddingLM(cfg, device="cpu")


@pytest.mark.parametrize("shape,hi", [((4, 16), 256), ((3, 7), 5), ((1, 1), 9), ((2, 64), 100000)])
def test_unique_inverse_of_a_tensor_matches_numpy(shape, hi):
    """The sync-free unique of either planner's slots (numpy or a tensor):
    the sorted unique slots first, the largest repeated after them, and
    the same inverse as np.unique."""
    slots = np.random.default_rng(hi).integers(0, hi, size=shape).astype(np.int32)
    want_u, want_inv = np.unique(slots.ravel(), return_inverse=True)
    n = want_u.size
    for given in (slots, torch.from_numpy(slots)):
        u, inv = unique_inverse(given, torch.device("cpu"))
        assert u.shape == (slots.size,) and inv.shape == (slots.size,)
        assert np.array_equal(u[:n].numpy(), want_u) and (u[n:] == want_u[-1]).all()
        assert np.array_equal(inv.numpy(), want_inv.ravel())
        assert torch.equal(u[inv], torch.from_numpy(slots.ravel()).long())
