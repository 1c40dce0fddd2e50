"""The port's request front end (``repro_torch.serving.EmbeddingServer``)
against the JAX package's, on the CPU.

The cases of tests/test_serving.py's S5 against the port (each request's
future resolves to its own bags; concurrent submitters; no lookup after
close), plus: every request's bags bitwise equal to the reference front
end's and to the port's ``nocache-serve`` oracle — over fp32, fp16 and int8
scratchpads (the reduced-precision oracle dequantizes the host rows) —
however the worker happens to batch them; a backend failure reaches every
waiting caller; and the worker thread is the only thread that drives the
backend.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

from repro.core.host_table import HostEmbeddingTable as JHost
from repro.core.serving_cache import ReadOnlyCacheServer as JServer
from repro.core.table_group import TableGroup as JGroup
from repro.serving import EmbeddingServer as JFront
from repro_torch.core import quantize as tqz
from repro_torch.core.host_table import HostEmbeddingTable as THost
from repro_torch.core.serving_cache import NoCacheServer as TNoCache
from repro_torch.core.serving_cache import ReadOnlyCacheServer as TServer
from repro_torch.core.table_group import TableGroup as TGroup
from repro_torch.serving import EmbeddingServer

SEED = 7
DIM = 8
WINDOW = 2


def small_group(precision="fp32") -> TGroup:
    return TGroup.uniform(2, 400, DIM, precision=precision)


def make_host() -> THost:
    return THost(800, DIM, seed=SEED)


def requests(n, seed=SEED):
    rng = np.random.default_rng(seed)
    group = small_group()
    return [group.globalize(rng.integers(0, 400, size=(1, 2, 3)))[0] for _ in range(n)]


def oracle_bags(host, reqs, precision="fp32"):
    """nocache-serve's bags for each request (the whole list as one
    micro-batch: a bag depends on its own request only), over host rows
    quantized and dequantized to ``precision``."""
    class Host(THost):
        def gather(self, ids):
            rows = super().gather(ids)
            return tqz.dequantize_rows_np(tqz.quantize_rows_np(rows, precision), precision)

    srv = TNoCache(Host(host.rows, host.dim, data=host.data), device="cpu")
    srv.enqueue(np.stack(reqs))
    return srv.serve_next()[0]


def test_frontend_resolves_each_request_to_its_own_bags():
    host = make_host()
    srv = TServer(host, 256, window=WINDOW, table_group=small_group(), device="cpu")
    reqs = requests(40)
    with EmbeddingServer(srv, max_batch=4) as server:
        futures = [server.lookup(r) for r in reqs]
        results = [f.result(timeout=60.0) for f in futures]
    want = oracle_bags(host, reqs)
    for i, (req, got) in enumerate(zip(reqs, results)):
        assert got.shape == (2, DIM) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want[i])
        ref = host.data[req.ravel()].reshape(2, 3, DIM).sum(axis=1)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert srv.stats and all(st.n_lookups <= 4 * 6 for st in srv.stats)


@pytest.mark.parametrize("precision", ["fp32", "fp16", "int8"])
def test_frontend_concurrent_submitters(precision):
    host = make_host()
    srv = TServer(host, 256, window=WINDOW, table_group=small_group(precision),
                  device="cpu")
    per_thread = 12
    reqs = {t: requests(per_thread, seed=SEED + 1 + t) for t in range(4)}
    results: dict = {}
    serving_threads = set()
    real_serve = srv.serve_next

    def serve_next():
        serving_threads.add(threading.get_ident())
        return real_serve()

    srv.serve_next = serve_next

    def client(t):
        futs = [server.lookup(r) for r in reqs[t]]
        results[t] = [np.asarray(f.result(timeout=60.0)) for f in futs]

    with EmbeddingServer(srv, max_batch=8) as server:
        threads = [threading.Thread(target=client, args=(t,)) for t in reqs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
        worker = server._thread.ident
    assert set(results) == set(reqs)
    assert serving_threads == {worker}  # only the worker thread drives the backend
    for t, out in results.items():
        want = oracle_bags(host, reqs[t], precision)
        for i, got in enumerate(out):
            np.testing.assert_array_equal(got, want[i])


def test_frontend_matches_reference_frontend():
    """The same requests through the reference's front end and the port's:
    every request's bags bitwise equal, whatever micro-batches each worker
    formed."""
    reqs = requests(30, seed=SEED + 9)
    out = {}
    for name, front, server in (
            ("ref", JFront, JServer(JHost(800, DIM, seed=SEED), 96, window=WINDOW,
                                    table_group=JGroup.uniform(2, 400, DIM))),
            ("port", EmbeddingServer, TServer(make_host(), 96, window=WINDOW,
                                              table_group=small_group(), device="cpu"))):
        with front(server, max_batch=5) as fe:
            futs = [fe.lookup(r) for r in reqs]
            out[name] = [np.asarray(f.result(timeout=60.0)) for f in futs]
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)


def test_frontend_rejects_after_close():
    srv = TServer(make_host(), 128, window=WINDOW, table_group=small_group(), device="cpu")
    server = EmbeddingServer(srv)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.lookup(small_group().globalize(np.zeros((1, 2, 3), np.int64))[0])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_frontend_delivers_a_backend_failure_to_every_caller():
    """The worker re-raises the backend's fault after failing every
    request it holds, queued or already admitted to the backend."""
    class Failing:
        pending = 0

        def enqueue(self, ids, tag=None):
            self.tag, self.pending = tag, 1

        def serve_next(self):
            raise ValueError("backend fault")

    server = EmbeddingServer(Failing(), max_batch=64)
    futs = [server.lookup(np.zeros((2, 3), np.int64)) for _ in range(3)]
    for f in futs:
        with pytest.raises(ValueError, match="backend fault"):
            f.result(timeout=10.0)
    server._thread.join(timeout=10.0)
    with pytest.raises(RuntimeError, match="worker died"):
        server.lookup(np.zeros((2, 3), np.int64))


def test_frontend_tracer_is_item_12():
    srv = TServer(make_host(), 128, window=WINDOW, table_group=small_group(), device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md Queue 1 item 12\)"):
        EmbeddingServer(srv, tracer=object())
