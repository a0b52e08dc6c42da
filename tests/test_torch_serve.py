"""The micro-batching searcher, JAX package vs PyTorch port, on the CPU.

The cases of the reference's test_serve.py run through
`reverso_tpu.serve.BatchingSearcher` and `reverso_tpu_torch.serve.
BatchingSearcher` alike: over a counting numpy index, and for the port
also over one that returns torch tensors as `DeviceIndex.search` does
(the completion pool copies them to the host). Then the engines:
`search_similar(use_batcher=True)`, `query(use_batcher=True)`,
`recommend(use_batcher=True)`, `searcher` and `warmup()` on the same
store, and the batcher over the IVF index.

Tolerance: the fake index is exact numpy, so results are equal; through
the engines the store is float32 and scores agree within 1e-5
(test_torch_query.py's rule), ids are equal.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from reverso_tpu import serve as jax_serve
from reverso_tpu_torch import serve as port_serve

from test_torch_query import D, build_store, engines, same

SERVES = {"jax": jax_serve, "port": port_serve}


class FakeIndex:
    """Exact numpy top-k with launch counting and optional delay."""

    as_torch = False

    def __init__(self, db, delay=0.0, fail=False):
        self.db = db
        self.delay = delay
        self.fail = fail
        self.launches = 0
        self.batch_sizes = []
        self.ks = []

    def search(self, queries, k):
        self.launches += 1
        self.batch_sizes.append(queries.shape[0])
        self.ks.append(k)
        if self.fail:
            raise RuntimeError("boom")
        if self.delay:
            time.sleep(self.delay)
        s = queries @ self.db.T
        ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
        out = np.take_along_axis(s, ids, axis=1), ids.astype(np.int32)
        return tuple(map(torch.from_numpy, out)) if self.as_torch else out


class TorchFakeIndex(FakeIndex):
    as_torch = True


def _db(n=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d)).astype(np.float32)
    return db / np.linalg.norm(db, axis=1, keepdims=True)


# (package, index class): the port runs over both index flavours
FLAVOURS = [("jax", FakeIndex), ("port", FakeIndex), ("port", TorchFakeIndex)]
FLAVOUR_IDS = ["jax", "port-numpy", "port-torch"]


def _run_threads(fn, n):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)


@pytest.mark.parametrize("pkg,index", FLAVOURS, ids=FLAVOUR_IDS)
def test_concurrent_searches_coalesce_and_match_serial(pkg, index):
    db = _db()
    idx = index(db, delay=0.005)
    b = SERVES[pkg].BatchingSearcher(lambda: idx, max_delay_s=0.02)
    results = {}
    _run_threads(lambda i: results.__setitem__(i, b.search(db[i], k=5)), 16)
    b.close()
    for i in range(16):
        scores, ids = results[i]
        assert isinstance(ids, np.ndarray) and ids[0] == i
        np.testing.assert_array_equal(ids, np.argsort(-(db[i] @ db.T), kind="stable")[:5])
        np.testing.assert_allclose(scores, np.sort(db[i] @ db.T)[::-1][:5], rtol=1e-6)
    assert idx.launches < 16 and b.served == 16


@pytest.mark.parametrize("pkg,index", FLAVOURS, ids=FLAVOUR_IDS)
def test_mixed_k_and_padded_launch_shapes(pkg, index):
    """Each caller gets its own k; launches run at power-of-two buckets
    with k padded to a multiple of 8 (the JAX package's shapes)."""
    db = _db()
    idx = index(db, delay=0.005)
    b = SERVES[pkg].BatchingSearcher(lambda: idx, max_delay_s=0.05)
    out = {}
    ks = (3, 7, 1, 10, 9)
    _run_threads(lambda i: out.__setitem__(i, b.search(db[i], k=ks[i])), len(ks))
    b.close()
    for i, k in enumerate(ks):
        assert len(out[i][1]) == k and out[i][1][0] == i
    assert all(bs in (1, 2, 4, 8) for bs in idx.batch_sizes), idx.batch_sizes
    assert all(k % 8 == 0 and k >= 8 for k in idx.ks), idx.ks


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 64, 100, 255, 256, 257, 1000])
def test_bucket_and_k_padding_equal_jax(n):
    assert port_serve.BatchingSearcher._bucket(n, 256) == \
        jax_serve.BatchingSearcher._bucket(n, 256)
    assert port_serve._round_up_8(n) == jax_serve._round_up_8(n)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_error_propagates_to_every_waiter(pkg):
    idx = FakeIndex(_db(), fail=True)
    b = SERVES[pkg].BatchingSearcher(lambda: idx, max_delay_s=0.01)
    errs = []

    def worker(_):
        try:
            b.search(np.zeros(16, np.float32), k=3)
        except SERVES[pkg].SearchError as e:
            errs.append(str(e))

    _run_threads(worker, 4)
    b.close()
    assert len(errs) == 4 and all("boom" in e for e in errs)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mixed_dims_do_not_poison_the_batch(pkg):
    db = _db()
    idx = FakeIndex(db, delay=0.005)
    b = SERVES[pkg].BatchingSearcher(lambda: idx, max_delay_s=0.05)
    out, errs = {}, {}

    def worker(i):
        if i == 4:
            try:
                b.search(np.zeros(7, np.float32), k=3)
            except SERVES[pkg].SearchError as e:
                errs["bad"] = str(e)
        else:
            out[i] = b.search(db[i], k=3)

    _run_threads(worker, 5)
    b.close()
    assert all(out[i][1][0] == i for i in range(4)) and "bad" in errs


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_k_bounds_and_closed_searcher(pkg):
    s = SERVES[pkg]
    b = s.BatchingSearcher(lambda: FakeIndex(_db()), k_cap=16, max_delay_s=0.0)
    with pytest.raises(s.SearchError, match="k_cap"):
        b.search(np.zeros(16, np.float32), k=64)
    for k in (0, -5):
        with pytest.raises(s.SearchError, match="k must be >= 1"):
            b.search(np.zeros(16, np.float32), k=k)
    b.close()
    t0 = time.monotonic()
    with pytest.raises(s.SearchError, match="closed"):
        b.search(np.zeros(16, np.float32), k=3)
    assert time.monotonic() - t0 < 1.0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_overload_sheds_fast_instead_of_hanging(pkg):
    s = SERVES[pkg]
    db = _db()
    idx = FakeIndex(db, delay=0.15)
    b = s.BatchingSearcher(lambda: idx, max_delay_s=0.01, max_batch=2, max_queue=3)
    ok, shed, slow = [], [], []

    def worker(i):
        t0 = time.monotonic()
        try:
            ok.append((i, b.search(db[i % len(db)], k=3)))
        except s.OverloadedError:
            shed.append(i)
            if time.monotonic() - t0 > 0.05:
                slow.append(i)

    _run_threads(worker, 24)
    stats = b.stats()
    b.close()
    assert shed and not slow
    assert stats["shed"] == len(shed) and stats["served"] == len(ok)
    assert all(ids[0] == i % len(db) for i, (_, ids) in ok)


@pytest.mark.parametrize("pkg,index", FLAVOURS, ids=FLAVOUR_IDS)
def test_stats_and_pipelined_completion(pkg, index):
    """Back-to-back batches through the completion pool return the
    serial results, and the telemetry counts them."""
    db = _db(128, 16)
    idx = index(db, delay=0.002)
    b = SERVES[pkg].BatchingSearcher(lambda: idx, max_delay_s=0.0, max_inflight=2)
    results = {}
    _run_threads(lambda qi: results.__setitem__(qi, b.search(db[qi], k=5)), 32)
    stats = b.stats()
    b.close()
    for qi, (_, ids) in results.items():
        np.testing.assert_array_equal(ids, np.argsort(-(db[qi] @ db.T), kind="stable")[:5])
    assert stats["served"] == 32 and stats["launches"] == idx.launches
    assert stats["shed"] == 0 and stats["queue_depth"] == 0
    assert 0 < stats["latency_p50_ms"] <= stats["latency_p95_ms"] < 10_000


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_timed_out_request_is_withdrawn_from_queue(pkg):
    s = SERVES[pkg]
    db = _db()
    gate = threading.Event()

    class Blocking(FakeIndex):
        def search(self, queries, k):
            gate.wait(timeout=10)
            return super().search(queries, k)

    idx = Blocking(db)
    b = s.BatchingSearcher(lambda: idx, max_delay_s=0.0, max_batch=1)
    t1 = threading.Thread(target=lambda: b.search(db[0], k=3))
    t1.start()
    time.sleep(0.05)
    with pytest.raises(s.SearchError, match="timed out"):
        b.search(db[1], k=3, timeout=0.05)
    with b._cv:
        assert len(b._queue) == 0
    gate.set()
    t1.join(timeout=10)
    b.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fetch_error_propagates_to_its_group_only(pkg):
    s = SERVES[pkg]

    class Poisoned:
        def __array__(self, *a, **kw):
            raise RuntimeError("fetch boom")

    class FetchFail(FakeIndex):
        fail_next = True

        def search(self, queries, k):
            if self.fail_next:
                self.fail_next = False
                return Poisoned(), Poisoned()
            return super().search(queries, k)

    idx = FetchFail(_db())
    b = s.BatchingSearcher(lambda: idx, max_delay_s=0.0, max_inflight=1)
    with pytest.raises(s.SearchError, match="fetch boom"):
        b.search(np.zeros(16, np.float32), k=3)
    assert b.search(_db()[5], k=3)[1][0] == 5
    b.close()


# -- through the engines ------------------------------------------------------

@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve"))
    x, _ = build_store(root, n=800)
    jax_eng, port = engines(root)
    jax_eng.load_database("main")
    port.load_database("main")
    yield jax_eng, port, x
    for e in (jax_eng, port):
        if e._searcher is not None:
            e._searcher.close()


ENGINE_CALLS = {
    "search_similar": lambda e, x: e.search_similar(0.0, 10, embeddings=x[:3],
                                                    query_index=1, use_batcher=True),
    "search_similar_filtered": lambda e, x: e.search_similar(
        0.0, 10, embeddings=x[:3], use_batcher=True, filter={"cls": "car"}),
    "search_similar_above_cap": lambda e, x: e.search_similar(
        0.0, 200, embeddings=x[:1], use_batcher=True),
    "query": lambda e, x: e.query(x[4], k=7, use_batcher=True),
    "query_named": lambda e, x: e.query(np.ones(32, np.float32), k=5, using="aux",
                                        use_batcher=True),
    "recommend": lambda e, x: e.recommend([1, 2], [3], 9, use_batcher=True),
    "searcher_direct": lambda e, x: e.searcher.search(x[6], k=5),
}


@pytest.mark.parametrize("case", list(ENGINE_CALLS))
def test_engine_batcher_calls_match_jax(engine_pair, case):
    jax_eng, port, x = engine_pair
    fn = ENGINE_CALLS[case]
    j, t = fn(jax_eng, x), fn(port, x)
    if isinstance(j[0], str):
        assert t[0].split("\n")[0] == j[0].split("\n")[0]
        j, t = list(j[1]), list(t[1])
    same(j, t)


def test_engine_concurrent_batcher_equals_search_batch(engine_pair):
    """16 threads through the port's searcher: every answer equals the
    port's own search_batch row and the JAX engine's, and the launches
    coalesce."""
    jax_eng, port, x = engine_pair
    q = x[:16] + 0.02
    want = port.search_batch(q, 10)
    same(jax_eng.search_batch(q, 10), want)
    before = port.searcher.stats()
    got = {}
    barrier = threading.Barrier(16)

    def one(i):
        barrier.wait()
        got[i] = port.searcher.search(q[i], k=10)

    _run_threads(one, 16)
    after = port.searcher.stats()
    for i in range(16):
        same((want[0][i], want[1][i]), got[i])
    assert after["served"] - before["served"] == 16
    assert after["launches"] - before["launches"] < 16


def test_engine_searcher_property_is_race_free(engine_pair):
    _, port, _ = engine_pair
    port._searcher = None
    got = [None] * 16
    barrier = threading.Barrier(16)

    def grab(i):
        barrier.wait()
        got[i] = port.searcher

    _run_threads(grab, 16)
    assert all(s is got[0] for s in got)


def test_engine_warmup_matches_jax(tmp_path):
    """warmup() runs the encoder and one batcher launch at (bucket 1,
    k_pad); its status string is the JAX engine's."""
    from reverso_tpu.config import MODEL_PRESETS as JAX_PRESETS
    from reverso_tpu.models.pe import PerceptionEncoder as JaxPE
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    root = str(tmp_path)
    jax_eng, port = engines(root)
    jax_eng._encoder = JaxPE(dataclasses.replace(JAX_PRESETS["test-tiny"], dtype="float32"))
    port._encoder = PerceptionEncoder(
        dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32"), device="cpu")
    jax_eng.config = jax_eng.config.replace(model=jax_eng._encoder.cfg)
    port.config = port.config.replace(model=port._encoder.cfg)
    assert port.warmup() == jax_eng.warmup() == "warmed: encoder"
    e = port.encoder.embed_dim
    rng = np.random.default_rng(0)
    from reverso_tpu_torch.store import VectorStore
    with VectorStore.create(root, "w", e) as s:
        s.append(rng.standard_normal((20, e)).astype(np.float32),
                 [{"region_id": f"r{i}"} for i in range(20)])
    jax_eng.load_database("w")
    port.load_database("w")
    assert port.warmup() == jax_eng.warmup() == "warmed: encoder, search"
    stats = port.searcher.stats()
    assert stats["served"] == 1 and stats["launches"] == 1
    for eng in (jax_eng, port):
        eng.searcher.close()


def test_batcher_over_ivf_index_matches_jax(tmp_path):
    """The searcher over the IVF adapter: coalesced answers equal the
    direct search (k padded to 8 and trimmed), and the JAX engine's."""
    root = str(tmp_path)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((400, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    from reverso_tpu_torch.store import VectorStore
    with VectorStore.create(root, "ivf", D) as s:
        s.append(emb, [{"region_id": f"r{i}"} for i in range(400)])
    jax_eng, port = engines(root, index="ivf", ivf_clusters=8, ivf_nprobe=8)
    jax_eng.load_database("ivf")
    port.load_database("ivf")
    want = port.search_batch(emb[:8], k=5)
    same(jax_eng.search_batch(emb[:8], k=5), want)
    got = {}
    barrier = threading.Barrier(8)

    def one(i):
        barrier.wait()
        got[i] = port.searcher.search(emb[i], k=5)

    _run_threads(one, 8)
    for i in range(8):
        same((want[0][i], want[1][i]), got[i])
    assert port._get_index().impl == "auto"
    port.searcher.close()
