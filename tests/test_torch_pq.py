"""Product quantization, JAX package vs PyTorch port, on the CPU.

* `train_pq` starts from the JAX package's sample and initial centroids
  bit for bit (the same `np.random.default_rng(seed)` draws), and its
  codebooks stay within 1e-4 of the JAX package's after five iterations;
* with the JAX package's codebooks (from its cache file), the port's codes
  equal the JAX package's except on near-ties (two centroids within 1e-5
  of the same distance), which the test counts;
* the proxy scores `bf16(q) . bf16(decode(codes))` agree within 1e-4 and
  the ids under the tie-margin rule; recall@10 after the exact rescore
  (oversampling 3) is within 0.01 of the JAX package's;
* caches (`codebooks`, `codes`, `m`, `n` in an `.npz`) written by either
  package serve the other, prefix caches extend by encoding the tail, and
  both engines search a `store.dtype="pq"` store with the same ids.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from reverso_tpu.config import SearchConfig as JaxSearchConfig
from reverso_tpu.config import StoreConfig as JaxStoreConfig
from reverso_tpu.config import default_config as jax_default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.engine import _BinaryRescoreAdapter as JaxRescore
from reverso_tpu.ops import pq as jpq
from reverso_tpu.store import VectorStore as JaxVectorStore
from reverso_tpu.store import index as jindex
from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
from reverso_tpu_torch.engine import Reverso, _BinaryRescoreAdapter
from reverso_tpu_torch.ops import pq as tpq
from reverso_tpu_torch.store import PQIndex
from reverso_tpu_torch.store.index import default_pq_m

from test_torch_distance import assert_agree

D = 64


def _clustered(rng, n, d=D, n_cent=40):
    cent = rng.standard_normal((n_cent, d)).astype(np.float32)
    x = cent[rng.integers(0, n_cent, n)] + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = _clustered(rng, 3000)
    q = x[rng.choice(3000, 16, replace=False)] + 0.05 * rng.standard_normal((16, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q.astype(np.float32), rng.random(3000) < 0.5


@pytest.fixture(scope="module")
def jax_codebooks(data):
    x, _, _ = data
    return np.array(jpq.train_pq(x, 8, iters=5, sample=2048, seed=3))


def _capture_jax_start(monkeypatch):
    seen = {}
    step = jpq._pq_kmeans_step

    def capture(data, cent):
        seen.setdefault("data", np.asarray(data))
        seen.setdefault("init", np.asarray(cent))
        return step(data, cent)

    monkeypatch.setattr(jpq, "_pq_kmeans_step", capture)
    return seen


@pytest.mark.parametrize("n,sample,m", [(3000, 2048, 8), (3000, 100, 16), (900, 65536, 4)])
def test_train_sample_and_init_bit_equal(data, monkeypatch, n, sample, m):
    x, _, _ = data
    seen = _capture_jax_start(monkeypatch)
    jpq.train_pq(x[:n], m, iters=1, sample=sample, seed=7)
    got, init = tpq.pq_sample(x[:n], m, sample=sample, seed=7)
    np.testing.assert_array_equal(got, seen["data"])
    np.testing.assert_array_equal(init, seen["init"])


def test_train_pq_close_to_jax_and_repeatable(data, jax_codebooks):
    x, _, _ = data
    a = tpq.train_pq(x, 8, iters=5, sample=2048, seed=3, device="cpu")
    b = tpq.train_pq(x, 8, iters=5, sample=2048, seed=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (8, 256, 8) and a.dtype == np.float32
    assert np.abs(a - jax_codebooks).max() <= 1e-4
    with pytest.raises(ValueError, match="must divide"):
        tpq.train_pq(x, 7, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tpq.train_pq(x[:0], 8, device="cpu")


def test_encode_decode_with_jax_codebooks(data, jax_codebooks, tmp_path):
    x, _, _ = data
    path = str(tmp_path / "jax_pq.npz")
    jindex.PQIndex(x, m=8, codebooks=jax_codebooks).save_cache(path)
    with np.load(path) as z:
        cb = z["codebooks"]
    ref = jpq.pq_encode(x, cb)
    ours = tpq.pq_encode(x, cb, device="cpu")
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    diff = np.argwhere(ours != ref)
    # each differing code is a near-tie: both centroids within 1e-5 of the
    # same squared distance
    sub = x.reshape(len(x), 8, 8).astype(np.float64)
    for r, j in diff:
        d_ours = ((sub[r, j] - cb[j, ours[r, j]]) ** 2).sum()
        d_ref = ((sub[r, j] - cb[j, ref[r, j]]) ** 2).sum()
        assert abs(d_ours - d_ref) <= 1e-5
    assert len(diff) <= ours.size // 1000, f"{len(diff)} near-tie codes"
    np.testing.assert_array_equal(tpq.pq_decode(ours, cb), jpq.pq_decode(ours, cb))
    assert tpq.pq_encode(x[:0], cb, device="cpu").shape == (0, 8)


@pytest.mark.parametrize("n_valid,masked,k", [(None, False, 10), (2500, True, 10),
                                              (None, False, 4000)])
def test_pq_topk_matches_jax(data, jax_codebooks, n_valid, masked, k):
    x, q, mask = data
    codes = jpq.pq_encode(x, jax_codebooks)
    m = mask if masked else None
    js, ji = jpq.pq_topk_xla(codes, jax_codebooks, q, k, D, n_valid=n_valid, row_mask=m)
    ts, ti = tpq.pq_topk(torch.from_numpy(codes), torch.from_numpy(jax_codebooks),
                         torch.from_numpy(q), k, n_valid=n_valid, row_mask=m, chunk=1000)
    assert ts.shape == (16, k) and ti.dtype == torch.int32
    assert_agree(np.asarray(js), np.asarray(ji), ts, ti, 1e-4)


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, truth)]))


def test_recall_after_rescore_close_to_jax(data):
    x, q, _ = data
    truth = np.argsort(-(q.astype(np.float64) @ x.T.astype(np.float64)), axis=1)[:, :10]
    jad = JaxRescore(jindex.PQIndex(x, iters=5), x, oversampling=3.0)
    tad = _BinaryRescoreAdapter(PQIndex(x, iters=5, device="cpu"), x, oversampling=3.0)
    r_jax = _recall(np.asarray(jad.search(q, 10)[1]), truth)
    r_ours = _recall(tad.search(q, 10)[1], truth)
    assert abs(r_ours - r_jax) <= 0.01, (r_ours, r_jax)


def test_pq_caches_are_shared_and_extend(data, tmp_path):
    x, q, _ = data
    jix = jindex.PQIndex(x[:2000], iters=3)
    jpath = str(tmp_path / "jax.npz")
    jix.save_cache(jpath)
    ours = PQIndex.load_cache(x[:2000], jpath, device="cpu")
    np.testing.assert_array_equal(ours.codebooks, jix.codebooks)
    np.testing.assert_array_equal(ours._host_codes, jix._host_codes)
    # a prefix cache extends by encoding the tail
    more = PQIndex.load_cache(x, jpath, device="cpu")
    assert more.n_valid == 3000
    np.testing.assert_array_equal(more._host_codes[:2000], jix._host_codes)
    np.testing.assert_array_equal(more._host_codes[2000:],
                                  tpq.pq_encode(x[2000:], jix.codebooks, device="cpu"))
    assert PQIndex.load_cache(x[:10], jpath, device="cpu") is None
    assert PQIndex.load_cache(x, jpath, m=16, device="cpu") is None
    assert PQIndex.load_cache(x, str(tmp_path / "missing.npz"), device="cpu") is None
    tpath = str(tmp_path / "port.npz")
    more.save_cache(tpath)
    back = jindex.PQIndex.load_cache(x, tpath)
    np.testing.assert_array_equal(back._host_codes, more._host_codes)
    js, ji = (np.asarray(a) for a in back.search(q, 10))
    ts, ti = more.search(q, 10)
    assert_agree(js, ji, ts, ti, 1e-4)


def test_pq_index_shapes_and_edges(data):
    x, q, _ = data
    assert [default_pq_m(d) for d in (0, 7, 8, 64, 100, 1024, 1025)] == \
        [jindex.default_pq_m(d) for d in (0, 7, 8, 64, 100, 1024, 1025)]
    ix = PQIndex(x[:300], iters=2, device="cpu")
    assert ix.m == 8 and ix.matrix.dtype == torch.uint8 and ix.matrix.shape == (300, 8)
    assert ix.nbytes == 300 * 8 + 8 * 256 * 8 * 4
    s, i = ix.search(q[0], 400)
    assert i.shape == (1, 400) and (i[0, 300:] == -1).all() and torch.isneginf(s[0, 300:]).all()
    empty = PQIndex(np.zeros((0, D), np.float32), device="cpu")
    s, i = empty.search(q, 3)
    assert (i == -1).all()
    with pytest.raises(ValueError, match="must divide"):
        PQIndex(x, m=7, device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        PQIndex(x[:10], m=8, codebooks=np.zeros((8, 256, 8), np.float32),
                codes=np.zeros((11, 8), np.uint8), device="cpu")


def _engines(root, **search):
    jcfg = jax_default_config().replace(
        store=JaxStoreConfig(root_dir=root, dtype="pq"),
        search=dataclasses.replace(JaxSearchConfig(), **search))
    tcfg = default_config().replace(
        store=StoreConfig(root_dir=root, dtype="pq"),
        search=dataclasses.replace(SearchConfig(), **search))
    return JaxReverso(jcfg), Reverso(tcfg, device="cpu")


@pytest.mark.parametrize("first", ["jax", "port"])
def test_engine_pq_store_matches_jax(data, tmp_path, first):
    """A store the JAX package wrote, searched with `store.dtype="pq"` by
    both engines: the first one trains and writes the cache, the other
    reloads it (no retraining: the file is untouched), and both give the
    same ids, with and without a payload filter; an append extends the
    cache and removes the stale one."""
    x, q, _ = data
    root = str(tmp_path)
    with JaxVectorStore.create(root, "db", D) as s:
        s.append(x[:2800], [{"folder": i % 3} for i in range(2800)])
    jax_eng, port = _engines(root, pq_oversampling=3.0)
    engines = [jax_eng, port] if first == "jax" else [port, jax_eng]
    results = []
    for eng in engines:
        assert "Loaded" in eng.load_database("db")
        results.append([tuple(np.asarray(a) for a in eng.search_batch(q, 10, filter=f))
                        for f in (None, {"folder": 2})])
        if eng is engines[0]:
            cache_dir = os.path.join(root, "db", "index")
            files = sorted(os.listdir(cache_dir))
            assert len(files) == 1 and files[0].startswith("pq_m8_2800_"), files
            stamp = os.path.getmtime(os.path.join(cache_dir, files[0]))
    assert os.path.getmtime(os.path.join(cache_dir, files[0])) == stamp
    for (s0, i0), (s1, i1) in zip(*results):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(s0, s1, atol=1e-6)
    assert (results[0][1][1] % 3 == 2).all()
    with JaxVectorStore.open(root, "db", writable=True) as s:
        s.append(x[2800:], [{"folder": i % 3} for i in range(200)])
    port.load_database("db")
    with np.load(os.path.join(cache_dir, files[0])) as z:
        cb = z["codebooks"].copy()
    port.search_batch(q, 10)
    files = sorted(os.listdir(cache_dir))
    assert len(files) == 1 and files[0].startswith("pq_m8_3000_"), files
    with np.load(os.path.join(cache_dir, files[0])) as z:
        np.testing.assert_array_equal(z["codebooks"], cb)
        assert len(z["codes"]) == 3000
