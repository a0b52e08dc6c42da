"""MaxSim over multivector spaces, JAX package vs PyTorch port, on the CPU.

The same seeded ragged sub-vector matrices (points with 0 to 6 sub-vectors)
and query batches (ragged Tq, single vectors) go through the JAX package's
and the port's `maxsim_topk`, `MultiVecIndex` and both engines on a store
with a multivector space that the JAX package writes. Ids must agree
under the tie-margin rule of `tests/test_topk.py`; scores within 1e-5 on
fp32 sub-vectors and 2e-3 on bf16 ones. The host helpers (`seg_ids_of`,
`_query_batch`, `maxsim_score_rows`) are copies: equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.config import StoreConfig as JaxStoreConfig
from reverso_tpu.config import default_config as jax_default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.ops import multivec as jmv
from reverso_tpu.store import VectorStore as JaxVectorStore
from reverso_tpu.store import index as jindex
from reverso_tpu_torch.config import StoreConfig, default_config
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.ops import multivec as tmv
from reverso_tpu_torch.store import MultiVecIndex

from test_torch_distance import assert_agree

TOL = {"float32": 1e-5, "bfloat16": 2e-3}
D = 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 7, 400)
    counts[[3, 50]] = 0
    indptr = np.cumsum(counts)
    subs = rng.standard_normal((int(indptr[-1]), D)).astype(np.float32)
    subs /= np.linalg.norm(subs, axis=1, keepdims=True)
    queries = [subs[10:13] + 0.1 * rng.standard_normal((3, D)).astype(np.float32),
               rng.standard_normal(D).astype(np.float32),
               rng.standard_normal((5, D)).astype(np.float32),
               np.zeros((2, D), np.float32)]
    return subs, indptr, queries, rng.random(400) < 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [7, 450])
def test_maxsim_topk_matches_jax(data, dtype, masked, k):
    subs, indptr, queries, mask = data
    m = mask if masked else None
    jdt = {"float32": np.float32, "bfloat16": "bfloat16"}[dtype]
    js, ji = jmv.maxsim_topk(jnp.asarray(subs, jdt), indptr, queries, k, row_mask=m)
    tsub = torch.from_numpy(subs).to(getattr(torch, dtype))
    ts, ti = tmv.maxsim_topk(tsub, indptr, queries, k, row_mask=m, chunk=300)
    assert ts.shape == (4, k) and ti.dtype == torch.int32
    assert_agree(np.asarray(js), np.asarray(ji), ts, ti, TOL[dtype])
    ids = ti.numpy()
    assert not np.isin(ids, [3, 50]).any(), "a point with no sub-vectors matched"
    if masked:
        assert mask[ids[ids >= 0]].all()
    # the all-zero query scores exactly 0 on every point with sub-vectors
    assert (ts[3][ti[3] >= 0] == 0).all()


def test_maxsim_semantics(data):
    """score = sum_t max_m <q_t, p_m>; zero pad rows of a shorter query add
    exactly 0 (its scores equal the unpadded query's)."""
    subs, indptr, queries, _ = data
    tsub = torch.from_numpy(subs)
    s1, i1 = tmv.maxsim_topk(tsub, indptr, [queries[0]], 5)
    s2, i2 = tmv.maxsim_topk(tsub, indptr, [queries[0], queries[2]], 5)
    assert torch.equal(s1[0], s2[0]) and torch.equal(i1[0], i2[0])
    rows = [subs[(indptr[r - 1] if r else 0):indptr[r]] for r in range(len(indptr))]
    want = tmv.maxsim_score_rows([rows[j] for j in i1[0].tolist()], queries[0])
    np.testing.assert_allclose(s1[0].numpy(), want, atol=1e-5)
    s, i = tmv.maxsim_topk(tsub[:0], indptr[:0], queries, 3)
    assert (i == -1).all() and torch.isneginf(s).all()


def test_host_helpers_equal_jax(data):
    subs, indptr, queries, _ = data
    np.testing.assert_array_equal(tmv.seg_ids_of(indptr), jmv.seg_ids_of(indptr))
    np.testing.assert_array_equal(tmv._query_batch(queries, D), jmv._query_batch(queries, D))
    rows = [subs[:3], None, np.zeros((0, D), np.float32), subs[5:6]]
    for q in (queries[0], queries[1]):
        np.testing.assert_array_equal(tmv.maxsim_score_rows(rows, q),
                                      jmv.maxsim_score_rows(rows, q))
    with pytest.raises(ValueError, match="query must be"):
        tmv._query_batch([np.zeros((2, 5), np.float32)], D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_multivec_index_matches_jax(data, dtype, monkeypatch):
    subs, indptr, queries, mask = data
    ref = jindex.MultiVecIndex(subs, indptr, dtype=dtype)
    ours = MultiVecIndex(subs, indptr, dtype=dtype, device="cpu")
    assert ours.matrix.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert ours._seg_ids.device.type == "cpu" and ours.n_valid == 400
    tol = TOL["float32" if dtype == "float32" else "bfloat16"]
    for q in (queries, queries[0], np.stack([queries[0], queries[0] * 2])):
        for m in (None, mask):
            js, ji = ref.search(q, 6, row_mask=m)
            ts, ti = ours.search(q, 6, row_mask=m)
            assert isinstance(ts, np.ndarray)
            assert_agree(js, ji, ts, ti, tol)
    # the query batch chunked under a tiny block bound (one query a chunk,
    # each padded to its own Tq: sums in another order)
    ws, wi = ours.search(queries, 6)
    monkeypatch.setattr(MultiVecIndex, "_BLOCK_BYTES", 1)
    cs, ci = ours.search(queries, 6)
    np.testing.assert_array_equal(ci, wi)
    np.testing.assert_allclose(cs, ws, atol=1e-6)
    s, i = ours.search([], 4)
    assert s.shape == (0, 4) and i.shape == (0, 4)


@pytest.fixture(scope="module")
def multi_store(tmp_path_factory, data):
    subs, indptr, _, _ = data
    root = str(tmp_path_factory.mktemp("multivec"))
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((400, 16)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    rows = [subs[(indptr[r - 1] if r else 0):indptr[r]] for r in range(400)]
    with JaxVectorStore.create(root, "mv", 16, multi={"regions": D}) as s:
        s.append(dense, [{"folder": i % 5} for i in range(400)],
                 multi_vectors={"regions": rows})
    return root


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "binary", "pq"])
def test_engine_multivec_space_matches_jax(multi_store, data, dtype):
    """`search_batch(using=...)` on a multivector space of a store the JAX
    package wrote: binary, pq and int8 store the MaxSim matrix as bf16 in
    both packages; [Q, Tq, d] queries and a payload filter."""
    _, _, queries, _ = data
    jax_eng = JaxReverso(jax_default_config().replace(
        store=JaxStoreConfig(root_dir=multi_store, dtype=dtype)))
    port = Reverso(default_config().replace(
        store=StoreConfig(root_dir=multi_store, dtype=dtype)), device="cpu")
    jax_eng.load_database("mv")
    port.load_database("mv")
    q = np.stack([queries[0], queries[0][::-1], queries[2][:3]])
    for filt in (None, {"folder": 2}):
        js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 8, filter=filt, using="regions"))
        ts, ti = port.search_batch(q, 8, filter=filt, using="regions")
        assert_agree(js, ji, ts, ti, TOL["float32" if dtype == "float32" else "bfloat16"])
        if filt:
            assert (ti[ti >= 0] % 5 == 2).all()
    index = port._get_index("regions")
    assert isinstance(index, MultiVecIndex)
    assert index.matrix.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    # the dense space beside it still searches through the exact index
    assert port.search_batch(np.ones((1, 16), np.float32), 3)[1].shape == (1, 3)
