"""Euclid and manhattan stores and the host index, JAX package vs PyTorch
port, on the CPU.

The same seeded numpy rows (norms from 0.1 to 100) and queries go through
the JAX package's and the port's `DeviceIndex` (euclid through the
`[x, ||x||^2]` augmentation on the top-k scan, manhattan through the
chunked L1), the L1 ops, `HostIndex` (the same native scan: bit for bit),
and both engines on a store the JAX package writes and the port opens.
Ids must agree wherever the reference's ranked scores are more than the
tolerance apart (the tie-margin rule of `tests/test_topk.py`); scores
within 1e-5 (fp32 rows) or 2e-3 (bf16 rows) of the reference's, relative
to the score's magnitude where that exceeds 1.
"""
import dataclasses

import numpy as np
import pytest
import torch

from reverso_tpu.config import SearchConfig as JaxSearchConfig
from reverso_tpu.config import StoreConfig as JaxStoreConfig
from reverso_tpu.config import default_config as jax_default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.ops import l1 as jl1
from reverso_tpu.store import VectorStore as JaxVectorStore
from reverso_tpu.store import index as jindex
from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.ops import l1 as tl1
from reverso_tpu_torch.store import DeviceIndex, HostIndex, StoreError
from reverso_tpu_torch.store import index as tindex

TOL = {"float32": 1e-5, "bfloat16": 2e-3, "int8": 2e-3}


def _rows(rng, n, d):
    """Rows with norms spread log-uniformly over [0.1, 100]."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return (x * np.exp(rng.uniform(np.log(0.1), np.log(100.0), (n, 1)))).astype(np.float32)


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_agree(ref_s, ref_i, s, i, tol):
    """Equal -inf slots and ids -1 there; scores within tol * max(1, |ref|);
    equal ids wherever the reference's ranked scores are more than that
    apart on both sides."""
    ref_s, ref_i, s, i = (_host(a) for a in (ref_s, ref_i, s, i))
    fin = np.isfinite(ref_s)
    assert np.array_equal(fin, np.isfinite(s))
    assert (i[~fin] == -1).all()
    scale = np.maximum(1.0, np.abs(np.where(fin, ref_s, 0)))
    err = np.abs(np.where(fin, ref_s, 0) - np.where(fin, s, 0)) / scale
    assert err.max(initial=0) <= tol, err.max()
    r = np.where(fin, ref_s, -1e30)
    gap = tol * np.maximum(1.0, np.abs(r))
    pad = np.full((r.shape[0], 1), np.inf)
    up = np.concatenate([pad, -np.diff(r, axis=1)], axis=1)
    dn = np.concatenate([-np.diff(r, axis=1), pad], axis=1)
    clear = (up > gap) & (dn > gap)
    np.testing.assert_array_equal(np.where(clear, i, -2), np.where(clear, ref_i, -2))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    v = _rows(rng, 900, 24)
    q = _rows(rng, 6, 24)
    q[0] = v[11] + 0.01      # a near-duplicate of a stored row
    mask = rng.random(900) < 0.4
    return v, q, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("distance", ["euclid", "manhattan"])
@pytest.mark.parametrize("masked", [False, True])
def test_device_index_matches_jax(data, dtype, distance, masked):
    v, q, mask = data
    m = mask if masked else None
    ref = jindex.DeviceIndex(v, dtype=dtype, distance=distance)
    ours = DeviceIndex(v, dtype=dtype, distance=distance, device="cpu")
    # int8 is stored as bf16 under both distances
    assert ours.matrix.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert ours.dim == (25 if distance == "euclid" else 24)
    js, ji = ref.search(q, 9, row_mask=m)
    ts, ti = ours.search(q, 9, row_mask=m)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert_agree(js, ji, ts, ti, TOL[dtype])
    if masked:
        assert mask[_host(ti)[_host(ti) >= 0]].all()
    if distance == "euclid" or dtype == "float32":
        assert _host(ti)[0, 0] == 11 or masked


def test_euclid_k_past_rows_and_empty(data):
    v, q, _ = data
    s, i = DeviceIndex(v[:5], dtype="float32", distance="euclid", device="cpu").search(q, 8)
    assert (i[:, 5:] == -1).all() and torch.isneginf(s[:, 5:]).all()
    d = np.linalg.norm(v[:5][None].astype(np.float64) - q[:, None], axis=2)
    np.testing.assert_allclose(-_host(s)[:, :5], np.sort(d, axis=1), rtol=1e-5)
    s, i = DeviceIndex(np.zeros((0, 24), np.float32), distance="euclid",
                       device="cpu").search(q, 3)
    assert (i == -1).all() and torch.isneginf(s).all()


@pytest.mark.parametrize("n_valid,masked,k", [(None, False, 10), (700, True, 10),
                                              (None, False, 1200)])
def test_manhattan_topk_matches_jax(data, n_valid, masked, k):
    v, q, mask = data
    m = mask if masked else None
    js, ji = jl1.manhattan_topk_xla(v, q, k, n_valid=n_valid, row_mask=m)
    ts, ti = tl1.manhattan_topk(torch.from_numpy(v), torch.from_numpy(q), k,
                                n_valid=n_valid, row_mask=m, chunk=128)
    assert ti.shape == (6, k)
    assert_agree(np.asarray(js), np.asarray(ji), ts, ti, 1e-5)


def test_manhattan_host_equals_jax(data):
    v, q, mask = data
    for m in (None, mask):
        a = jl1.manhattan_topk_host(v, q, 7, row_mask=m, chunk=100)
        b = tl1.manhattan_topk_host(v, q, 7, row_mask=m, chunk=100)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    s, i = tl1.manhattan_topk_host(v[:3], q, 5)
    assert (i[:, 3:] == -1).all() and np.isneginf(s[:, 3:]).all()


@pytest.mark.parametrize("distance", ["cosine", "dot", "euclid", "manhattan"])
def test_host_index_bit_for_bit(data, distance):
    v, q, mask = data
    ref, ours = jindex.HostIndex(v, distance=distance), HostIndex(v, distance=distance)
    for m in (None, mask, np.zeros(900, bool)):
        js, ji = ref.search(q, 8, row_mask=m)
        ts, ti = ours.search(q, 8, row_mask=m)
        assert isinstance(ts, np.ndarray) and isinstance(ti, np.ndarray)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


def test_host_index_combine_searches_bit_for_bit(data):
    v, q, mask = data
    u = v / np.linalg.norm(v, axis=1, keepdims=True)
    ref, ours = jindex.HostIndex(u), HostIndex(u)
    calls = [("best_score", (u[:3], u[3:5])), ("best_score", (u[:2], None)),
             ("discover", (u[0], u[1:4], u[4:7])), ("discover", (u[0],)),
             ("context", (u[1:4], u[4:7]))]
    for name, args in calls:
        for m in (None, mask):
            a = getattr(ref, name)(*args, k=6, row_mask=m)
            b = getattr(ours, name)(*args, k=6, row_mask=m)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    for distance in ("euclid", "manhattan"):
        with pytest.raises(ValueError, match=distance):
            HostIndex(v, distance=distance).best_score(u[:1])


def _store(root, name, distance, v):
    with JaxVectorStore.create(root, name, v.shape[1], distance=distance) as s:
        s.append(v, [{"folder": i % 4, "filename": f"{i}.jpg"} for i in range(len(v))])


@pytest.fixture(scope="module")
def stores(tmp_path_factory, data):
    v, q, _ = data
    root = str(tmp_path_factory.mktemp("distance"))
    for distance in ("euclid", "manhattan", "cosine"):
        _store(root, distance, distance, v)
    return root


def _engines(root, dtype="float32", **search):
    jcfg = jax_default_config().replace(
        store=JaxStoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(JaxSearchConfig(), **search))
    tcfg = default_config().replace(
        store=StoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(SearchConfig(), **search))
    return JaxReverso(jcfg), Reverso(tcfg, device="cpu")


@pytest.mark.parametrize("db", ["euclid", "manhattan"])
@pytest.mark.parametrize("dtype,search", [("float32", {}), ("bfloat16", {}),
                                          ("int8", {}), ("float32", dict(index="host")),
                                          ("float32", dict(index="ivf", ivf_clusters=4))])
def test_engine_distance_store_matches_jax(stores, data, db, dtype, search):
    """A store the JAX package wrote with distance=euclid/manhattan opens in
    the port and searches through `Reverso` as the JAX engine does, with and
    without a payload filter; IVF falls through to the exact index."""
    v, q, _ = data
    jax_eng, port = _engines(stores, dtype, **search)
    assert "Loaded" in jax_eng.load_database(db) and "Loaded" in port.load_database(db)
    tol = TOL[dtype]
    for filt in ({"folder": 1}, None):
        js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 7, filter=filt))
        ts, ti = port.search_batch(q, 7, filter=filt)
        assert isinstance(ts, np.ndarray)
        assert_agree(js, ji, ts, ti, tol)
        if filt:
            assert (ti[ti >= 0] % 4 == 1).all()
    index = port._get_index()
    want = HostIndex if search.get("index") == "host" else DeviceIndex
    assert isinstance(index, want)
    text, items = port.search_similar(-1e9, 3, embeddings=q, query_index=0)
    assert [it["id"] for it in items] == ti[0, :3].tolist()


def test_engine_host_index_cosine_matches_jax(stores, data):
    v, q, mask = data
    jax_eng, port = _engines(stores, "float32", index="host")
    jax_eng.load_database("cosine")
    port.load_database("cosine")
    for filt in (None, {"folder": 2}):
        js, ji = jax_eng.search_batch(q, 5, filter=filt)
        ts, ti = port.search_batch(q, 5, filter=filt)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("dtype,what", [("binary", "binary quantization"),
                                        ("pq", "product quantization")])
def test_engine_quantized_distance_stores_raise(stores, data, dtype, what):
    v, q, _ = data
    for db in ("euclid", "manhattan"):
        _, port = _engines(stores, dtype)
        port.load_database(db)
        with pytest.raises(StoreError, match=f"{what}.*{db}"):
            port.search_batch(q, 3)


def test_combine_searches_refuse_distance_indexes(data):
    v, q, _ = data
    for distance in ("euclid", "manhattan"):
        ix = tindex.DeviceIndex(v, distance=distance, device="cpu")
        with pytest.raises(ValueError, match=distance):
            ix.best_score(q[:2])
        with pytest.raises(ValueError, match=distance):
            ix.context(q[:1], q[1:2])


@pytest.mark.parametrize("dtype,width", [("float32", 24), ("bfloat16", 24), ("int8", 32)])
@pytest.mark.parametrize("distance", ["cosine", "dot", "euclid", "manhattan"])
def test_device_index_rows_take_a_16_byte_pitch(data, dtype, width, distance):
    """At d = 21 (no 16-byte row in any dtype) the matrix is zero-padded
    past `dim` to a multiple of 16 bytes, whatever the distance (euclid's
    d + 1 = 22 too; euclid and manhattan hold int8 as bf16), and the
    searches and example combines answer as the JAX package's unpadded
    index does."""
    v, q, mask = data
    v, q = v[:, :21], q[:, :21]
    if distance == "cosine":
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    ref = jindex.DeviceIndex(v, dtype=dtype, distance=distance)
    ours = DeviceIndex(v, dtype=dtype, distance=distance, device="cpu")
    dim = 22 if distance == "euclid" else 21
    if distance in ("euclid", "manhattan") and dtype == "int8":
        width = 24
    assert ours.dim == dim and tuple(ours.matrix.shape) == (900, width)
    assert ours.matrix.shape[1] * ours.matrix.element_size() % 16 == 0
    assert not ours.matrix[:, dim:].any()
    with pytest.raises(ValueError, match="d = 21"):
        ours.search(q[:, :20], 3)      # a query of another width is refused, not padded
    for m in (None, mask):
        assert_agree(*ref.search(q, 9, row_mask=m), *ours.search(q, 9, row_mask=m), TOL[dtype])
    if distance in ("cosine", "dot"):
        for call in (lambda ix: ix.best_score(q[:3], q[3:5], 7),
                     lambda ix: ix.discover(q[0], q[1:3], q[3:5], 7),
                     lambda ix: ix.context(q[1:3], q[3:5], 7, row_mask=mask)):
            assert_agree(*call(ref), *call(ours), TOL[dtype])
