"""Filtered search through the engine, JAX package vs PyTorch port, on the CPU.

One seeded store with payloads ({"folder": i % 10, "confidence": u,
"filename": ...}) is searched through `reverso_tpu.Reverso` and
`reverso_tpu_torch.Reverso(device="cpu")` with the same queries: payload
filters as dicts and strings, `count(filter=)`, rows deleted with
`VectorStore.delete_vector_rows`, for the exact index in float32, int8 and
binary (candidates + exact rescore) and for IVF (bf16 and int8, spill and
balance). Ids must agree; each cell states its score tolerance.
"""
import dataclasses
import os

import numpy as np
import pytest

from reverso_tpu.config import SearchConfig as JaxSearchConfig
from reverso_tpu.config import StoreConfig as JaxStoreConfig
from reverso_tpu.config import default_config as jax_default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu_torch.config import SearchConfig, StoreConfig, default_config
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.store import VectorStore

N, D = 2400, 128


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("filtered"))
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((12, D)).astype(np.float32)
    x = cent[rng.integers(0, 12, N)] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    conf = rng.random(N)
    pays = [{"folder": i % 10, "confidence": float(conf[i]), "filename": f"{i}.jpg"}
            for i in range(N)]
    with VectorStore.create(root, "db", D) as s:
        for lo in range(0, N, 1000):
            s.append(x[lo:lo + 1000], pays[lo:lo + 1000])
    with VectorStore.create(root, "gone", D) as s:
        s.append(x, pays)
    with VectorStore.open(root, "gone", writable=True) as s:
        s.delete_vector_rows(list(range(0, N, 7)))
    q = x[[5, 17, 300, 1201, 2222]] + 0.05 * rng.standard_normal((5, D)).astype(np.float32)
    return root, q, conf


def _engines(root, dtype="float32", **search):
    jcfg = jax_default_config().replace(
        store=JaxStoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(JaxSearchConfig(), **search))
    tcfg = default_config().replace(
        store=StoreConfig(root_dir=root, dtype=dtype),
        search=dataclasses.replace(SearchConfig(), **search))
    return JaxReverso(jcfg), Reverso(tcfg, device="cpu")


FILTERS = [None, {"folder": 3}, "confidence>=0.5",
           {"must": [{"key": "folder", "match": {"any": [1, 2]}},
                     {"key": "confidence", "range": {"lt": 0.7}}]}]
# (store dtype, search config, score tolerance): fp32 sums in another
# order; int8 two-digit combine rounded twice in the port and once (FMA)
# by XLA's CPU compiler (see test_torch_capacity.py); binary and IVF's
# exact rescore / fp32 probe scores
CELLS = [("float32", {}, 1e-6), ("int8", {}, 3e-5), ("binary", {}, 1e-6),
         ("bfloat16", dict(index="ivf", ivf_clusters=16, ivf_nprobe=4), 1e-6),
         ("int8", dict(index="ivf", ivf_clusters=16, ivf_nprobe=4, ivf_spill=0.1,
                       ivf_balance=2.0), 3e-5)]


@pytest.mark.parametrize("dtype,search,tol", CELLS)
@pytest.mark.parametrize("db", ["db", "gone"])
def test_filtered_search_matches_jax(store_root, dtype, search, tol, db):
    root, q, conf = store_root
    jax_eng, port = _engines(root, dtype, **search)
    assert "Loaded" in jax_eng.load_database(db) and "Loaded" in port.load_database(db)
    gone = np.zeros(N, bool)
    if db == "gone":
        gone[::7] = True
    for filt in FILTERS:
        js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 10, filter=filt))
        ts, ti = port.search_batch(q, 10, filter=filt)
        np.testing.assert_array_equal(ti, ji)
        fin = np.isfinite(js)
        np.testing.assert_allclose(ts[fin], js[fin], atol=tol)
        hits = ti[ti >= 0]
        assert not gone[hits].any(), "a deleted vector came back"
        if filt == "confidence>=0.5":
            assert (conf[hits] >= 0.5).all()
        if filt == {"folder": 3}:
            assert (hits % 10 == 3).all()
    jt, jitems = jax_eng.search_similar(0.0, 5, embeddings=q, query_index=2,
                                        filter={"folder": 3})
    tt, titems = port.search_similar(0.0, 5, embeddings=q, query_index=2,
                                     filter={"folder": 3})
    assert [it["id"] for it in titems] == [it["id"] for it in jitems]
    assert all(it["payload"]["folder"] == 3 for it in titems)
    for filt in FILTERS[1:]:
        assert port.count(filter=filt) == jax_eng.count(filter=filt)
    assert port.count() == N


def test_ivf_cache_is_shared_between_packages(store_root):
    """The port reloads the cache the JAX engine wrote under
    <db>/index/ (same file name), and gives the same ids."""
    root, q, _ = store_root
    search = dict(index="ivf", ivf_clusters=16, ivf_nprobe=4)
    jax_eng, port = _engines(root, "float32", **search)
    jax_eng.load_database("db")
    js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 10))
    cache = os.path.join(root, "db", "index")
    files = sorted(os.listdir(cache))
    assert any(f.startswith("ivf_c16_2400_") for f in files), files
    stamp = {f: os.path.getmtime(os.path.join(cache, f)) for f in files}
    port.load_database("db")
    ts, ti = port.search_batch(q, 10)
    np.testing.assert_array_equal(ti, ji)
    assert {f: os.path.getmtime(os.path.join(cache, f))
            for f in os.listdir(cache)} == stamp, "the port rebuilt the cache"


def test_pq_store_searches_through_ivf(store_root):
    """store.dtype="pq" with index="ivf": both packages coerce the IVF's
    cells to bf16 and search, with the same ids."""
    root, q, _ = store_root
    search = dict(index="ivf", ivf_clusters=16, ivf_nprobe=4)
    jax_eng, port = _engines(root, "pq", **search)
    jax_eng.load_database("db")
    port.load_database("db")
    js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 10))
    ts, ti = port.search_batch(q, 10)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], atol=1e-6)


def test_unported_paths_name_their_slice(store_root, monkeypatch):
    """What this test once held as raising now runs: the engines on a mesh
    (the JAX engine on its 8 CPU devices, the port's on 8 CPU shards) give
    the same filtered searches, exact and IVF, and the device builds from
    the store's rows (`IVFIndex.from_chunks`, `BinaryIndex.from_chunks`)
    and a sharded `IVFIndex(mesh=)` search like the JAX package's."""
    import jax.numpy as jnp
    import torch

    from reverso_tpu.parallel import make_mesh as jax_make_mesh
    from reverso_tpu.store.index import BinaryIndex as JBinary
    from reverso_tpu.store.ivf import IVFIndex as JIVF
    from reverso_tpu_torch.config import MeshConfig
    from reverso_tpu_torch.parallel import make_mesh, sharding
    from reverso_tpu_torch.store import BinaryIndex, IVFIndex

    root, q, _ = store_root
    monkeypatch.setattr(sharding, "local_devices", lambda: [torch.device("cpu")] * 8)
    for dtype, search, tol in (CELLS[0], CELLS[3]):
        jcfg = jax_default_config().replace(
            store=JaxStoreConfig(root_dir=root, dtype=dtype),
            search=dataclasses.replace(JaxSearchConfig(), **search))
        tcfg = default_config().replace(
            store=StoreConfig(root_dir=root, dtype=dtype),
            search=dataclasses.replace(SearchConfig(), **search))
        jax_eng = JaxReverso(jcfg, use_mesh=True)
        port = Reverso(tcfg, use_mesh=True, device="cpu")
        assert port.mesh.shape == dict(jax_eng.mesh.shape) == {"data": 8, "model": 1}
        assert "Loaded" in jax_eng.load_database("db") and "Loaded" in port.load_database("db")
        for filt in FILTERS[:2]:
            js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 10, filter=filt))
            ts, ti = port.search_batch(q, 10, filter=filt)
            np.testing.assert_array_equal(ti, ji)
            fin = np.isfinite(js)
            np.testing.assert_allclose(ts[fin], js[fin], atol=tol)
    x = np.asarray(VectorStore.open(root, "db").vectors())
    emb = jnp.asarray(x)
    jivf = JIVF.from_chunks(lambda lo, rows: emb[lo:lo + rows], N, D, chunk=512,
                            n_clusters=16, dtype="int8", seed=0)
    ivf = IVFIndex.from_chunks(lambda lo, rows: torch.from_numpy(x[lo:lo + rows]), N, D,
                               chunk=512, n_clusters=16, dtype="int8", seed=0, device="cpu")
    jrows = np.asarray(jivf.row_ids)
    # the JAX layout's gap rows (-1) align its clusters to 8 rows
    np.testing.assert_array_equal(ivf.row_ids.numpy(), jrows[jrows >= 0])
    np.testing.assert_array_equal(ivf.search(q, 10, nprobe=4)[1].numpy(),
                                  np.asarray(jivf.search(q, 10, nprobe=4)[1]))
    sharded = IVFIndex(x, n_clusters=16, dtype="float32",
                       mesh=make_mesh(MeshConfig(), devices=["cpu"] * 8))
    np.testing.assert_array_equal(
        sharded.search(q, 10, nprobe=4)[1].numpy(),
        np.asarray(JIVF(x, n_clusters=16, dtype="float32", mesh=jax_make_mesh())
                   .search(q, 10, nprobe=4)[1]))
    binary = BinaryIndex.from_chunks(lambda lo, rows: torch.from_numpy(x[lo:lo + rows]), N, D,
                                     chunk=512, device="cpu")
    jbin = JBinary.from_chunks(lambda lo, rows: emb[lo:lo + rows], N, D, chunk=512,
                               center=binary.center)
    np.testing.assert_array_equal(binary.search(q, 10)[1].numpy(),
                                  np.asarray(jbin.search(q, 10)[1]))


def _copied_engines(store_root, tmp_path):
    """Each package on its own copy of the "db" store (same versions)."""
    import shutil

    root = store_root[0]
    roots = [str(tmp_path / side) for side in ("jax", "port")]
    for r in roots:
        shutil.copytree(os.path.join(root, "db"), os.path.join(r, "db"))
    jax_eng, _ = _engines(roots[0])
    _, port = _engines(roots[1])
    assert "Loaded" in jax_eng.load_database("db") and "Loaded" in port.load_database("db")
    return jax_eng, port


def test_update_vectors_matches_jax(store_root, tmp_path):
    _, q, _ = store_root
    jax_eng, port = _copied_engines(store_root, tmp_path)
    new = q[:2] * 2.0
    assert port.update_vectors([1, 2], new) == jax_eng.update_vectors([1, 2], new) \
        == "✅ Updated vectors of 2 points in db"
    js, ji = (np.asarray(a) for a in jax_eng.search_batch(q[:2], 10, filter={"folder": 1}))
    ts, ti = port.search_batch(q[:2], 10, filter={"folder": 1})
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-6)
    assert ti[0, 0] == 1


def test_delete_vectors_matches_jax(store_root, tmp_path):
    _, q, _ = store_root
    jax_eng, port = _copied_engines(store_root, tmp_path)
    top = port.search_batch(q, 10)[1]
    gone = sorted(set(top[:, :3].ravel().tolist()))
    assert port.delete_vectors(gone) == jax_eng.delete_vectors(gone) == \
        f"✅ Deleted vectors ('') of {len(gone)} points in db"
    for filt in FILTERS:
        js, ji = (np.asarray(a) for a in jax_eng.search_batch(q, 10, filter=filt))
        ts, ti = port.search_batch(q, 10, filter=filt)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts[np.isfinite(js)], js[np.isfinite(js)], atol=1e-6)
        assert not set(ti.ravel().tolist()) & set(gone)


def test_search_similar_use_batcher_matches_jax(store_root):
    root, q, _ = store_root
    jax_eng, port = _engines(root)
    jax_eng.load_database("db")
    port.load_database("db")
    jt, jitems = jax_eng.search_similar(0.0, 10, embeddings=q, query_index=3,
                                        use_batcher=True)
    tt, titems = port.search_similar(0.0, 10, embeddings=q, query_index=3,
                                     use_batcher=True)
    assert [it["id"] for it in titems] == [it["id"] for it in jitems]
    np.testing.assert_allclose([it["score"] for it in titems],
                               [it["score"] for it in jitems], atol=1e-6)
    assert port.searcher.stats()["served"] == 1
    port.searcher.close()
    jax_eng.searcher.close()
