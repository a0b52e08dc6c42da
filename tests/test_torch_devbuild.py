"""The device builds, JAX package vs PyTorch port, on the CPU.

`IVFIndex.from_device` (rows already on the device; with and without a
mesh, int8, spill, balance), `IVFIndex.from_chunks` (a corpus made window
by window), `IVFIndex.load_cache_device` and `BinaryIndex.from_chunks`.
Within the port each build equals the host constructor, or
`from_device`, bit for bit (tables, centroids, stored rows, searches), as
tests/test_ivf.py and tests/test_binary.py pin them in the JAX package;
each is also held against the JAX package's build: search ids equal
wherever the JAX scores clear their neighbours by the tie margin, scores
within 1e-6 (3e-5 int8, whose two-digit combine the JAX CPU compiler
contracts into an FMA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.parallel import make_mesh as jax_make_mesh
from reverso_tpu.store.index import BinaryIndex as JBinary
from reverso_tpu.store.ivf import IVFIndex as JIVF
from reverso_tpu_torch.config import MeshConfig
from reverso_tpu_torch.parallel import make_mesh
from reverso_tpu_torch.store import BinaryIndex, IVFIndex

from test_torch_mesh import agree, same
from test_topk import random_unit

K = 10


@pytest.fixture(scope="module")
def corpus():
    """tests/test_ivf.py's clustered corpus: 32 centres x 250 rows, d = 64."""
    rng = np.random.default_rng(0)
    centers = random_unit(rng, 32, 64)
    rows = []
    for c in centers:
        pts = c[None] + 0.15 * rng.standard_normal((250, 64)).astype(np.float32)
        rows.append(pts / np.linalg.norm(pts, axis=1, keepdims=True))
    db = np.concatenate(rows)
    return db[rng.permutation(len(db))].astype(np.float32)


@pytest.fixture(scope="module")
def queries(corpus):
    rng = np.random.default_rng(7)
    return corpus[rng.choice(len(corpus), 12, replace=False)] + 0.01


def _equal_tables(a, b):
    for name in ("centroids", "row_ids", "offsets", "counts"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.n_spill, a.cmax, a.n_clusters, a.db_scale) == (b.n_spill, b.cmax, b.n_clusters,
                                                             b.db_scale)


def _rows(index) -> torch.Tensor:
    m = index.matrix
    return torch.cat(m.parts) if index.mesh is not None else m


BUILDS = [("bfloat16", 0.0, 0.0), ("int8", 0.2, 0.0), ("float32", 0.0, 2.0),
          ("int8", 0.1, 2.0)]


@pytest.mark.parametrize("dtype,spill,balance", BUILDS)
@pytest.mark.parametrize("sharded", [False, True])
def test_from_device_equals_host_build_and_jax(corpus, queries, dtype, spill, balance,
                                               sharded):
    """from_device on the rows as a tensor == the host constructor on the
    same values and seed; over a mesh of 8 CPU shards too, its rows cut
    into contiguous shards; searches held against the JAX package's
    from_device."""
    kw = dict(n_clusters=32, dtype=dtype, seed=0, spill=spill, balance=balance)
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 8) if sharded else None
    host = IVFIndex(corpus, device="cpu", **kw)
    dev = IVFIndex.from_device(torch.from_numpy(corpus), mesh=mesh, **kw)
    _equal_tables(host, dev)
    assert torch.equal(host.matrix, _rows(dev))
    assert (dev.mesh is not None) == sharded
    jdev = JIVF.from_device(jnp.asarray(corpus), **kw)
    assert jdev.n_spill == host.n_spill and jdev.n_clusters == host.n_clusters
    for nprobe in (4, 32):
        s = dev.search(queries, K, nprobe=nprobe)
        same(host.search(queries, K, nprobe=nprobe), s)
        agree(jdev.search(queries, K, nprobe=nprobe), s, 3e-5 if dtype == "int8" else 1e-6)


@pytest.mark.parametrize("dtype,spill", [("int8", 0.0), ("int8", 0.1), ("float32", 0.0),
                                         ("bfloat16", 0.1)])
def test_from_chunks_equals_from_device_and_jax(corpus, queries, dtype, spill):
    """from_chunks over 1,024-row windows == from_device on the same rows:
    tables, stored rows and searches bit for bit (tests/test_ivf.py's
    pin); searches against the JAX package's from_chunks."""
    n, d = corpus.shape
    kw = dict(n_clusters=16, dtype=dtype, seed=3, spill=spill)
    a = IVFIndex.from_device(torch.from_numpy(corpus), **kw)
    b = IVFIndex.from_chunks(lambda lo, rows: torch.from_numpy(corpus[lo:lo + rows]), n, d,
                             chunk=1024, device="cpu", **kw)
    _equal_tables(a, b)
    assert torch.equal(a.matrix, b.matrix)
    emb = jnp.asarray(corpus)
    jb = JIVF.from_chunks(lambda lo, rows: emb[lo:lo + rows], n, d, chunk=1024, **kw)
    for nprobe in (4, 16):
        s = b.search(queries, 8, nprobe=nprobe)
        same(a.search(queries, 8, nprobe=nprobe), s)
        assert torch.equal(s[0], a.search(queries, 8, nprobe=nprobe)[0])
        agree(jb.search(queries, 8, nprobe=nprobe), s, 3e-5 if dtype == "int8" else 1e-6)


def test_from_chunks_takes_any_chunk_and_shards():
    """Any `chunk` works: windows of 262,144 + 5,000 rows, where an
    assignment step (262,144 rows) straddles two windows. The JAX
    package's from_chunks requires chunk <= 262,144 or a multiple of it
    (its step reads one window; reverso_tpu/store/ivf.py:697-718): a
    divergence of the port. The build equals from_device, also over a
    mesh of 8 CPU shards."""
    rng = np.random.default_rng(5)
    n, d = 280_000, 8
    x = random_unit(rng, n, d)
    kw = dict(n_clusters=8, dtype="int8", seed=1, train_sample=4096, train_iters=2)
    calls = []

    def chunk_fn(lo, rows):
        calls.append((lo, rows))
        return torch.from_numpy(x[lo:lo + rows])

    a = IVFIndex.from_device(torch.from_numpy(x), **kw)
    b = IVFIndex.from_chunks(chunk_fn, n, d, chunk=262_144 + 5_000, device="cpu", **kw)
    assert {rows for _, rows in calls} == {267_144, n - 267_144}
    _equal_tables(a, b)
    assert torch.equal(a.matrix, b.matrix)
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 8)
    c = IVFIndex.from_chunks(chunk_fn, n, d, chunk=100_000, mesh=mesh, **kw)
    assert torch.equal(a.matrix, _rows(c))
    q = x[:4] + 0.01
    same(a.search(q, K, nprobe=3), c.search(q, K, nprobe=3))


def test_load_cache_device_round_trip(tmp_path, corpus, queries):
    """save_cache of a host build -> load_cache_device from the rows as a
    tensor (and over a mesh) gives the same index; a cache of another
    shape gives None; the JAX package's load_cache_device agrees."""
    path = str(tmp_path / "ivf.npz")
    host = IVFIndex(corpus, n_clusters=16, dtype="int8", seed=0, spill=0.1, device="cpu")
    host.save_cache(path)
    emb = torch.from_numpy(corpus)
    dev = IVFIndex.load_cache_device(emb, path, dtype="int8")
    _equal_tables(host, dev)
    assert torch.equal(host.matrix, dev.matrix)
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 8)
    sharded = IVFIndex.load_cache_device(emb, path, dtype="int8", mesh=mesh)
    j = JIVF.load_cache_device(jnp.asarray(corpus), path, dtype="int8")
    s = sharded.search(queries, K, nprobe=8)
    same(host.search(queries, K, nprobe=8), s)
    agree(j.search(queries, K, nprobe=8), s, 3e-5)
    assert IVFIndex.load_cache_device(emb[:100], path) is None


@pytest.mark.parametrize("sharded", [False, True])
def test_binary_from_chunks_equals_host_build_and_jax(sharded):
    """BinaryIndex.from_chunks == the host constructor at a shared centre,
    bit for bit, with the same searches (tests/test_binary.py's pin); the
    centre it computes tracks the host's float64 mean; over a mesh its
    shards hold the same bits; searches against the JAX package's
    from_chunks."""
    rng = np.random.default_rng(7)
    n, d = 5000, 256
    v = rng.standard_normal((n, d)).astype(np.float32) + 0.05
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    host = BinaryIndex(v, device="cpu")
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 8) if sharded else None

    def chunk_fn(lo, rows):
        return torch.from_numpy(v[lo:lo + rows])

    dev = BinaryIndex.from_chunks(chunk_fn, n, d, chunk=1024, center=host.center, mesh=mesh,
                                  device="cpu")
    rows = torch.cat(dev.matrix.parts) if sharded else dev.matrix
    assert torch.equal(rows, host.matrix)
    auto = BinaryIndex.from_chunks(chunk_fn, n, d, chunk=1024, device="cpu")
    np.testing.assert_allclose(auto.center, host.center, atol=1e-5)
    q = v[:8]
    same(host.search(q, K), dev.search(q, K))
    assert torch.equal(host.search(q, K)[0], dev.search(q, K)[0])
    jmesh = jax_make_mesh() if sharded else None
    j = JBinary.from_chunks(lambda lo, rows: jnp.asarray(v[lo:lo + rows]), n, d, chunk=1024,
                            center=host.center, mesh=jmesh)
    agree(j.search(q, K), dev.search(q, K), 1e-6)
