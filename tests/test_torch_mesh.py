"""Sharded search over a mesh, JAX package vs PyTorch port, on the CPU.

The JAX package runs its sharded functions on its 8-device CPU mesh
(tests/conftest.py); the port runs its counterparts on a mesh of 8 CPU
shards (`make_mesh(devices=["cpu"] * 8)`: one device named eight times,
which a JAX mesh cannot do). The same seeded numpy inputs go through both:
the search checks of `__graft_entry__.py::_dryrun_sharded_search` (exact,
int8, IVF, masked, discovery, manhattan, binary, PQ, ragged MaxSim, the
tree merge on a 2 x 4 mesh; the hybrid engine is in test_torch_query.py)
and the IVF's uneven-rows and big-k case (tests/test_ivf.py), plus each
index's `mesh=`.

Tolerance: ids equal wherever the JAX result's scores clear their
neighbours by test_topk.py's tie margin (TOL); scores within the
tolerance of the single-device port test of the same op (1e-6 fp32 and
bf16 scans, 3e-5 int8: the JAX CPU compiler contracts the two-digit
combine into an FMA, 1e-5 MaxSim, 1e-4 Manhattan). The port's sharded
result equals its single-device result: ids exactly, scores within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.parallel import make_mesh as jax_make_mesh
from reverso_tpu_torch.config import MeshConfig
from reverso_tpu_torch.parallel import make_mesh, shard_rows
from reverso_tpu_torch.parallel.sharding import row_ranges

from test_topk import TOL, random_unit

K = 10


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(), make_mesh(MeshConfig(), devices=["cpu"] * 8)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clear(s, tol=TOL):
    """[Q, k] positions whose score clears both neighbours by tol."""
    s = np.asarray(s, np.float64)
    pad = np.full((s.shape[0], 1), np.inf)
    gap = np.abs(np.diff(s, axis=1))
    gap = np.where(np.isnan(gap), 0.0, gap)     # -inf - -inf
    return (np.concatenate([pad, gap], 1) > tol) & (np.concatenate([gap, pad], 1) > tol)


def agree(jax_out, port_out, tol):
    """The port's (scores, ids) against the JAX package's: ids by the tie
    margin, finite scores within tol, -inf exactly where JAX has it."""
    js, ji = map(_np, jax_out)
    ts, ti = map(_np, port_out)
    assert ts.shape == js.shape and ti.shape == ji.shape
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_allclose(ts[fin], js[fin], atol=tol)
    clear = _clear(js) & fin
    np.testing.assert_array_equal(np.where(clear, ti, -1), np.where(clear, ji, -1))


def same(single, sharded):
    """The port's sharded result against its single-device one."""
    s1, i1 = map(_np, single)
    s2, i2 = map(_np, sharded)
    np.testing.assert_array_equal(i2, i1)
    fin = np.isfinite(s1)
    np.testing.assert_array_equal(np.isfinite(s2), fin)
    np.testing.assert_allclose(s2[fin], s1[fin], atol=1e-6)


@pytest.fixture(scope="module")
def data():
    """1,029 unit rows (not a multiple of 8: the port's shards are
    uneven; the JAX package's rows are zero-padded to 1,032 and masked by
    n_valid), d = 128, 16 queries near stored rows."""
    rng = np.random.default_rng(1)
    n, d = 8 * 128 + 5, 128
    db = random_unit(rng, n, d)
    qs = db[rng.integers(0, n, 16)] + 0.05 * rng.standard_normal((16, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    mask = rng.random(n) < 0.3
    pad = -n % 8
    return dict(db=db, qs=qs, mask=mask, n=n, d=d,
                db_pad=np.concatenate([db, np.zeros((pad, d), np.float32)]),
                mask_pad=np.concatenate([mask, np.zeros(pad, bool)]))


def test_mesh_layout_and_errors(meshes):
    """make_mesh resolves MeshConfig as the JAX package does and raises
    on a size mismatch; shards are contiguous ceil(n / P) ranges, the last
    ones possibly empty; without a card the default mesh raises."""
    jmesh, pmesh = meshes
    assert pmesh.shape == dict(jmesh.shape)
    two = make_mesh(MeshConfig(axis_names=("host", "chip"), axis_sizes=(2, -1)),
                    devices=["cpu"] * 8)
    assert two.shape == {"host": 2, "chip": 4}
    with pytest.raises(ValueError):
        make_mesh(MeshConfig(axis_sizes=(3, 1)), devices=["cpu"] * 8)
    assert row_ranges(10, 8) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 10),
                                 (10, 10), (10, 10)]
    sh = shard_rows(np.arange(10.0)[:, None], pmesh)
    assert sh.starts == [0, 2, 4, 6, 8, 10, 10, 10] and sh.local_valid(9)[4] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no device"):
            make_mesh(MeshConfig())


def _exact(dt):
    def run(meshes, x):
        from reverso_tpu.ops.topk import sharded_cosine_topk as jfn
        from reverso_tpu_torch.ops.topk import cosine_topk, sharded_cosine_topk
        jmesh, pmesh = meshes
        jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
        j = jfn(jnp.asarray(x["db_pad"], jdt), jnp.asarray(x["qs"], jdt), K, jmesh,
                impl="xla", n_valid=x["n"])
        db = torch.from_numpy(x["db"]).to(dt)
        q = torch.from_numpy(x["qs"])
        return j, sharded_cosine_topk(db, q, K, pmesh), cosine_topk(db, q, K), 1e-6
    return run


def _int8(meshes, x):
    from reverso_tpu.ops.topk import quantize_db_int8 as jquant
    from reverso_tpu.ops.topk import sharded_cosine_topk as jfn
    from reverso_tpu_torch.ops.topk import cosine_topk_int8_exact, sharded_cosine_topk
    jmesh, pmesh = meshes
    # the same stored rows on both sides (the JAX package's jitted
    # quantizer multiplies by a folded reciprocal: a rare quantum apart)
    jv8, jscale = jquant(jnp.asarray(x["db_pad"]))
    j = jfn(jv8, jnp.asarray(x["qs"]), K, jmesh, n_valid=x["n"], db_scale=jscale)
    v8, scale = torch.from_numpy(np.array(jv8)[:x["n"]]), float(jscale)
    q = torch.from_numpy(x["qs"])
    return (j, sharded_cosine_topk(v8, q, K, pmesh, db_scale=scale),
            cosine_topk_int8_exact(v8, scale, q, K), 3e-5)


def _masked(meshes, x):
    from reverso_tpu.ops.topk import sharded_cosine_topk as jfn
    from reverso_tpu_torch.ops.topk import cosine_topk, sharded_cosine_topk
    jmesh, pmesh = meshes
    j = jfn(jnp.asarray(x["db_pad"]), jnp.asarray(x["qs"]), K, jmesh, impl="xla",
            n_valid=x["n"], row_mask=jnp.asarray(x["mask_pad"]))
    db, q = torch.from_numpy(x["db"]), torch.from_numpy(x["qs"])
    return (j, sharded_cosine_topk(db, q, K, pmesh, row_mask=x["mask"]),
            cosine_topk(db, q, K, row_mask=x["mask"]), 1e-6)


def _big_k(meshes, x):
    """k above the kernel cap (the plain scans on the card), masked."""
    from reverso_tpu.ops.topk import sharded_cosine_topk as jfn
    from reverso_tpu_torch.ops.topk import cosine_topk, sharded_cosine_topk
    jmesh, pmesh = meshes
    j = jfn(jnp.asarray(x["db_pad"]), jnp.asarray(x["qs"]), 150, jmesh, impl="xla",
            n_valid=x["n"], row_mask=jnp.asarray(x["mask_pad"]))
    db, q = torch.from_numpy(x["db"]), torch.from_numpy(x["qs"])
    return (j, sharded_cosine_topk(db, q, 150, pmesh, row_mask=x["mask"]),
            cosine_topk(db, q, 150, row_mask=x["mask"]), 1e-6)


def _discover(meshes, x):
    from reverso_tpu.ops.recommend import sharded_discover_topk as jfn
    from reverso_tpu_torch.ops.recommend import discover_topk, sharded_discover_topk
    jmesh, pmesh = meshes
    db, qs = x["db"], x["qs"]
    ex = np.concatenate([qs[:1], db[[3, 5, 9]], db[[4, 8, 2]]])      # target + 3 pairs
    j = jfn(jnp.asarray(x["db_pad"]), jnp.asarray(ex), 3, K, jmesh, n_valid=x["n"])
    t = torch.from_numpy(db)
    return (j, sharded_discover_topk(t, torch.from_numpy(ex), 3, K, pmesh),
            discover_topk(t, torch.from_numpy(ex), 3, K), 1e-6)


def _manhattan(meshes, x):
    from reverso_tpu.ops.l1 import sharded_manhattan_topk as jfn
    from reverso_tpu_torch.ops.l1 import manhattan_topk, sharded_manhattan_topk
    jmesh, pmesh = meshes
    j = jfn(jnp.asarray(x["db_pad"]), jnp.asarray(x["qs"]), K, jmesh, n_valid=x["n"])
    db, q = torch.from_numpy(x["db"]), torch.from_numpy(x["qs"])
    return (j, sharded_manhattan_topk(db, q, K, pmesh), manhattan_topk(db, q, K), 1e-4)


def _binary(meshes, x):
    from reverso_tpu.ops.binary import pack_signs as jpack
    from reverso_tpu.ops.binary import sharded_binary_topk as jfn
    from reverso_tpu_torch.ops.binary import binary_topk, pack_signs, sharded_binary_topk
    jmesh, pmesh = meshes
    d = x["d"]
    j = jfn(jnp.asarray(jpack(x["db_pad"])), jnp.asarray(x["qs"]), K, d, jmesh,
            n_valid=x["n"])
    packed = torch.from_numpy(pack_signs(x["db"]))
    q = torch.from_numpy(x["qs"])
    return (j, sharded_binary_topk(packed, q, K, d, pmesh), binary_topk(packed, q, K, d),
            1e-6)


def _pq(meshes, x):
    from reverso_tpu.ops.pq import pq_encode, sharded_pq_topk as jfn, train_pq
    from reverso_tpu_torch.ops.pq import pq_topk, sharded_pq_topk
    jmesh, pmesh = meshes
    d = x["d"]
    cb = train_pq(x["db"], d // 8, iters=4, seed=0)
    codes = pq_encode(x["db"], cb)
    codes_pad = np.concatenate([codes, np.zeros((len(x["db_pad"]) - len(codes), d // 8),
                                                np.uint8)])
    j = jfn(jnp.asarray(codes_pad), jnp.asarray(cb), jnp.asarray(x["qs"]), K, d, jmesh,
            n_valid=x["n"])
    c, q = torch.from_numpy(codes), torch.from_numpy(x["qs"])
    cbt = torch.from_numpy(cb)
    return j, sharded_pq_topk(c, cbt, q, K, d, pmesh), pq_topk(c, cbt, q, K), 1e-6


def _maxsim(meshes, x):
    """Ragged points (0-4 sub-vectors), a count the mesh does not divide."""
    from reverso_tpu.ops.multivec import shard_multivec_layout as jlayout
    from reverso_tpu.ops.multivec import sharded_maxsim_topk as jfn
    from reverso_tpu.parallel import shard_rows as jshard
    from reverso_tpu_torch.ops.multivec import (maxsim_topk, shard_multivec_layout,
                                                sharded_maxsim_topk)
    jmesh, pmesh = meshes
    rng = np.random.default_rng(2)
    d = x["d"]
    n_mv = 8 * 8 + 3
    rows = []
    for _ in range(n_mv):
        m = rng.standard_normal((int(rng.integers(0, 5)), d)).astype(np.float32)
        rows.append(m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-30))
    flat = np.concatenate([m for m in rows if len(m)])
    indptr = np.cumsum([len(m) for m in rows])
    qs = [rng.standard_normal((3, d)).astype(np.float32),
          rng.standard_normal((d,)).astype(np.float32)]
    subs_sh, seg_sh, local_rows = jlayout(flat, indptr, 8)
    j = jfn(jshard(jnp.asarray(subs_sh), jmesh), jshard(jnp.asarray(seg_sh), jmesh), qs, K,
            jmesh, n_rows=n_mv, local_rows=local_rows)
    layout = shard_multivec_layout(indptr, 8)
    parts = [torch.from_numpy(flat[a:b]) for (_, _, a, b, _) in layout]
    return (j, sharded_maxsim_topk(parts, layout, qs, K, pmesh),
            maxsim_topk(torch.from_numpy(flat), indptr, qs, K), 1e-5)


def _tree(meshes, x):
    from jax.sharding import Mesh as JMesh
    from reverso_tpu.ops.topk import tree_merge_topk as jfn
    from reverso_tpu_torch.ops.topk import cosine_topk, tree_merge_topk
    cfg = MeshConfig(axis_names=("host", "chip"), axis_sizes=(2, 4))
    jmesh = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("host", "chip"))
    pmesh = make_mesh(cfg, devices=["cpu"] * 8)
    j = jfn(jnp.asarray(x["db_pad"]), jnp.asarray(x["qs"]), K, jmesh, impl="xla",
            n_valid=x["n"])
    db, q = torch.from_numpy(x["db"]), torch.from_numpy(x["qs"])
    return j, tree_merge_topk(db, q, K, pmesh), cosine_topk(db, q, K), 1e-6


def _ivf(dtype, n_clusters, nprobe, spill=0.0):
    def run(meshes, x):
        from reverso_tpu.store.ivf import IVFIndex as JIVF
        from reverso_tpu_torch.store import IVFIndex
        jmesh, pmesh = meshes
        j = JIVF(x["db"], n_clusters=n_clusters, dtype=dtype, seed=0, spill=spill,
                 mesh=jmesh).search(x["qs"], K, nprobe=nprobe)
        kw = dict(n_clusters=n_clusters, dtype=dtype, seed=0, spill=spill)
        single = IVFIndex(x["db"], device="cpu", **kw)
        sharded = IVFIndex(x["db"], mesh=pmesh, **kw)
        assert [len(t) for t in sharded.matrix.parts] == [
            hi - lo for lo, hi in row_ranges(single.n_entries, 8)]
        return (j, sharded.search(x["qs"], K, nprobe=nprobe),
                single.search(x["qs"], K, nprobe=nprobe), 3e-5 if dtype == "int8" else 1e-6)
    return run


def _ivf_masked(meshes, x):
    from reverso_tpu.store.ivf import IVFIndex as JIVF
    from reverso_tpu_torch.store import IVFIndex
    jmesh, pmesh = meshes
    j = JIVF(x["db"], n_clusters=32, dtype="float32", seed=0, mesh=jmesh).search(
        x["qs"], K, nprobe=8, row_mask=x["mask"])
    single = IVFIndex(x["db"], n_clusters=32, dtype="float32", seed=0, device="cpu")
    sharded = IVFIndex(x["db"], n_clusters=32, dtype="float32", seed=0, mesh=pmesh)
    return (j, sharded.search(x["qs"], K, nprobe=8, row_mask=x["mask"]),
            single.search(x["qs"], K, nprobe=8, row_mask=x["mask"]), 1e-6)


def _ivf_uneven_big_k(meshes, x):
    """tests/test_ivf.py's case: 301 rows over 8 shards, k = 40 above any
    cluster, every cluster probed (= the exact scan)."""
    from reverso_tpu.store.ivf import IVFIndex as JIVF
    from reverso_tpu_torch.store import IVFIndex
    jmesh, pmesh = meshes
    rng = np.random.default_rng(4)
    db = random_unit(rng, 8 * 37 + 5, 32)
    qs = random_unit(rng, 4, 32)
    j = JIVF(db, n_clusters=12, dtype="float32", seed=1, mesh=jmesh).search(qs, 40, nprobe=12)
    single = IVFIndex(db, n_clusters=12, dtype="float32", seed=1, device="cpu")
    sharded = IVFIndex(db, n_clusters=12, dtype="float32", seed=1, mesh=pmesh)
    return j, sharded.search(qs, 40, nprobe=12), single.search(qs, 40, nprobe=12), 1e-6


CASES = {"exact_f32": _exact(torch.float32), "exact_bf16": _exact(torch.bfloat16),
         "int8": _int8, "ivf": _ivf("float32", 32, 8), "ivf_int8_spill": _ivf("int8", 32, 8, 0.1),
         "ivf_bf16_all_probes": _ivf("bfloat16", 16, 16), "ivf_masked": _ivf_masked,
         "ivf_uneven_big_k": _ivf_uneven_big_k, "masked": _masked, "big_k_masked": _big_k,
         "discover": _discover, "manhattan": _manhattan, "binary": _binary, "pq": _pq,
         "maxsim_ragged": _maxsim, "tree_merge_2x4": _tree}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_search_matches_jax_and_single(meshes, data, case):
    j, sharded, single, tol = CASES[case](meshes, data)
    agree(j, sharded, tol)
    same(single, sharded)


# -- the indexes' mesh= ----------------------------------------------------

def _index_pair(meshes, x, kind):
    """(JAX index on its mesh, port index on 8 CPU shards, port index on
    one device, query kwargs, score tolerance)."""
    from reverso_tpu.store import index as jidx
    from reverso_tpu_torch.store import index as pidx
    jmesh, pmesh = meshes
    db = x["db"]
    if kind.startswith("device_"):
        dtype, distance = kind.split("_")[1:]
        kw = dict(dtype=dtype, distance=distance)
        tol = {"int8": 3e-5, "manhattan": 1e-4}.get(dtype, {"manhattan": 1e-4}.get(distance, 1e-5))
        return (jidx.DeviceIndex(db, mesh=jmesh, db_tile=128, **kw),
                pidx.DeviceIndex(db, mesh=pmesh, **kw), pidx.DeviceIndex(db, device="cpu", **kw),
                tol)
    if kind == "binary":
        return (jidx.BinaryIndex(db, mesh=jmesh), pidx.BinaryIndex(db, mesh=pmesh),
                pidx.BinaryIndex(db, device="cpu"), 1e-6)
    if kind == "pq":
        return (jidx.PQIndex(db, mesh=jmesh, iters=4), pidx.PQIndex(db, mesh=pmesh, iters=4),
                pidx.PQIndex(db, iters=4, device="cpu"), 1e-6)
    raise KeyError(kind)


INDEXES = ["device_float32_cosine", "device_bfloat16_cosine", "device_int8_cosine",
           "device_float32_euclid", "device_bfloat16_manhattan", "binary", "pq"]


@pytest.mark.parametrize("kind", INDEXES)
def test_index_mesh_matches_jax_and_single(meshes, data, kind):
    """`mesh=` on each index: plain and filtered searches (and the
    example combines on the dot indexes) against the JAX package's index
    on its mesh and the port's on one device."""
    jax_index, sharded, single, tol = _index_pair(meshes, data, kind)
    assert sharded.mesh is not None and single.mesh is None
    # the JAX dot index's XLA scan (its Pallas kernel runs interpreted on
    # the CPU; the same results, at many times the time)
    xla = dict(impl="xla") if kind.startswith("device_") else {}
    for mask in (None, data["mask"]):
        j = jax_index.search(data["qs"], K, row_mask=mask, **xla)
        s = sharded.search(data["qs"], K, row_mask=mask)
        agree(j, s, tol)
        same(single.search(data["qs"], K, row_mask=mask), s)
    if kind.startswith("device_") and kind.endswith("cosine"):
        db = data["db"]
        for name, args in (("best_score", (db[:2], db[5:6])),
                           ("discover", (db[0], db[1:3], db[3:5])),
                           ("context", (db[1:3], db[3:5]))):
            j = getattr(jax_index, name)(*args, k=K)
            s = getattr(sharded, name)(*args, k=K)
            agree(j, s, tol)
            same(getattr(single, name)(*args, k=K), s)


def test_multivec_index_mesh_matches_jax_and_single(meshes):
    from reverso_tpu.store import MultiVecIndex as JMV
    from reverso_tpu_torch.store import MultiVecIndex
    jmesh, pmesh = meshes
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 5, 8 * 10 + 3)
    subs = random_unit(rng, int(counts.sum()), 32)
    indptr = np.cumsum(counts)
    qs = [subs[:3], subs[7]]
    mask = rng.random(len(indptr)) < 0.5
    sharded = MultiVecIndex(subs, indptr, dtype="float32", mesh=pmesh)
    single = MultiVecIndex(subs, indptr, dtype="float32", device="cpu")
    for m in (None, mask):
        j = JMV(subs, indptr, dtype="float32", mesh=jmesh).search(qs, K, row_mask=m)
        s = sharded.search(qs, K, row_mask=m)
        agree(j, s, 1e-5)
        same(single.search(qs, K, row_mask=m), s)


def test_one_device_mesh_takes_the_single_device_route(data):
    """A mesh of one device places the index on it, unsharded (the JAX
    package's `mesh.devices.size > 1` rule)."""
    from reverso_tpu_torch.store import DeviceIndex
    one = make_mesh(MeshConfig(), devices=["cpu"])
    idx = DeviceIndex(data["db"], mesh=one)
    assert idx.mesh is None and isinstance(idx.matrix, torch.Tensor)
    same(DeviceIndex(data["db"], device="cpu").search(data["qs"], K),
         idx.search(data["qs"], K))
