"""The port's IVF index against the JAX package's, on the CPU.

Seeded clustered data (16 well-separated centers on the unit sphere plus
noise, d = 128) built by both packages. The port lays clusters out
compactly where the JAX package aligns their starts to 8 rows, and keeps
the same (-score, probe rank, position within the cluster) candidate
order, so ids must agree. The caches `<db>/index/ivf_*.npz` are read and
written in one format: a cache written by either package loads in the
other. The port's probed scan runs its plain version here
(`ivf_probe_scan_ref`); tests/test_torch_cuda.py holds the CUDA kernel
against it on the card.
"""
import numpy as np
import pytest

from reverso_tpu.store.ivf import IVFIndex as JaxIVF
from reverso_tpu_torch.store.ivf import IVFIndex

D, C = 128, 16


def _clustered(seed, n, d=D, c=C, noise=0.15):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    x = cent[rng.integers(0, c, n)] + noise * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(n, 24, replace=False)] + 0.05 * rng.standard_normal((24, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def _ids_agree(jres, tres, dtype):
    """ids equal; scores within 1e-6 (fp32 sums in another order), or for
    int8 within 3e-5: XLA's CPU compiler contracts the two-digit combine
    into one FMA where the TPU and the port round twice, and the digits'
    own resolution is 1 / (127 * 254) (see test_torch_capacity.py)."""
    js, ji = (np.asarray(a) for a in jres)
    ts, ti = (a.numpy() for a in tres)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(fin, np.isfinite(ts))
    np.testing.assert_allclose(ts[fin], js[fin], atol=3e-5 if dtype == "int8" else 1e-6)


CELLS = [("float32", 0.0, 0.0), ("int8", 0.0, 0.0), ("bfloat16", 0.0, 0.0),
         ("float32", 0.2, 1.5), ("int8", 0.1, 2.0)]


@pytest.mark.parametrize("dtype,spill,balance", CELLS)
def test_jax_cache_loads_in_the_port(tmp_path, dtype, spill, balance):
    x, q = _clustered(1, 3000)
    jix = JaxIVF(x, n_clusters=C, dtype=dtype, spill=spill, balance=balance)
    path = str(tmp_path / "ivf_c16_3000_0.npz")
    jix.save_cache(path)
    tix = IVFIndex.load_cache(x, path, dtype=dtype, device="cpu")
    assert tix.n_spill == jix.n_spill and tix.n_clusters == jix.n_clusters
    for nprobe, mask in ((4, None), (16, None), (4, np.arange(3000) % 3 != 0)):
        _ids_agree(jix.search(q, 10, nprobe=nprobe, row_mask=mask),
                   tix.search(q, 10, nprobe=nprobe, row_mask=mask), dtype)


@pytest.mark.parametrize("dtype,spill,balance", CELLS)
def test_port_cache_loads_in_jax(tmp_path, dtype, spill, balance):
    """A port-built index writes the JAX format; the JAX package reloads
    it and searches identically. The two builds agree row for row
    (k-means, assignment, balance splits and spill plans follow the same
    seeded draws) on these well-separated clusters."""
    x, q = _clustered(2, 3000)
    tix = IVFIndex(x, n_clusters=C, dtype=dtype, spill=spill, balance=balance,
                   device="cpu")
    path = str(tmp_path / "ivf.npz")
    tix.save_cache(path)
    jix = JaxIVF.load_cache(x, path, dtype=dtype)
    _ids_agree(jix.search(q, 10, nprobe=4), tix.search(q, 10, nprobe=4), dtype)
    fresh = JaxIVF(x, n_clusters=C, dtype=dtype, spill=spill, balance=balance)
    jrows = np.asarray(fresh.row_ids)
    jrows = jrows[jrows >= 0]
    jcl = np.repeat(np.arange(fresh.n_clusters), np.asarray(fresh.counts))
    tcl = np.repeat(np.arange(tix.n_clusters), tix.counts.numpy())
    # assignment agreement over the entries (each row's primary cluster)
    j_of = np.full(3000, -1)
    j_of[jrows[::-1]] = jcl[::-1]
    t_of = np.full(3000, -1)
    t_of[tix.row_ids.numpy()[::-1]] = tcl[::-1]
    assert (j_of == t_of).mean() >= 0.99


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extend_cache_matches_jax(tmp_path, dtype):
    x, q = _clustered(3, 3000)
    JaxIVF(x[:2400], n_clusters=C, dtype=dtype, spill=0.1).save_cache(
        str(tmp_path / "base.npz"))
    jix = JaxIVF.extend_cache(x, str(tmp_path / "base.npz"), dtype=dtype)
    tix = IVFIndex.extend_cache(x, str(tmp_path / "base.npz"), dtype=dtype, device="cpu")
    np.testing.assert_array_equal(tix.counts.numpy(), np.asarray(jix.counts))
    assert tix.n_spill == jix.n_spill
    _ids_agree(jix.search(q, 10, nprobe=4), tix.search(q, 10, nprobe=4), dtype)
    assert IVFIndex.extend_cache(x[:2400], str(tmp_path / "base.npz"), device="cpu") is None


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_all_probes_equal_the_exact_search(dtype):
    """nprobe = n_clusters scans every row once: the exact top-k over the
    stored rows (fp32: scores within 1e-6 of the exact scan; int8: the
    exact int8 scan of the same stored rows, bit for bit)."""
    from reverso_tpu_torch.ops.topk import cosine_topk_ref, cosine_topk_int8_ref
    import torch

    x, q = _clustered(4, 2000)
    tix = IVFIndex(x, n_clusters=C, dtype=dtype, device="cpu")
    s, i = tix.search(q, 10, nprobe=C)
    if dtype == "float32":
        rs, ri = cosine_topk_ref(torch.from_numpy(x), torch.from_numpy(q), 10)
        np.testing.assert_allclose(s.numpy(), rs.numpy(), atol=1e-6)
    else:
        # the stored int8 rows in original order
        v8 = torch.empty_like(tix.matrix)
        v8[tix.row_ids.long()] = tix.matrix
        rs, ri = cosine_topk_int8_ref(v8, tix.db_scale, torch.from_numpy(q), 10)
        np.testing.assert_array_equal(s.numpy(), rs.numpy())
    np.testing.assert_array_equal(i.numpy(), ri.numpy())


def test_spill_dedup_never_returns_an_id_twice():
    x, q = _clustered(5, 3000, noise=0.4)
    tix = IVFIndex(x, n_clusters=C, dtype="float32", spill=0.5, device="cpu")
    assert tix.n_spill > 0
    for k in (10, 60):
        s, i = tix.search(q, k, nprobe=8)
        for row in i.numpy():
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)


def test_masked_search_keeps_only_matching_rows():
    x, q = _clustered(6, 3000)
    tix = IVFIndex(x, n_clusters=C, dtype="bfloat16", spill=0.2, device="cpu")
    mask = np.random.default_rng(0).random(3000) < 0.3
    s, i = tix.search(q, 20, nprobe=16, row_mask=mask)
    ids = i.numpy()
    assert mask[ids[ids >= 0]].all()
    none = tix.search(q, 5, nprobe=16, row_mask=np.zeros(3000, bool))
    assert (none[1].numpy() == -1).all()
