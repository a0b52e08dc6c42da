"""The port's two-stage int8 top-k (K12's path, at op level) against the JAX
package's `ops/topk_int8.py`.

The quantizers divide, as the JAX package does, and agree bit for bit.
Stage 1 (the kernel's plain version) is held against the JAX kernel in
interpret mode under the tie-margin rule: equal scores within 1e-6 and
equal ids wherever the JAX scores are clear of their neighbours (the
stage-1 dots are exact s32 sums in both, so in practice bit for bit).
The final results are held against the JAX function at the shapes of
tests/test_topk_int8.py, with recall >= 0.95 against exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from reverso_tpu.ops import topk_int8 as jtk
from reverso_tpu_torch.ops import topk_int8 as ttk


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _exact_topk(db, qs, k):
    s = qs.astype(np.float64) @ db.astype(np.float64).T
    order = np.lexsort((np.broadcast_to(np.arange(len(db)), s.shape), -s), axis=1)[:, :k]
    return np.take_along_axis(s, order, axis=1), order


def topk_agree(ref_s, ref_i, s, i, tol):
    """Equal -inf slots holding -1, scores within `tol`, ids equal where
    the reference's ranked scores are more than `tol` from both
    neighbours."""
    fin = np.isfinite(ref_s)
    np.testing.assert_array_equal(fin, np.isfinite(s))
    assert (i[~fin] == -1).all() and (ref_i[~fin] == -1).all()
    assert np.abs(np.where(fin, ref_s, 0) - np.where(fin, s, 0)).max() <= tol
    r = np.where(fin, ref_s, -1e9)
    pad = np.full((r.shape[0], 1), np.inf)
    gap = -np.diff(r, axis=1)
    clear = (np.concatenate([pad, gap], 1) > tol) & (np.concatenate([gap, pad], 1) > tol)
    np.testing.assert_array_equal(np.where(clear, i, -2), np.where(clear, ref_i, -2))


def test_quantize_rows_bit_for_bit():
    """quantize_rows: `v / scales` with the scale floored at 1e-12 after
    the division by 127; a zero row and a tiny row included."""
    rng = np.random.default_rng(0)
    v = _unit(rng, 500, 96) * rng.uniform(1e-3, 30, (500, 1)).astype(np.float32)
    v[7] = 0.0
    v[8] *= 1e-12
    j8, js = jtk.quantize_rows(v)
    t8, ts = ttk.quantize_rows(v)
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts[7] == np.float32(1e-12)
    back = t8.float().numpy() * ts.numpy()[:, None]
    assert np.abs(back - v).max() <= np.abs(v).max() / 127


def _jax_query_digits(qs):
    qf = jnp.asarray(qs, jnp.float32)
    qsc = jnp.maximum(jnp.max(jnp.abs(qf), axis=1), 1e-12) / 127.0
    q8 = jnp.clip(jnp.round(qf / qsc[:, None]), -127, 127).astype(jnp.int8)
    return q8, qsc


@pytest.mark.parametrize("n,d,q,k,n_valid,db_tile", [
    (3000, 128, 16, 40, None, 256),
    (999, 64, 5, 32, 700, 128),       # n_valid inside a tile
    (300, 200, 9, 128, 100, 128),     # k_fetch at the cap, k > n_valid
    (12, 32, 2, 80, None, 128),       # k > n
])
def test_stage1_matches_jax(n, d, q, k, n_valid, db_tile):
    """The stage-1 plain version against `_topk_int8_jit(interpret=True)`:
    the same query quantization bit for bit, then candidates under the
    tie-margin rule; duplicate rows tie to the lower id."""
    rng = np.random.default_rng(n + d)
    db = _unit(rng, n, d)
    db[n // 2] = db[1]
    qs = np.concatenate([db[1:2], _unit(rng, q - 1, d)])
    j8, js = jtk.quantize_rows(db)
    qj8, qjs = _jax_query_digits(qs)
    qt8, qts = ttk.quantize_queries(torch.from_numpy(qs))
    np.testing.assert_array_equal(qt8.numpy(), np.asarray(qj8))
    np.testing.assert_array_equal(qts.numpy(), np.asarray(qjs))
    nv = n if n_valid is None else n_valid
    rs, ri = map(np.asarray, jtk._topk_int8_jit(
        jnp.asarray(j8), jnp.asarray(js), qj8, qjs, nv, k=k, kpad=-(-k // 8) * 8,
        q_tile=-(-q // 8) * 8, db_tile=db_tile, interpret=True, q_out=q, n_bufs=4))
    t8, ts = ttk.quantize_rows(db)
    s, i = ttk.topk_int8_rows(t8, ts, qt8, qts, k, n_valid=n_valid)
    assert s.shape == (q, k) and i.dtype == torch.int32
    topk_agree(rs, ri, s.numpy(), i.numpy(), 1e-6)
    assert (i.numpy() < nv).all()
    if nv > n // 2:
        assert i[0, :2].tolist() == [1, n // 2]
    assert (i[:, min(k, nv):] == -1).all()


@pytest.mark.parametrize("n,d,q,k", [(3000, 128, 16, 10), (999, 64, 5, 8)])
def test_cosine_topk_int8_matches_jax(n, d, q, k):
    """The two-stage search at tests/test_topk_int8.py's shapes: the JAX
    package's ids, exact fp32 scores of the returned ids, recall@k >= 0.95
    against exact, the self-neighbour first."""
    rng = np.random.default_rng(n)
    db = _unit(rng, n, d)
    qs = db[rng.choice(n, q, replace=False)] + 0.01 * _unit(rng, q, d)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    j8, js = jtk.quantize_rows(db)
    rs, ri = map(np.asarray, jtk.cosine_topk_int8(
        jnp.asarray(j8), jnp.asarray(js), jnp.asarray(db), jnp.asarray(qs), k,
        db_tile=256))
    t8, ts = ttk.quantize_rows(db)
    s, i = ttk.cosine_topk_int8(t8, ts, torch.from_numpy(db), torch.from_numpy(qs), k)
    s, i = s.numpy(), i.numpy()
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, atol=1e-6)
    true_s, true_i = _exact_topk(db, qs, k)
    rec = np.mean([len(set(i[r]) & set(true_i[r])) / k for r in range(q)])
    assert rec >= 0.95, rec
    got = np.take_along_axis(qs.astype(np.float64) @ db.astype(np.float64).T,
                             np.clip(i, 0, n - 1), axis=1)
    np.testing.assert_allclose(s, got, atol=1e-5)
    assert (i[:, 0] == true_i[:, 0]).all()


def test_k_greater_than_n_and_n_valid():
    rng = np.random.default_rng(12)
    db = _unit(rng, 12, 32)
    j8, js = jtk.quantize_rows(db)
    rs, ri = map(np.asarray, jtk.cosine_topk_int8(
        jnp.asarray(j8), jnp.asarray(js), jnp.asarray(db), jnp.asarray(db[:2]), 20,
        db_tile=128))
    t8, ts = ttk.quantize_rows(db)
    s, i = ttk.cosine_topk_int8(t8, ts, torch.from_numpy(db), torch.from_numpy(db[:2]), 20)
    assert i.shape == (2, 20) and (i[:, 12:] == -1).all()
    assert torch.isneginf(s[:, 12:]).all()
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_allclose(s.numpy()[:, :12], rs[:, :12], atol=1e-6)
    # n_valid: rows past it never come back
    s, i = ttk.cosine_topk_int8(t8, ts, torch.from_numpy(db), torch.from_numpy(db[:3]), 5,
                                n_valid=6)
    rs, ri = map(np.asarray, jtk.cosine_topk_int8(
        jnp.asarray(j8), jnp.asarray(js), jnp.asarray(db), jnp.asarray(db[:3]), 5,
        n_valid=6, db_tile=128))
    np.testing.assert_array_equal(i.numpy(), ri)
    assert (i.numpy() < 6).all() and i[0, 0] == 0


def test_results_do_not_depend_on_query_chunks(monkeypatch):
    """Queries go to stage 1 in chunks of Q_RESIDENT; the results are
    those of one chunk, and a 1-d query is one row."""
    rng = np.random.default_rng(3)
    db = torch.from_numpy(_unit(rng, 700, 48))
    qs = torch.from_numpy(_unit(rng, 11, 48))
    v8, sc = ttk.quantize_rows(db)
    s1, i1 = ttk.cosine_topk_int8(v8, sc, db, qs, 7, overfetch=3)
    monkeypatch.setattr(ttk, "Q_RESIDENT", 4)
    s2, i2 = ttk.cosine_topk_int8(v8, sc, db, qs, 7, overfetch=3)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)
    s3, i3 = ttk.cosine_topk_int8(v8, sc, db, qs[5], 7, overfetch=3)
    assert torch.equal(i3[0], i1[5]) and torch.equal(s3[0], s1[5])
    with pytest.raises(ValueError, match="k <= 128"):
        ttk.topk_int8_rows(v8, sc, *ttk.quantize_queries(qs), 129)
