"""The example-combine searches, JAX package vs PyTorch port, on the CPU.

The same seeded numpy rows and examples go through the JAX package's and
the port's `best_score_topk`, `discover_topk`, `context_topk` (fp32, bf16
and int8 databases, with row masks and `n_valid`), the `DeviceIndex`
methods that wrap them, `matrix_topk`, the composed-query helpers and the
numpy host twins. Ids must agree wherever the reference's ranked scores
are more than the tolerance apart (`tests/test_topk.py`'s tie-margin
rule); scores within 1e-5 on fp32 (and int8, dequantized in fp32) rows and
2e-3 on bf16 rows. The numpy twins are copies: equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.ops import recommend as jrec
from reverso_tpu.ops.topk import quantize_db_int8 as jax_quantize
from reverso_tpu.store import index as jindex
from reverso_tpu_torch.ops import recommend as trec
from reverso_tpu_torch.store import DeviceIndex

from test_torch_distance import assert_agree

TOL = {"float32": 1e-5, "bfloat16": 2e-3, "int8": 1e-5}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((8, 48)).astype(np.float32)
    x = cent[rng.integers(0, 8, 1500)] + 0.5 * rng.standard_normal((1500, 48)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x, rng.random(1500) < 0.6


def _db(x, dtype):
    """(JAX db, its scale, port db) holding the same rows."""
    if dtype == "int8":
        v8, scale = jax_quantize(jnp.asarray(x))
        v8 = np.array(v8)
        return v8, float(scale), torch.from_numpy(v8)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (jnp.asarray(x, jdt), None,
            torch.from_numpy(x).to({"float32": torch.float32,
                                    "bfloat16": torch.bfloat16}[dtype]))


CASES = {
    "best_score": (jrec.best_score_topk, trec.best_score_topk, [0, 5, 9, 100, 401], 3),
    "best_score_pos_only": (jrec.best_score_topk, trec.best_score_topk, [7, 8], 2),
    "discover": (jrec.discover_topk, trec.discover_topk, [2, 10, 11, 12, 40, 41, 42], 3),
    "discover_target_only": (jrec.discover_topk, trec.discover_topk, [2], 0),
    "context": (jrec.context_topk, trec.context_topk, [10, 11, 40, 41], 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("filtered", [False, True])
def test_combine_ops_match_jax(data, dtype, case, filtered):
    x, mask = data
    jfn, tfn, rows, n_static = CASES[case]
    ex = x[rows]
    jdb, scale, tdb = _db(x, dtype)
    kw = dict(n_valid=1400, row_mask=mask) if filtered else {}
    js, ji = jfn(jdb, jnp.asarray(ex), n_static, 12, db_scale=scale,
                 **{k: (jnp.asarray(v) if k == "row_mask" else v) for k, v in kw.items()})
    ts, ti = tfn(tdb, torch.from_numpy(ex), n_static, 12, db_scale=scale, **kw)
    assert ts.shape == (1, 12) and ti.dtype == torch.int32
    assert_agree(np.asarray(js), np.asarray(ji), ts, ti, TOL[dtype])
    if filtered:
        hits = ti.numpy()[ti.numpy() >= 0]
        assert mask[hits].all() and (hits < 1400).all()


def test_combine_semantics(data):
    """bp if bp > bn else -(bn * bn); discover's exact votes * 4 + sim;
    context's sum of min(0, s_pos - s_neg)."""
    x, _ = data
    db = torch.from_numpy(x)
    ex = torch.from_numpy(x[[0, 5, 9]])
    s = ex @ db.t()
    bp, bn = s[:2].amax(0), s[2]
    want = torch.where(bp > bn, bp, -(bn * bn))
    ts, ti = trec.best_score_topk(db, ex, 2, 5)
    assert torch.equal(ts[0], want[ti[0].long()])
    ex = torch.from_numpy(x[[1, 2, 3, 4, 5]])
    s = ex @ db.t()
    key = torch.where(s[1:3] > s[3:5], 1.0, -1.0).sum(0) * 4 + s[0]
    ts, ti = trec.discover_topk(db, ex, 2, 5)
    assert torch.equal(ts[0], key[ti[0].long()])
    ts, ti = trec.context_topk(db, ex[1:], 2, 5)
    assert (ts <= 0).all()


def test_combine_k_past_rows(data):
    x, _ = data
    ts, ti = trec.best_score_topk(torch.from_numpy(x[:4]), torch.from_numpy(x[:1]), 1, 7)
    assert (ti[0, 4:] == -1).all() and torch.isneginf(ts[0, 4:]).all()
    assert ti[0, 0] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_device_index_combines_match_jax(data, dtype):
    x, mask = data
    ref = jindex.DeviceIndex(x, dtype=dtype)
    ours = DeviceIndex(x, dtype=dtype, device="cpu")
    calls = [("best_score", (x[:3], x[3:5])), ("best_score", (x[:2],)),
             ("discover", (x[0], x[1:4], x[4:7])), ("discover", (x[0],)),
             ("context", (x[1:4], x[4:7]))]
    for name, args in calls:
        for m in (None, mask):
            js, ji = getattr(ref, name)(*args, k=8, row_mask=m)
            ts, ti = getattr(ours, name)(*args, k=8, row_mask=m)
            assert_agree(np.asarray(js), np.asarray(ji), ts, ti, TOL[dtype])
    with pytest.raises(ValueError, match="positive"):
        ours.best_score(np.zeros((0, 48), np.float32))
    with pytest.raises(ValueError, match="pairs must match"):
        ours.discover(x[0], x[1:3], x[3:4])
    with pytest.raises(ValueError, match="non-empty pairs"):
        ours.context(np.zeros((0, 48), np.float32), np.zeros((0, 48), np.float32))
    empty = DeviceIndex(np.zeros((0, 48), np.float32), dtype=dtype, device="cpu")
    s, i = empty.best_score(x[:1], k=3)
    assert (i == -1).all() and torch.isneginf(s).all()


@pytest.mark.parametrize("n_valid,limit", [(None, 6), (90, 6), (100, 140)])
def test_matrix_topk_matches_jax(data, n_valid, limit):
    x, _ = data
    v = x[:100]
    js, ji = jrec.matrix_topk(jnp.asarray(v), limit, n_valid=n_valid)
    ts, ti = trec.matrix_topk(torch.from_numpy(v), limit, n_valid=n_valid)
    assert ti.shape == (100, limit)
    assert_agree(np.asarray(js), np.asarray(ji), ts, ti, 1e-5)
    assert not (ti == torch.arange(100)[:, None]).any(), "a self-pair came back"
    if n_valid:
        assert (ti[n_valid:] == -1).all() and (ti[ti >= 0] < n_valid).all()


def test_composed_queries_equal_jax(data):
    x, _ = data
    for pos, neg in ((x[:3], x[3:5]), (x[0], None), (x[:2], np.zeros((0, 48), np.float32))):
        np.testing.assert_array_equal(trec.sum_scores_query(pos, neg),
                                      jrec.sum_scores_query(pos, neg))
        np.testing.assert_array_equal(trec.average_query(pos, neg),
                                      jrec.average_query(pos, neg))
    for fn in (trec.sum_scores_query, trec.average_query):
        with pytest.raises(ValueError, match="positive"):
            fn(np.zeros((0, 48), np.float32))


def test_host_twins_equal_jax(data):
    x, mask = data
    for m in (None, mask):
        for jfn, tfn, args in (
                (jrec.best_score_topk_host, trec.best_score_topk_host, (x[:3], x[3:5])),
                (jrec.best_score_topk_host, trec.best_score_topk_host, (x[:3], None)),
                (jrec.discover_topk_host, trec.discover_topk_host, (x[0], x[1:4], x[4:7])),
                (jrec.discover_topk_host, trec.discover_topk_host, (x[0], None, None)),
                (jrec.context_topk_host, trec.context_topk_host, (x[1:4], x[4:7]))):
            a, b = jfn(x, *args, 9, row_mask=m), tfn(x, *args, 9, row_mask=m)
            for u, w in zip(a, b):
                np.testing.assert_array_equal(u, w)
    s, i = trec._finalize_topk_host(np.array([0.5, 0.5, -np.inf], np.float32), 5, None)
    assert i.tolist() == [[0, 1, -1, -1, -1]]
