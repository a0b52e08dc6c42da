"""Parity of the PyTorch port's ops with the JAX package's.

Each test makes its inputs with numpy from a seed and feeds the same
arrays to the JAX function (Pallas kernels in interpret mode on the CPU)
and to the port's function, which on CPU tensors runs its plain version.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from reverso_tpu.ops import attention as jattn
from reverso_tpu.ops import deformable as jdeform
from reverso_tpu.ops import fused_mlp as jmlp
from reverso_tpu.ops import rope as jrope
from reverso_tpu.ops import topk as jtopk
from reverso_tpu_torch import kernels
from reverso_tpu_torch.ops import attention as tattn
from reverso_tpu_torch.ops import deformable as tdeform
from reverso_tpu_torch.ops.fused_mlp import fused_mlp, mlp_ref
from reverso_tpu_torch.ops import norm as tnorm
from reverso_tpu_torch.ops import rope as trope
from reverso_tpu_torch.ops import topk as ttopk
from test_topk import assert_topk_equiv, random_unit


def test_rope_tables_and_rotation_match_jax():
    for grid, hd, cls in ((6, 16, True), (4, 8, False)):
        jc, js = jrope.rope_2d_tables(grid, hd, cls_token=cls)
        tc, ts = trope.rope_2d_tables(grid, hd, cls_token=cls)
        np.testing.assert_array_equal(jc, tc)
        np.testing.assert_array_equal(js, ts)
    cos, sin = trope.rope_2d_tables(6, 16)
    x = np.random.default_rng(0).standard_normal((2, 3, 37, 16)).astype(np.float32)
    ref = np.asarray(jrope.apply_rope_2d(jnp.asarray(x), cos, sin))
    out = trope.apply_rope_2d(torch.from_numpy(x), cos, sin).numpy()
    # same fp32 ops elementwise: agree to rounding
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_l2_normalize():
    x = np.random.default_rng(1).standard_normal((5, 33)).astype(np.float32)
    x[2] = 0.0
    out = tnorm.l2_normalize(torch.from_numpy(x)).numpy()
    ref = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(out, ref, atol=1e-7)
    assert tnorm.l2_normalize(torch.ones(2, 4, dtype=torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("use_rope", [True, False])
@pytest.mark.parametrize("kv_valid", [None, 23])
def test_flash_heads_ref_matches_jax(use_rope, kv_valid):
    """S = 37 (not a multiple of 8), W = 64, 4 heads of 16, fp32."""
    rng = np.random.default_rng(2)
    b, s, w, heads = 2, 37, 64, 4
    q, k, v = (rng.standard_normal((b, s, w)).astype(np.float32) for _ in range(3))
    cos, sin = trope.rope_2d_tables(6, w // heads) if use_rope else (None, None)
    ref = np.asarray(jattn.flash_attention_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=heads, cos=cos,
        sin=sin, kv_valid=kv_valid, interpret=True))
    out = tattn.flash_attention_heads(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        heads=heads, cos=cos, sin=sin, kv_valid=kv_valid).numpy()
    # fp32 on both sides; sums in another order
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-4)


def test_attention_ref_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 4, 19, 16)).astype(np.float32) for _ in range(3))
    for kv_valid in (None, 11):
        ref = np.asarray(jattn.attention_xla(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), kv_valid=kv_valid))
        out = tattn.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), kv_valid=kv_valid).numpy()
        np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("sq,skv,kv_valid", [(19, 19, None), (19, 19, 11), (23, 13, 9)])
def test_flash_attention_matches_jax(sq, skv, kv_valid):
    """K7's entry on CPU tensors (its plain version) against the JAX
    whole-sequence Pallas kernel in interpret mode and attention_xla."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, skv, 16)).astype(np.float32) for _ in range(2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = np.asarray(jattn.flash_attention(jq, jk, jv, kv_valid=kv_valid, interpret=True))
    xla = np.asarray(jattn.attention_xla(jq, jk, jv, kv_valid=kv_valid))
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), kv_valid=kv_valid).numpy()
    # fp32 on both sides; sums in another order
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(out, xla, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("sq,kv_valid", [(64, None), (40, 50)])
def test_flash_attention_rel_bias_matches_jax(sq, kv_valid):
    """K6's entry with SAM's decomposed rel-pos bias on CPU tensors against
    the JAX tiled Pallas kernel in interpret mode; Sq = 40 is not a
    multiple of the tile and kv_valid = 50 masks keys of the 8 x 8 grid."""
    rng = np.random.default_rng(8)
    b, h, g, d = 2, 3, 8, 16
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, g * g, d)).astype(np.float32) for _ in range(2))
    bh, bw = ((rng.standard_normal((b, h, sq, g)) * 0.3).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), kv_valid=kv_valid,
        rel_bias=(jnp.asarray(bh), jnp.asarray(bw), g), interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v, bh, bw)]
    out = tattn.flash_attention(*t[:3], kv_valid=kv_valid,
                                rel_bias=(t[3], t[4], g)).numpy()
    # fp32 on both sides; the TPU kernel adds the bias through a selector
    # matmul at HIGHEST precision: sums in another order
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_ms_deform_attn_ref_matches_jax(seed):
    """K8's entry on CPU tensors (its plain version) against the JAX
    patch-gather reference and the Pallas hat-matrix kernel in interpret
    mode: four levels with widths that are not multiples of 8, sampling
    points outside the map on every side."""
    rng = np.random.default_rng(seed)
    shapes = ((9, 13), (5, 7), (3, 4), (2, 2))
    lv = sum(hl * wl for hl, wl in shapes)
    value = rng.standard_normal((2, lv, 4, 8)).astype(np.float32)
    locs = rng.uniform(-0.3, 1.3, (2, 11, 4, 4, 4, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 11, 4, 4, 4)).astype(np.float32)
    w /= w.sum(axis=(-2, -1), keepdims=True)
    jv, jl, jw = jnp.asarray(value), jnp.asarray(locs), jnp.asarray(w)
    patch = np.asarray(jdeform.ms_deform_attn(jv, shapes, jl, jw, impl="patch"))
    pallas = np.asarray(jdeform.ms_deform_attn_pallas(jv, shapes, jl, jw, q_tile=8,
                                                      interpret=True))
    out = tdeform.ms_deform_attn(torch.from_numpy(value), shapes,
                                 torch.from_numpy(locs), torch.from_numpy(w)).numpy()
    assert out.shape == (2, 11, 32)
    # fp32 on both sides: the same gathers (patch), or dense hat products
    # in another order (Pallas)
    np.testing.assert_allclose(out, patch, atol=1e-6)
    np.testing.assert_allclose(out, pallas, atol=2e-6)


@pytest.mark.parametrize("d,heads,n_points", [(7, 3, 4), (5, 2, 3)])
def test_ms_deform_attn_ref_clustered_odd_head_dim_matches_jax(d, heads, n_points):
    """K8's entry on CPU tensors against the JAX patch-gather reference at
    an odd head dim, with the encoder's sampling pattern: one query per
    position of every level, each sampling close to its own cell (the
    reference point) in every level, some points past the map's edges."""
    rng = np.random.default_rng(d)
    shapes = ((12, 10), (6, 5), (3, 3), (2, 1))
    lv = sum(hl * wl for hl, wl in shapes)
    b, lq = 2, lv
    value = rng.standard_normal((b, lv, heads, d)).astype(np.float32)
    ref_pts = []
    for hl, wl in shapes:   # each position's normalized cell centre
        yy, xx = np.mgrid[0:hl, 0:wl]
        ref_pts.append(np.stack([(xx.ravel() + 0.5) / wl, (yy.ravel() + 0.5) / hl], -1))
    ref_pts = np.concatenate(ref_pts)
    locs = (ref_pts[None, :, None, None, None, :]
            + rng.normal(0, 0.05, (b, lq, heads, len(shapes), n_points, 2))).astype(np.float32)
    w = rng.uniform(0, 1, (b, lq, heads, len(shapes), n_points)).astype(np.float32)
    w /= w.sum(axis=(-2, -1), keepdims=True)
    patch = np.asarray(jdeform.ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs),
                                              jnp.asarray(w), impl="patch"))
    out = tdeform.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                 torch.from_numpy(w)).numpy()
    assert out.shape == (b, lq, heads * d)
    assert ((locs < 0) | (locs > 1)).any()   # some corners fall off the map
    # fp32 on both sides, the same gathers and sums
    np.testing.assert_allclose(out, patch, atol=2e-6)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_mlp_ref_matches_jax(act):
    """The JAX kernel's gelu is the A&S erf polynomial (|erf err| <= 1.5e-7);
    the port's is exact erf: the difference is inside the fp32 tolerance."""
    rng = np.random.default_rng(4)
    t, w, hid = 50, 64, 256
    x = rng.standard_normal((t, w)).astype(np.float32)
    w1 = (rng.standard_normal((w, hid)) / 8).astype(np.float32)   # JAX [in, out]
    b1 = rng.standard_normal(hid).astype(np.float32) * 0.1
    w2 = (rng.standard_normal((hid, w)) / 16).astype(np.float32)
    b2 = rng.standard_normal(w).astype(np.float32) * 0.1
    ref = np.asarray(jmlp.fused_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                                    jnp.asarray(w2), jnp.asarray(b2), act=act,
                                    row_tile=64, hidden_tile=128, interpret=True))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w1.T, b1, w2.T, b2)]
    np.testing.assert_allclose(mlp_ref(*args, act=act).numpy(), ref, atol=2e-5)
    # the dispatching entry takes the plain version on CPU tensors
    xb = args[0].reshape(2, 25, w)
    out = fused_mlp(xb, *args[1:], act=act).numpy().reshape(t, w)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_fused_mlp_requires_square():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="square"):
        fused_mlp(x, torch.zeros(16, 8), torch.zeros(16),
                  torch.zeros(12, 16), torch.zeros(12))


def _jax_topk(db, qs, k, n_valid=None):
    if k > 128:
        fn = lambda: jtopk.cosine_topk(jnp.asarray(db), jnp.asarray(qs), k,
                                       n_valid=n_valid)
    else:
        fn = lambda: jtopk.cosine_topk_pallas(
            jnp.asarray(db), jnp.asarray(qs), k, n_valid=n_valid, q_tile=16,
            db_tile=256, interpret=True)
    s, i = fn()
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n,d,q,k,n_valid", [
    (1000, 64, 7, 10, None),
    (2048, 128, 9, 5, 1500),     # n_valid < N
    (300, 32, 4, 20, 12),        # k > n_valid: (-inf, -1) slots
    (300, 32, 4, 150, None),     # k above the kernel cap
])
def test_cosine_topk_ref_matches_jax(n, d, q, k, n_valid):
    rng = np.random.default_rng(n + k)
    db = random_unit(rng, n, d)
    qs = random_unit(rng, q, d)
    nv = n if n_valid is None else n_valid
    s, i = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), k,
                             n_valid=n_valid)
    s, i = s.numpy(), i.numpy()
    js, ji = _jax_topk(db, qs, k, n_valid)
    assert s.shape == (q, k) and i.dtype == np.int32
    # both against fp64 truth over the valid rows, tie-margin rule
    assert_topk_equiv(db[:nv], qs, s, i, k)
    assert_topk_equiv(db[:nv], qs, js, ji, k)
    kv = min(k, nv)
    np.testing.assert_array_equal(i[:, kv:], -1)
    assert np.isneginf(s[:, kv:]).all()
    np.testing.assert_array_equal(ji[:, kv:], i[:, kv:])


def test_cosine_topk_ties_go_to_lower_row():
    rng = np.random.default_rng(7)
    db = random_unit(rng, 500, 32)
    db[[40, 41, 300]] = db[5]
    qs = db[[5, 7]].copy()
    s, i = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), 6)
    js, ji = _jax_topk(db, qs, 6)
    np.testing.assert_array_equal(i[0, :4].numpy(), [5, 40, 41, 300])
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6)


def test_cosine_topk_casts_queries_to_db_dtype():
    rng = np.random.default_rng(8)
    db = torch.from_numpy(random_unit(rng, 64, 16)).to(torch.bfloat16)
    qs = torch.from_numpy(random_unit(rng, 3, 16))
    s, i = ttopk.cosine_topk(db, qs, 4)
    ref = qs.to(torch.bfloat16).float() @ db.float().T
    np.testing.assert_allclose(s.numpy(), ref.sort(1, descending=True).values[:, :4].numpy(),
                               atol=1e-6)


def test_above_cap_dispatch_on_cpu_is_not_counted():
    """The shape rule counts CUDA searches only; CPU tensors always take
    the plain version."""
    before = dict(kernels.plain_dispatches)
    db = torch.from_numpy(random_unit(np.random.default_rng(9), 200, 8))
    ttopk.cosine_topk(db, db[:2], 150)
    assert kernels.plain_dispatches == before


def test_apply_score_threshold_matches_jax():
    s = np.array([[0.9, 0.5, 0.2]], np.float32)
    i = np.array([[3, 1, 2]], np.int32)
    js, ji, jm = jtopk.apply_score_threshold(jnp.asarray(s), jnp.asarray(i), 0.5)
    ts, ti, tm = ttopk.apply_score_threshold(torch.from_numpy(s), torch.from_numpy(i), 0.5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
