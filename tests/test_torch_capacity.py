"""Capacity-slice ops of the PyTorch port against the JAX package, on the CPU.

Masked exact top-k (K2), the int8-exact scan (K9), the binary candidate
scan (K10), their quantizers and the exact and binary indexes. Inputs are
made with numpy from a seed and fed to both packages; the JAX kernels run
in interpret mode or through their XLA references, the port's through its
plain versions (the CUDA kernels are held against those on the card by
tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.ops import binary as jbin
from reverso_tpu.ops import topk as jtopk
from reverso_tpu.store.index import BinaryIndex as JaxBinaryIndex
from reverso_tpu.store.index import DeviceIndex as JaxDeviceIndex
from reverso_tpu_torch.ops import binary as tbin
from reverso_tpu_torch.ops import topk as ttopk
from reverso_tpu_torch.store.index import BinaryIndex, DeviceIndex
from test_topk import assert_topk_equiv, random_unit


def _data(seed, n, d, q, keep=0.7):
    rng = np.random.default_rng(seed)
    db = random_unit(rng, n, d)
    db[n // 2] = db[3]                                      # an exact tie
    qs = db[:q] + 0.02 * rng.standard_normal((q, d)).astype(np.float32)
    qs[0] = db[3]
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    mask = rng.random(n) < keep
    mask[3] = mask[n // 2] = True
    return db, qs, mask


SHAPES = [(3000, 128, 7, 10, None), (2049, 256, 65, 25, 2000), (500, 96, 3, 40, 30)]


@pytest.mark.parametrize("n,d,q,k,n_valid", SHAPES)
def test_masked_topk_matches_jax_f32(n, d, q, k, n_valid):
    """K2's plain version against `cosine_topk_xla(row_mask=)`, fp32: ids
    equal and scores within 1e-6 (the same fp32 products, summed in
    another order)."""
    db, qs, mask = _data(n, n, d, q)
    js, ji = jtopk.cosine_topk_xla(jnp.asarray(db), jnp.asarray(qs), k,
                                   n_valid=n_valid, row_mask=jnp.asarray(mask))
    ts, ti = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), k,
                               n_valid=n_valid, row_mask=mask)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(fin, np.isfinite(ts.numpy()))
    np.testing.assert_allclose(ts.numpy()[fin], np.asarray(js)[fin], atol=1e-6)
    if n_valid is None or n_valid > n // 2:
        assert ti[0, :2].tolist() == [3, n // 2]             # tie -> lower row


@pytest.mark.parametrize("n,d,q,k", [(3000, 128, 7, 10), (1000, 64, 9, 30)])
def test_masked_topk_bf16_is_exact_over_the_subset(n, d, q, k):
    """bf16 rows: the masked scan equals the exact fp64 scan of the kept
    rows (as bf16 values), under assert_topk_equiv's tie margin (1e-4)."""
    db, qs, mask = _data(n + 1, n, d, q)
    dbb = torch.from_numpy(db).bfloat16()
    qb = torch.from_numpy(qs).bfloat16()
    ts, ti = ttopk.cosine_topk(dbb, qb, k, row_mask=torch.from_numpy(mask))
    kept = np.nonzero(mask)[0]
    ids = ti.numpy()
    assert mask[ids].all()
    local = np.searchsorted(kept, ids)
    assert_topk_equiv(dbb.float().numpy()[kept], qb.float().numpy(), ts.numpy(),
                      local, k)
    js, ji = jtopk.cosine_topk_xla(jnp.asarray(db, jnp.bfloat16),
                                   jnp.asarray(qs, jnp.bfloat16), k,
                                   row_mask=jnp.asarray(mask))
    np.testing.assert_array_equal(mask[np.asarray(ji)], True)


def test_every_row_masked_and_k_past_the_rows():
    db, qs, _ = _data(5, 300, 64, 4)
    none = np.zeros(300, bool)
    s, i = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), 10,
                             row_mask=none)
    assert (i.numpy() == -1).all() and np.isneginf(s.numpy()).all()
    some = np.zeros(300, bool)
    some[[7, 100, 250]] = True
    s, i = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), 10,
                             row_mask=some)
    assert sorted(i.numpy()[0, :3].tolist()) == [7, 100, 250]
    assert (i.numpy()[:, 3:] == -1).all() and np.isneginf(s.numpy()[:, 3:]).all()


def test_int8_quantizers_match_jax():
    """quantize_db_int8, int8_clip_bound and int8_query_digits: bit for bit
    (the JAX digits taken eagerly, as IVFIndex.search computes them)."""
    db, qs, _ = _data(11, 2000, 200, 33)
    jv, js = jtopk.quantize_db_int8(jnp.asarray(db))
    tv, ts = ttopk.quantize_db_int8(torch.from_numpy(db))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.float32(ts) == np.float32(js)
    for quantile in (0.0, 0.999):
        assert ttopk.int8_clip_bound(db, quantile) == jtopk.int8_clip_bound(db, quantile)
    jd = [np.asarray(x) for x in jtopk.int8_query_digits(jnp.asarray(qs))]
    td = [x.numpy() for x in ttopk.int8_query_digits(torch.from_numpy(qs))]
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a, b)


def _int8_two_rounding(v8, scale, qs, k, mask):
    """The documented K9 contract in numpy: exact digit dots, combine
    f32(hi) * 254 then + f32(lo) (two roundings), (-score, idx) selection
    of the unscaled values, then times c2 * scale."""
    c1 = np.maximum(np.abs(qs).max(1, keepdims=True), np.float32(1e-30)) / np.float32(127)
    c2 = c1 / np.float32(254)
    hi = np.clip(np.round(qs / c1), -127, 127)
    lo = np.clip(np.round((qs - (hi * c1).astype(np.float32)) / c2), -127, 127)
    rows = v8.astype(np.int64)
    comb = ((hi.astype(np.int64) @ rows.T).astype(np.float32) * np.float32(254)
            ).astype(np.float32) + (lo.astype(np.int64) @ rows.T).astype(np.float32)
    comb = np.where(mask[None], comb, -np.inf).astype(np.float32)
    order = np.lexsort((np.broadcast_to(np.arange(comb.shape[1]), comb.shape),
                        -comb), axis=1)[:, :k]
    s = np.take_along_axis(comb, order, 1) * (c2 * np.float32(scale)).astype(np.float32)
    return s, np.where(np.isneginf(s), -1, order)


@pytest.mark.parametrize("n,d,q,k", [(3000, 256, 8, 10), (1500, 1040, 5, 20),
                                     (700, 77, 66, 16)])
def test_int8_exact_matches_jax(n, d, q, k):
    """K9's plain version against `cosine_topk_int8_exact(interpret=True)`.

    ids equal. Scores equal, bit for bit, the two-rounding contract the TPU
    kernel computes (a numpy emulation). Against the JAX package run on
    the CPU they agree within 3e-5, the digits' own resolution
    1 / (127 * 254), not bit for bit: under jit XLA's CPU compiler folds
    the digits' two divisions into one (moving some low digits by one) and
    contracts the combine into one FMA, which the TPU and the port do not
    (a divergence of the CPU reference, stated here, not repaired there)."""
    db, qs, mask = _data(2 * n + d, n, d, q)
    jv, jsc = jtopk.quantize_db_int8(jnp.asarray(db))
    v8 = np.array(jv)
    scale = float(jsc)
    js, ji = (np.asarray(x) for x in jtopk.cosine_topk_int8_exact(
        jv, jsc, jnp.asarray(qs), k, interpret=True, row_mask=jnp.asarray(mask)))
    ts, ti = ttopk.cosine_topk_int8_exact(torch.from_numpy(v8), scale,
                                          torch.from_numpy(qs), k, row_mask=mask)
    ts, ti = ts.numpy(), ti.numpy()
    np.testing.assert_array_equal(ti, ji)
    es, ei = _int8_two_rounding(v8, scale, qs, k, mask)
    np.testing.assert_array_equal(ti, ei)
    np.testing.assert_array_equal(ts, es)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(fin, np.isfinite(ts))
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=3e-5)


@pytest.mark.parametrize("k,chunk", [(10, 512), (200, 1000)])
def test_int8_chunked_scan_matches_jax(k, chunk):
    """The chunked int8 scan (the index's shape rule past the kernel's k cap
    or d = 1040) against `cosine_topk_int8_xla`: ids equal, scores within
    1e-6 (fp32 dots of the dequantized rows, summed in another order)."""
    db, qs, mask = _data(21, 2500, 128, 6)
    jv, jsc = jtopk.quantize_db_int8(jnp.asarray(db))
    js, ji = (np.asarray(x) for x in jtopk.cosine_topk_int8_xla(
        jv, jsc, jnp.asarray(qs), k, n_valid=2400, row_mask=jnp.asarray(mask)))
    ts, ti = ttopk.cosine_topk_int8_xla(torch.from_numpy(np.array(jv)), float(jsc),
                                        torch.from_numpy(qs), k, n_valid=2400,
                                        row_mask=mask, chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), ji)
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], atol=1e-6)


@pytest.mark.parametrize("d", [1024, 200, 96])
def test_pack_signs_bytes_match_jax(d):
    """Planar sign bytes equal the JAX package's at the same plane width;
    at d = 1024 the port's ceil(d/8) width is the JAX lane width."""
    x = np.random.default_rng(d).standard_normal((300, d)).astype(np.float32)
    np.testing.assert_array_equal(tbin.pack_signs(x), jbin.pack_signs(x))
    w = jbin.lane_plane_width(d)
    np.testing.assert_array_equal(tbin.pack_signs(x, plane_width=w),
                                  jbin.pack_signs(x, plane_width=w))
    t = tbin.pack_signs(torch.from_numpy(x))
    np.testing.assert_array_equal(t.numpy(), jbin.pack_signs(x))
    if d == 1024:
        assert w == (d + 7) // 8


@pytest.mark.parametrize("n,d,q,k,n_valid", [(3000, 256, 7, 30, None),
                                             (1000, 200, 5, 10, 900)])
def test_binary_topk_matches_jax(n, d, q, k, n_valid):
    """K10's plain version against `binary_topk_xla`: scores within 1e-5
    and ids equal where the proxy scores are 1e-5 apart (exact +-bf16(q_i)
    products, fp32 sums in another order)."""
    db, qs, mask = _data(3 * n, n, d, q)
    packed = jbin.pack_signs(db - db.mean(0))
    js, ji = (np.asarray(x) for x in jbin.binary_topk_xla(
        jnp.asarray(packed), jnp.asarray(qs), k, d, n_valid=n_valid,
        row_mask=jnp.asarray(mask)))
    ts, ti = tbin.binary_topk(torch.from_numpy(packed), torch.from_numpy(qs), k, d,
                              n_valid=n_valid, row_mask=mask)
    ts, ti = ts.numpy(), ti.numpy()
    tol = 1e-5
    np.testing.assert_allclose(ts, js, atol=tol)
    pad = np.full((q, 1), np.inf)
    gap_up = np.concatenate([pad, -np.diff(js, axis=1)], axis=1)
    gap_dn = np.concatenate([-np.diff(js, axis=1), pad], axis=1)
    clear = (gap_up > tol) & (gap_dn > tol)
    np.testing.assert_array_equal(np.where(clear, ti, -2), np.where(clear, ji, -2))


@pytest.mark.parametrize("quantile", [0.0, 0.99])
def test_int8_device_index_matches_jax(quantile):
    """DeviceIndex(dtype="int8"): the same stored int8 rows and scale as the
    JAX index (scale from the real rows only), and the same ids."""
    db, qs, mask = _data(31, 2500, 128, 9)
    jix = JaxDeviceIndex(db, dtype="int8", int8_quantile=quantile)
    tix = DeviceIndex(db, dtype="int8", int8_quantile=quantile, device="cpu")
    np.testing.assert_array_equal(tix.matrix.numpy(), np.asarray(jix.matrix)[:2500])
    assert tix.scale == jix.scale
    for k, m in ((10, None), (10, mask), (150, mask)):
        js, ji = (np.asarray(x) for x in jix.search(qs, k, row_mask=m))
        ts, ti = tix.search(qs, k, row_mask=m)
        np.testing.assert_array_equal(ti.numpy(), ji)
        fin = np.isfinite(js)
        np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=1e-6, atol=1e-7)


def test_binary_index_matches_jax():
    """BinaryIndex: the per-dim mean center and the packed bytes equal the
    JAX index's (d = 1024: identical plane widths), candidates equal."""
    db, qs, mask = _data(41, 1500, 1024, 6)
    jix = JaxBinaryIndex(db)
    tix = BinaryIndex(db, device="cpu")
    np.testing.assert_array_equal(tix.center, jix.center)
    np.testing.assert_array_equal(tix.matrix.numpy(), np.asarray(jix.matrix)[:1500])
    js, ji = (np.asarray(x) for x in jix.search(qs, 30, row_mask=mask))
    ts, ti = tix.search(qs, 30, row_mask=mask)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-5)
    np.testing.assert_array_equal(ti.numpy()[:, 0], ji[:, 0])
