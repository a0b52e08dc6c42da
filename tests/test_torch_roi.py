"""The port's ROI region pooling (`region_embed_mode="region"`) against the
JAX package's.

`pool_masks` follows the JAX package's path without OpenCV (area means
over the integer block bounds `arange(g + 1) * h // g`): it is the path
that averages soft masks, and the port does not depend on OpenCV. The JAX
side is held with `reverso_tpu.models.pe.cv2` set to None for the
comparisons; one test states by number where its OpenCV path differs.
Everything else runs fp32 on both sides, with the JAX tower's Pallas
attention in interpret mode as tests/test_torch_vit.py runs it.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest

import reverso_tpu.models.pe as jax_pe
from reverso_tpu.config import MODEL_PRESETS, default_config
from reverso_tpu.detect import StubDetector as JaxStub
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu.models.vit import VisionTransformer as JaxViT
from reverso_tpu.store import VectorStore as JaxStore
from reverso_tpu_torch.detect import StubDetector
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.models import pe as tpe
from reverso_tpu_torch.models.pe import PerceptionEncoder, preprocess_images
from reverso_tpu_torch.store import VectorStore

TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
FAMILIES = {
    "pe": TINY,
    "clip": dataclasses.replace(TINY, use_rope=False, pool_type="cls",
                                layer_scale_init=None),
}
G = TINY.grid_size


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setattr(jax_pe, "cv2", None)


@pytest.fixture(scope="module")
def encoders():
    """(JAX encoder, port encoder) per family, one set of seeded weights."""
    out = {}
    for fam, cfg in FAMILIES.items():
        jenc = JaxEncoder(cfg, family=fam, seed=3, use_flash=True)
        params = jax.tree_util.tree_map(np.asarray, jenc.params)
        out[fam] = (jenc, PerceptionEncoder(cfg, family=fam, params=params, device="cpu"))
    return out


def _masks():
    """Masks of several kinds and sizes: bool at sizes the 4 x 4 grid does
    not divide, soft (fractional) ones, one smaller than the grid, an empty
    one, a full one."""
    rng = np.random.default_rng(0)
    return [
        [rng.random((97, 133)) < 0.4, np.ones((97, 133), bool),
         np.zeros((97, 133), bool), rng.random((97, 133)).astype(np.float32)],
        [rng.random((3, 7)) < 0.5, rng.random((50, 70)) * (rng.random((50, 70)) < 0.5)],
        np.stack([rng.random((32, 32)) < 0.3, rng.random((32, 32)) < 0.6]),
    ]


def test_pool_masks_matches_jax_without_opencv(encoders, no_cv2):
    """Equal to the JAX package's path without OpenCV at atol 1e-6 (the
    port sums blocks in float64 through an integral image; a bool mask's
    block means are then exact); pad regions stay zero."""
    jenc, tenc = encoders["pe"]
    masks = _masks()
    ref = jenc.pool_masks(masks, 4)
    out = tenc.pool_masks(masks, 4)
    assert out.shape == (3, 4, G * G) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out[0, :3], ref[0, :3])   # bool: exact
    assert (out[1, 2:] == 0).all() and (out[2, 2:] == 0).all()
    np.testing.assert_array_equal(tenc.pool_masks(masks, 1), ref[:, :1])


def test_pool_masks_divergence_from_opencv(encoders):
    """Where the JAX package's OpenCV path (INTER_AREA on uint8 masks)
    differs from the block means the port computes, on bool masks (rng 1,
    40% coverage) onto the 4 x 4 grid. INTER_AREA weighs the pixels it
    splits between two cells fractionally and rounds to 1/255, the block
    means cut at `i * h // g`:
      97 x 133: cells differ by up to 0.0074, 31% of them by more than 1/255;
      50 x 70: up to 0.0100, 44%;
      13 x 9 (a few pixels per cell): up to 0.2745, every cell;
      64 x 96 (the grid divides it): under 0.5/255, the uint8 rounding.
    Soft masks truncate to 0 through `astype(uint8)` there; the block
    means keep their weights."""
    if jax_pe.cv2 is None:
        pytest.skip("this JAX install has no OpenCV path to compare")
    jenc, tenc = encoders["pe"]
    rng = np.random.default_rng(1)
    for shape, worst, share in (((97, 133), 0.0074, 0.31), ((50, 70), 0.0100, 0.43),
                                ((13, 9), 0.2746, 1.0), ((64, 96), 0.5 / 255, 0.0)):
        m = [[rng.random(shape) < 0.4]]
        d = np.abs(jenc.pool_masks(m, 1) - tenc.pool_masks(m, 1))
        assert d.max() <= worst + 1e-6, (shape, d.max())
        assert (d > 1 / 255).mean() >= share, (shape, (d > 1 / 255).mean())
        if share:
            assert d.max() > 0.5 * worst, (shape, d.max())
    soft = [[np.full((32, 32), 0.5, np.float32)]]
    assert (jenc.pool_masks(soft, 1) == 0).all()
    np.testing.assert_allclose(tenc.pool_masks(soft, 1), 0.5)
    # PE-L14's 24 x 24 grid on 640 x 480 photo masks: 0.0095 and 0.0077,
    # 16% and 13% of the cells beyond 1/255
    cfg24 = dataclasses.replace(TINY, image_size=336, patch_size=14, depth=1)
    j24, t24 = JaxEncoder(cfg24), PerceptionEncoder(cfg24, device="cpu")
    for shape in ((480, 640), (640, 480)):
        m = [[rng.random(shape) < 0.4]]
        d = np.abs(j24.pool_masks(m, 1) - t24.pool_masks(m, 1))
        assert 0.007 < d.max() <= 0.0104 and (d > 1 / 255).mean() >= 0.1, (shape, d.max())


def _images(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _pixel_masks(b, r, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros((b, r, 32, 32), np.float32)
    m[:, 0, :16, :16] = 1
    m[:, 1, 16:, 8:] = 1
    m[:, 2] = rng.random((b, 32, 32)) < 0.3     # scattered
    # m[:, 3] stays empty: the uniform fallback
    m[:, 4] = rng.random((b, 32, 32))            # soft weights
    return m


@pytest.mark.parametrize("family", ["pe", "clip"])
@pytest.mark.parametrize("form", ["pixel", "pooled"])
def test_encode_regions_matches_jax(encoders, family, form):
    """encode_regions with pixel masks [B, R, H, W] and pooled ones
    [B, R, g*g] (an empty mask among them): global and region embeddings
    within 1e-5 of the JAX package's, fp32 (sums in another order)."""
    jenc, tenc = encoders[family]
    imgs = _images(2, 4)
    masks = _pixel_masks(2, 5, 6)
    if form == "pooled":
        p = TINY.patch_size
        masks = masks.reshape(2, 5, G, p, G, p).mean(axis=(3, 5)).reshape(2, 5, G * G)
    jg, jr = map(np.asarray, jenc.encode_regions(imgs, masks))
    tg, tr = tenc.encode_regions(imgs, masks)
    assert tg.shape == (2, TINY.embed_dim) and tr.shape == (2, 5, TINY.embed_dim)
    assert np.abs(tg - jg).max() <= 1e-5 and np.abs(tr - jr).max() <= 1e-5
    assert np.isfinite(tr).all()
    # the empty mask: uniform attention pooling (pe), a zero masked mean
    # (cls pool) in both packages; callers drop empty regions
    norms = np.linalg.norm(tr, axis=-1)
    np.testing.assert_allclose(norms[:, [0, 1, 2, 4]], 1.0, atol=1e-5)
    np.testing.assert_allclose(norms[:, 3], 1.0 if family == "pe" else 0.0, atol=1e-5)
    # distinct regions, distinct embeddings; the global one as encode_image
    assert np.abs(tr[:, 0] - tr[:, 1]).max() > 1e-3
    assert np.abs(tg - tenc.encode_image(imgs)).max() <= 1e-6


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_encode_regions_pad_seq_matches_jax(encoders, family):
    """Under pad_seq (the sequence padded to a multiple of 128 tokens) the
    region bias pads with -1e9: pad tokens never attend."""
    jenc, tenc = encoders[family]
    cfg = FAMILIES[family]
    imgs = _images(2, 7)
    masks = _pixel_masks(2, 5, 8)
    pooled = masks.reshape(2, 5, G, 8, G, 8).mean(axis=(3, 5)).reshape(2, 5, G * G)
    vit = JaxViT(cfg, use_flash=True, pad_seq=True, **tpe._FAMILY_KW[family])
    jg, jr = vit.apply({"params": jenc.params}, imgs, region_masks=pooled)
    unit = lambda a: np.asarray(a) / np.maximum(
        np.linalg.norm(np.asarray(a), axis=-1, keepdims=True), 1e-12)
    jg, jr = unit(jg), unit(jr)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    padded = PerceptionEncoder(cfg, family=family, params=params, device="cpu",
                               pad_seq=True)
    tg, tr = padded.encode_regions(imgs, pooled)
    assert np.abs(tg - jg).max() <= 1e-5 and np.abs(tr - jr).max() <= 1e-5
    ug, ur = tenc.encode_regions(imgs, pooled)     # padding changes nothing
    assert np.abs(tr - ur).max() <= 1e-5 and np.abs(tg - ug).max() <= 1e-5


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_encode_with_tokens_matches_jax(encoders, family):
    jenc, tenc = encoders[family]
    imgs = _images(3, 9)
    je, jt = map(np.asarray, jenc.encode_with_tokens(imgs))
    te, tt = tenc.encode_with_tokens(imgs)
    assert tt.shape == (3, FAMILIES[family].seq_len, TINY.width) and tt.dtype == np.float32
    assert np.abs(te - je).max() <= 1e-5
    assert np.abs(tt - jt).max() <= 1e-4 * max(1.0, float(np.abs(jt).max()))


def _corpus(folder, n=4):
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    files = []
    for i in range(n):
        p = os.path.join(folder, f"img_{i:03d}.png")
        Image.fromarray(rng.integers(0, 256, (48, 56, 3), dtype=np.uint8)).save(p)
        files.append(p)
    return files


def test_region_mode_engine_matches_jax(tmp_path, encoders, no_cv2):
    """A region-mode build (`create_database(use_direct_pe=False)` with
    `region_embed_mode="region"`) and a `detect_regions` +
    `extract_embeddings` + `search_similar` query through both engines,
    each with its package's stub detector (4 square masks per image at
    sizes the grid does not divide): the stored rows agree within 1e-5
    with equal payloads, the query's region embeddings too, and the
    search returns the same rows."""
    jenc, tenc = encoders["pe"]
    files = _corpus(str(tmp_path / "imgs"))

    def cfg(name):
        c = default_config()
        return dataclasses.replace(
            c, model=TINY,
            store=dataclasses.replace(c.store, root_dir=str(tmp_path / name)),
            ingest=dataclasses.replace(c.ingest, region_embed_mode="region"))

    jeng = JaxReverso(cfg("jax"), encoder=jenc, detector=JaxStub())
    teng = Reverso(cfg("port"), encoder=tenc, detector=StubDetector())
    for eng in (jeng, teng):
        assert "ready for searching" in eng.create_database(
            str(tmp_path / "imgs"), "roi", text_prompt="person . car")
    js = JaxStore.open(str(tmp_path / "jax"), "roi")
    ts = VectorStore.open(str(tmp_path / "port"), "roi")
    assert ts.count == js.count == 16
    jv, tv = np.asarray(js.vectors()), np.asarray(ts.vectors())
    assert np.abs(jv - tv).max() <= 1e-5
    key = lambda p: (p["filename"], p["detection_index"])
    for a, b in zip(sorted(js.payloads(list(range(16))), key=key),
                    sorted(ts.payloads(list(range(16))), key=key)):
        for field in ("filename", "bbox", "detected_class", "detection_index"):
            assert a[field] == b[field], (field, a, b)
    # one image's regions: distinct rows where their masks cover other patch
    # cells (compat would repeat one row)
    own = tv[[i for i, p in enumerate(ts.payloads(list(range(16))))
              if p["filename"] == "img_001.png"]]
    assert len(own) == 4 and (own @ own.T)[~np.eye(4, dtype=bool)].min() < 0.9

    assert teng.detect_regions(files[1], "person . car") == \
        jeng.detect_regions(files[1], "person . car") == 4
    tv_q, tm = teng.extract_embeddings(files[1])
    jv_q, jm = jeng.extract_embeddings(files[1])
    assert [m["bbox"] for m in tm] == [m["bbox"] for m in jm]
    assert np.abs(np.stack(tv_q) - np.stack(jv_q)).max() <= 1e-5
    assert not np.allclose(tv_q[0], tv_q[1])
    for q in range(4):
        _, t_items = teng.search_similar(-1.0, 3, query_index=q)
        _, j_items = jeng.search_similar(-1.0, 3, query_index=q)
        assert [(it["filename"], it["bbox"]) for it in t_items] == \
            [(it["filename"], it["bbox"]) for it in j_items]
        assert t_items[0]["filename"] == "img_001.png"
        np.testing.assert_allclose([it["score"] for it in t_items],
                                   [it["score"] for it in j_items], atol=1e-5)


def build_corpus(rng, P: int, N: int, S: int):
    """Patterns, 2 x 2 grid images of four distinct patterns, labels and
    quadrant masks (the corpus of scripts/eval_roi_quality.py)."""
    H = S // 2
    pats = rng.integers(0, 256, (P, S, S, 3)).astype(np.uint8)
    quads = [(0, 0), (0, 1), (1, 0), (1, 1)]
    imgs = np.zeros((N, S, S, 3), np.uint8)
    lab = np.zeros((N, 4), np.int32)
    for i in range(N):
        ps = rng.choice(P, 4, replace=False)
        lab[i] = ps
        for q, (r, c) in enumerate(quads):
            sl = (slice(r * H, (r + 1) * H), slice(c * H, (c + 1) * H))
            imgs[i][sl] = pats[ps[q]][sl]
    masks = np.zeros((N, 4, S, S), bool)
    for q, (r, c) in enumerate(quads):
        masks[:, q, r * H:(r + 1) * H, c * H:(c + 1) * H] = True
    return pats, imgs, lab, masks


def test_roi_beats_compat_region_recall_on_port():
    """tests/test_roi.py's region-recall check on the port: on 2 x 2 grids
    of distinct noise textures, with queries embedded globally, masked-ROI
    rows retrieve the right region far better than the reference's
    global-per-region rows (seeded random init, fp32... as the JAX eval's
    tower: width 128, depth 4, 64 px, patch 8)."""
    P, N, jitters = 16, 32, 2
    cfg = dataclasses.replace(MODEL_PRESETS["test-tiny"], name="roi-eval", image_size=64,
                              patch_size=8, width=128, depth=4, num_heads=4, embed_dim=64)
    pe = PerceptionEncoder(cfg, device="cpu")
    rng = np.random.default_rng(0)
    pats, imgs, lab, masks = build_corpus(rng, P, N, cfg.image_size)
    g, reg = pe.encode_regions(preprocess_images(imgs), masks)
    stores = {"compat": np.repeat(np.asarray(g, np.float64), 4, axis=0),
              "roi": np.asarray(reg, np.float64).reshape(N * 4, -1)}
    qimgs = np.concatenate([np.clip(pats.astype(np.int32) + rng.integers(-12, 13, pats.shape),
                                    0, 255).astype(np.uint8) for _ in range(jitters)])
    qlab = np.tile(np.arange(P), jitters)
    qe = np.asarray(pe.encode_image(preprocess_images(qimgs)), np.float64)
    qe /= np.linalg.norm(qe, axis=1, keepdims=True)
    res = {}
    for name, db in stores.items():
        dbn = db / np.linalg.norm(db, axis=1, keepdims=True)
        order = np.argsort(-(qe @ dbn.T), axis=1, kind="stable")
        hit = lab.reshape(-1)[order] == qlab[:, None]
        res[name] = {"recall@1": float(hit[:, 0].mean()),
                     "recall@10": float(hit[:, :10].any(axis=1).mean()),
                     "mrr": float(np.mean(1.0 / (1 + hit.argmax(axis=1)) * hit.any(axis=1)))}
    c, r = res["compat"], res["roi"]
    assert r["recall@1"] >= c["recall@1"] + 0.2, res
    assert r["mrr"] >= c["mrr"] + 0.2, res
    assert r["recall@10"] >= c["recall@10"], res
