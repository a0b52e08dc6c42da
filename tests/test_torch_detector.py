"""The port's GroundedSAM detector and region path against the JAX package's.

Both packages run the same tiny detector (the JAX package's tiny
GroundingDINO and SAM configs, its 12-word test vocabulary, one set of
seeded flax parameters carried across) on the same images. At 64 x 64 the
DINO and SAM resizes are the identity in both, so the port's boxes,
confidences, classes and masks must equal the JAX detector's exactly; the
JAX side runs its reference mask path (`REVERSO_MASK_LOGITS=1`: upsample
the logits, then threshold), which the port follows. The region-mode
build and search then run end to end through both engines.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from reverso_tpu.config import MODEL_PRESETS, StoreConfig, default_config
from reverso_tpu.detect.grounded import GroundedSamDetector as JaxDetector
from reverso_tpu.detect.wordpiece import WordPieceTokenizer as JaxTokenizer
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.models.groundingdino import GroundingDino as JaxDino
from reverso_tpu.models.groundingdino import tiny_test_config as jax_dino_tiny
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu.models.sam import Sam as JaxSam
from reverso_tpu.models.sam import tiny_sam_config as jax_sam_tiny
from reverso_tpu.store import VectorStore as JaxStore
from reverso_tpu_torch.compat import SimpleReverso
from reverso_tpu_torch.config import DetectorConfig
from reverso_tpu_torch.detect.grounded import GroundedSamDetector, resize_u8
from reverso_tpu_torch.detect.wordpiece import WordPieceTokenizer
from reverso_tpu_torch.models.groundingdino import tiny_test_config
from reverso_tpu_torch.models.pe import PerceptionEncoder
from reverso_tpu_torch.models.sam import tiny_sam_config
from reverso_tpu_torch.store import VectorStore

VOCAB = "[PAD]\n[UNK]\n[CLS]\n[SEP]\n.\n?\nperson\ncar\nbuild\n##ing\nred\na\n"
PROMPTS = ["person", "car"]
DET_CFG = dict(box_threshold=0.0, text_threshold=0.0, max_regions=8)
PE_CFG = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "vocab.txt"
    p.write_text(VOCAB)
    return str(p)


@pytest.fixture(scope="module")
def params():
    dino = JaxDino(jax_dino_tiny())
    dparams = jax.jit(dino.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16, 16), bool),
        jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), bool))["params"]
    sparams = jax.jit(JaxSam(jax_sam_tiny()).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 1, 4)))["params"]
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    return to_np(dparams), to_np(sparams)


def _jax_detector(params, vocab_path, monkeypatch, logits: bool):
    from reverso_tpu.config import DetectorConfig as JaxDetectorConfig
    monkeypatch.setenv("REVERSO_MASK_LOGITS", "1" if logits else "0")
    return JaxDetector(*params, JaxTokenizer(vocab_path),
                       cfg=JaxDetectorConfig(**DET_CFG), dino_cfg=jax_dino_tiny(),
                       sam_cfg=jax_sam_tiny(), dino_size=64, text_len=16)


def _port_detector(params, vocab_path):
    return GroundedSamDetector(*params, WordPieceTokenizer(vocab_path),
                               cfg=DetectorConfig(**DET_CFG),
                               dino_cfg=tiny_test_config(),
                               sam_cfg=tiny_sam_config(), dino_size=64,
                               text_len=16, device="cpu")


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(n)]


def _assert_same_regions(port, ref):
    assert len(port) == len(ref)
    np.testing.assert_array_equal(port.class_ids, ref.class_ids)
    assert port.class_names == ref.class_names
    # fp32 CPU on both sides; boxes are pixel coordinates of a 64 px image
    np.testing.assert_allclose(port.boxes, ref.boxes, atol=1e-4)
    np.testing.assert_allclose(port.confidences, ref.confidences, atol=1e-5)
    assert port.masks.dtype == bool and port.masks.shape == ref.masks.shape
    np.testing.assert_array_equal(port.masks, ref.masks)


def test_detect_and_detect_batch_match_jax(params, vocab_path, monkeypatch):
    jdet = _jax_detector(params, vocab_path, monkeypatch, logits=True)
    tdet = _port_detector(params, vocab_path)
    imgs = _images(5, seed=3)     # 5 images: one full DINO chunk of 4 and a padded one
    _assert_same_regions(tdet.detect(imgs[0], PROMPTS), jdet.detect(imgs[0], PROMPTS))
    for port, ref in zip(tdet.detect_batch(imgs, PROMPTS),
                         jdet.detect_batch(imgs, PROMPTS)):
        assert len(ref) == DET_CFG["max_regions"]
        _assert_same_regions(port, ref)


def test_mask_flip_rate_against_the_jax_default(params, vocab_path, monkeypatch):
    """The port upsamples the mask logits and then thresholds (the
    reference's order); the JAX package's default thresholds on SAM's
    S/4 grid and then upsamples the 0/1 indicator. Same boxes, same
    classes; the masks differ on a share of the pixels at random init,
    where the logits hover near zero with no margin."""
    jdet = _jax_detector(params, vocab_path, monkeypatch, logits=False)
    assert jdet.mask_bits
    tdet = _port_detector(params, vocab_path)
    imgs = _images(4, seed=7)
    flips, total = 0, 0
    for port, ref in zip(tdet.detect_batch(imgs, PROMPTS),
                         jdet.detect_batch(imgs, PROMPTS)):
        np.testing.assert_array_equal(port.class_ids, ref.class_ids)
        np.testing.assert_allclose(port.boxes, ref.boxes, atol=1e-4)
        flips += int((port.masks != ref.masks).sum())
        total += port.masks.size
    rate = flips / total
    print(f"mask flip rate, port vs JAX default (threshold then upsample), "
          f"tiny random-init detector: {rate:.4f} of {total} pixels")
    assert rate <= 0.30   # the JAX package's own bits-vs-logits gate


@pytest.mark.parametrize("src,dst", [((480, 640), (800, 800)),
                                     ((123, 77), (64, 64)),
                                     ((640, 480), (1024, 768)),
                                     ((37, 53), (37, 53))])
def test_resize_matches_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    out = resize_u8(img, dst, torch.device("cpu")).numpy()
    assert out.shape == ref.shape
    # OpenCV's uint8 resize uses 11-bit fixed-point weights
    assert np.abs(out - ref.astype(np.float32)).max() <= 1.0


def test_entry_points_need_cuda_or_an_explicit_cpu(vocab_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from reverso_tpu_torch.config import default_config as port_default
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.store import DeviceIndex

    tok = WordPieceTokenizer(vocab_path)
    small = dict(dino_cfg=tiny_test_config(), sam_cfg=tiny_sam_config())
    for make in (lambda: Reverso(port_default()),
                 lambda: SimpleReverso(port_default()),
                 lambda: DeviceIndex(np.zeros((4, 8), np.float32)),
                 lambda: PerceptionEncoder(PE_CFG),
                 lambda: GroundedSamDetector(tokenizer=tok, **small)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # an explicit CPU runs
    assert Reverso(port_default(), device="cpu").device.type == "cpu"
    assert GroundedSamDetector(tokenizer=tok, device="cpu", **small).device.type == "cpu"


# ---------------------------------------------------------------------------
# The region slice: create_database(use_direct_pe=False) + query, both engines
# ---------------------------------------------------------------------------

def _folder(root, n=6, seed=11):
    folder = os.path.join(root, "images")
    os.makedirs(folder)
    for j, img in enumerate(_images(n, seed)):
        Image.fromarray(img).save(os.path.join(folder, f"im_{j:02d}.png"))
    return folder


def _config(root, name):
    cfg = default_config()
    return cfg.replace(model=PE_CFG, store=StoreConfig(root_dir=os.path.join(root, name),
                                                       dtype="float32"))


@pytest.fixture(scope="module")
def region_dbs(params, vocab_path, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        jdet = _jax_detector(params, vocab_path, mp, logits=True)
    finally:
        mp.undo()
    root = str(tmp_path_factory.mktemp("regions"))
    folder = _folder(root)
    jenc = JaxEncoder(PE_CFG, seed=0, use_flash=True)
    pe_params = jax.tree_util.tree_map(np.asarray, jenc.params)
    jax_eng = JaxReverso(_config(root, "jax_db"), encoder=jenc, detector=jdet)
    port = SimpleReverso(_config(root, "port_db"),
                         encoder=PerceptionEncoder(PE_CFG, params=pe_params, device="cpu"),
                         detector=_port_detector(params, vocab_path), device="cpu")
    jt = jax_eng.create_database(folder, "regions", text_prompt="person . car")
    pt = port.create_database(folder, "regions", text_prompt="person . car")
    assert "ready for searching" in jt and "ready for searching" in pt, (jt, pt)
    return dict(root=root, folder=folder, jax=jax_eng, port=port)


def test_region_build_matches_jax(region_dbs):
    root = region_dbs["root"]
    js = JaxStore.open(os.path.join(root, "jax_db"), "regions")
    ts = VectorStore.open(os.path.join(root, "port_db"), "regions")
    assert ts.count == js.count > 6
    jv, tv = np.asarray(js.vectors()), np.asarray(ts.vectors())
    assert float((jv * tv).sum(1).min()) >= 0.9999
    key = lambda p: (p["filename"], p["detection_index"])
    jp = sorted(js.payloads(list(range(js.count))), key=key)
    tp = sorted(ts.payloads(list(range(ts.count))), key=key)
    for a, b in zip(jp, tp):
        for field in ("filename", "bbox", "detected_class", "mask_status",
                      "detection_index", "area_ratio"):
            assert a[field] == b[field], (field, a, b)
        assert abs(a["confidence"] - b["confidence"]) <= 1e-5


def test_region_query_matches_jax(region_dbs):
    jax_eng, port = region_dbs["jax"], region_dbs["port"]
    path = os.path.join(region_dbs["folder"], "im_02.png")
    port.load_database("regions")
    jax_eng.load_database("regions")
    assert port.detect_regions(path, "person . car") == \
        jax_eng.detect_regions(path, "person . car") > 0
    tv, tm = port.extract_embeddings(path)
    jv, jm = jax_eng.extract_embeddings(path)
    assert [m["bbox"] for m in tm] == [m["bbox"] for m in jm]
    np.testing.assert_allclose(np.stack(tv), np.stack(jv), atol=1e-5)
    t_text, t_items = port.search_similar(-1.0, 5)
    j_text, j_items = jax_eng.search_similar(-1.0, 5)
    ts = np.array([it["score"] for it in t_items])
    js = np.array([it["score"] for it in j_items])
    np.testing.assert_allclose(ts, js, atol=1e-5)
    # ids must agree wherever the ranked scores are clear of their
    # neighbours (regions of one image share its embedding: exact ties)
    gap = np.diff(js)
    clear = np.ones(len(js), bool)
    clear[1:] &= np.abs(gap) > 1e-4
    clear[:-1] &= np.abs(gap) > 1e-4
    assert [f for f, c in zip((it["filename"] for it in t_items), clear) if c] == \
        [f for f, c in zip((it["filename"] for it in j_items), clear) if c]
    assert t_items[0]["filename"] == "im_02.png"


def test_roi_mode_builds_like_jax(region_dbs, params, vocab_path, monkeypatch):
    """region_embed_mode="region" through the seeded tiny detector: the
    port's masked-ROI build equals the JAX package's (its pooling without
    OpenCV, and its reference mask path) row for row, and its rows are the
    masked pools, not compat mode's global embeddings (the masks of this
    random-init detector cover whole images at 64 px, so one image's
    regions pool alike; tests/test_torch_roi.py has distinct masks)."""
    import reverso_tpu.models.pe as jax_pe

    monkeypatch.setattr(jax_pe, "cv2", None)
    port = region_dbs["port"]
    root, folder = region_dbs["root"], region_dbs["folder"]
    roi = lambda c: c.replace(ingest=dataclasses.replace(c.ingest, region_embed_mode="region"))
    cfg = port._engine.config
    port._engine.config = roi(cfg)
    try:
        assert "ready for searching" in port.create_database(folder, "roi",
                                                             text_prompt="person . car")
    finally:
        port._engine.config = cfg
    jdet = _jax_detector(params, vocab_path, monkeypatch, logits=True)
    jenc = region_dbs["jax"].encoder
    jax_eng = JaxReverso(roi(_config(root, "jax_db")), encoder=jenc, detector=jdet)
    assert "ready for searching" in jax_eng.create_database(folder, "roi",
                                                            text_prompt="person . car")
    js = JaxStore.open(os.path.join(root, "jax_db"), "roi")
    ts = VectorStore.open(os.path.join(root, "port_db"), "roi")
    assert ts.count == js.count > 6
    key = lambda p: (p["filename"], p["detection_index"])
    jp = sorted(range(js.count), key=lambda r: key(js.payloads([r])[0]))
    tp = sorted(range(ts.count), key=lambda r: key(ts.payloads([r])[0]))
    jv, tv = np.asarray(js.vectors())[jp], np.asarray(ts.vectors())[tp]
    assert np.abs(jv - tv).max() <= 1e-4
    cs = VectorStore.open(os.path.join(root, "port_db"), "regions")
    cp = sorted(range(cs.count), key=lambda r: key(cs.payloads([r])[0]))
    assert np.abs(np.asarray(cs.vectors())[cp] - tv).max() > 1e-3   # not compat's rows
