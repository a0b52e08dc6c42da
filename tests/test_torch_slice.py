"""The direct-embed main path, JAX package vs PyTorch port, end to end.

One seeded image folder is built into a database by the JAX engine and by
the port's reference-compatible facade, with the same test-tiny fp32
weights; the stored rows, the search results and the on-disk stores must
agree, and each package must open the other's store.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
from PIL import Image

from reverso_tpu.config import MODEL_PRESETS, StoreConfig, default_config
from reverso_tpu.engine import Reverso as JaxReverso
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu.store import VectorStore as JaxStore
from reverso_tpu_torch.compat import SimpleReverso
from reverso_tpu_torch.engine import Reverso
from reverso_tpu_torch.models.pe import PerceptionEncoder
from reverso_tpu_torch.store import VectorStore

TOL = 1e-4   # tie margin for ids; fp32 scores on both sides
CFG = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")


def _folder(root, n=12, seed=0):
    folder = os.path.join(root, "images")
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    for j in range(n):
        size = int(rng.integers(24, 64))
        img = rng.integers(0, 256, (size, size + 5, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(folder, f"im_{j:02d}.png"))
    return folder


def _config(root, name):
    cfg = default_config()
    return cfg.replace(model=CFG,
                       store=StoreConfig(root_dir=os.path.join(root, name),
                                         dtype="float32"))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    folder = _folder(root)
    jenc = JaxEncoder(CFG, seed=0, use_flash=True)
    params = jax.tree_util.tree_map(np.asarray, jenc.params)
    jax_eng = JaxReverso(_config(root, "jax_db"), encoder=jenc)
    port = SimpleReverso(_config(root, "port_db"),
                         encoder=PerceptionEncoder(CFG, params=params, device="cpu"),
                         device="cpu")
    jt = jax_eng.create_database(folder, "slice", use_direct_pe=True)
    pt = port.create_database(folder, "slice", use_direct_pe=True)
    assert "ready for searching" in jt and "ready for searching" in pt
    return dict(root=root, folder=folder, jax=jax_eng, port=port, params=params)


def _assert_same_hits(js, ji, ts, ti):
    js, ji, ts, ti = (np.asarray(a) for a in (js, ji, ts, ti))
    np.testing.assert_allclose(ts, js, atol=1e-5)
    pad = np.full((js.shape[0], 1), np.inf)
    gap_up = np.concatenate([pad, -np.diff(js, axis=1)], axis=1)
    gap_dn = np.concatenate([-np.diff(js, axis=1), pad], axis=1)
    clear = (gap_up > TOL) & (gap_dn > TOL)
    np.testing.assert_array_equal(np.where(clear, ti, -2), np.where(clear, ji, -2))


def test_rows_agree(built):
    jv = np.asarray(JaxStore.open(os.path.join(built["root"], "jax_db"), "slice").vectors())
    tv = np.asarray(VectorStore.open(os.path.join(built["root"], "port_db"), "slice").vectors())
    assert jv.shape == tv.shape == (12, CFG.embed_dim)
    assert float((jv * tv).sum(1).min()) >= 0.9999


def test_search_batch_and_similar_agree(built):
    jax_eng, port = built["jax"], built["port"]
    for eng, name in ((jax_eng, "slice"), (port, "slice")):
        assert "Loaded" in eng.load_database(name)
    queries = np.asarray(VectorStore.open(os.path.join(built["root"], "port_db"),
                                          "slice").vectors())[[0, 3, 7, 11]]
    js, ji = jax_eng.search_batch(queries, 5)
    ts, ti = port._engine.search_batch(queries, 5)
    _assert_same_hits(js, ji, ts, ti)
    np.testing.assert_array_equal(ti[:, 0], [0, 3, 7, 11])
    img = Image.open(os.path.join(built["folder"], "im_05.png"))
    jemb, _ = jax_eng.process_image_direct_pe(img)
    temb, _ = port.process_image_direct_pe(img)
    assert float(np.dot(jemb[0], temb[0])) >= 0.9999
    jtext, jitems = jax_eng.search_similar(0.0, 5)
    ttext, titems = port.search_similar(0.0, 5)
    assert titems[0]["filename"] == "im_05.png"
    _assert_same_hits([[it["score"] for it in jitems]], [[it["id"] for it in jitems]],
                      [[it["score"] for it in titems]], [[it["id"] for it in titems]])
    assert ttext.startswith("🎯 Found 5 similar regions")
    # threshold and state strings carried from the JAX engine
    assert port.search_similar(1.1, 5) == jax_eng.search_similar(1.1, 5)


def test_each_package_opens_the_others_store(built):
    root = built["root"]
    for writer, reader in (("port_db", JaxStore), ("jax_db", VectorStore)):
        own = (VectorStore if reader is JaxStore else JaxStore).open(
            os.path.join(root, writer), "slice")
        other = reader.open(os.path.join(root, writer), "slice")
        np.testing.assert_array_equal(np.asarray(other.vectors()), np.asarray(own.vectors()))
        po = other.payloads(list(range(other.count)))
        pw = own.payloads(list(range(own.count)))
        assert [sorted(p) for p in po] == [sorted(p) for p in pw]
        assert [p["filename"] for p in po] == [f"im_{j:02d}.png" for j in range(12)]
    # the port's engine searches the JAX-built store
    eng = Reverso(_config(root, "jax_db"),
                  encoder=PerceptionEncoder(CFG, params=built["params"], device="cpu"),
                  device="cpu")
    assert eng.load_database("slice") == "✅ Loaded database: slice"
    q = np.asarray(JaxStore.open(os.path.join(root, "jax_db"), "slice").vectors())[4]
    s, i = eng.search_batch(q, 3)
    assert i[0, 0] == 4 and s.shape == (1, 3)


def test_port_engine_surface(built, tmp_path):
    eng = Reverso(_config(str(tmp_path), "db"),
                  encoder=PerceptionEncoder(CFG, params=built["params"], device="cpu"),
                  device="cpu")
    assert eng.list_databases() == []
    assert eng.load_database("nope") == "❌ Database not found: nope"
    text, items = eng.search_similar(0.5, 5, embeddings=None)
    assert text.startswith("❌ No query embeddings") and items == []
    with pytest.raises(RuntimeError, match="no detector configured"):
        eng.detect_regions(np.zeros((8, 8, 3), np.uint8))
    # nothing detected yet: no region embeddings (the JAX engine's answer)
    assert eng.extract_embeddings(np.zeros((8, 8, 3), np.uint8)) == ([], [])
    eng.create_database(built["folder"], "copy", use_direct_pe=True)
    assert eng.list_databases() == ["copy"]
    # a payload filter no row matches: an empty page, as the JAX engine
    _, ids = eng.search_batch(np.zeros(CFG.embed_dim, np.float32), 3, filter={"a": 1})
    assert (ids == -1).all() and eng.count(filter={"a": 1}) == 0
    assert eng.delete_database("copy") == "✅ Deleted database: copy"
