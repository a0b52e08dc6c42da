"""The CLIP text tower of the PyTorch port (`reverso_tpu_torch.models.cliptext`)
against the JAX package's flax tower and transformers, on the CPU.

Tolerances: port against JAX on the same fp32 weights 1e-5 (both are fp32
products and an fp32 softmax; measured ~1e-6 at outputs of magnitude 3);
against transformers `CLIPTextModelWithProjection` at random init
`atol=2e-4, rtol=1e-3`, as `tests/test_cliptext.py` holds the JAX tower.
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reverso_tpu.models.cliptext import (ClipTextConfig as JaxConfig,
                                         ClipTextEncoder as JaxEncoder)
from reverso_tpu_torch.detect.clipbpe import ClipBPETokenizer, bytes_to_unicode
from reverso_tpu_torch.models.cliptext import (ClipTextConfig, ClipTextEncoder,
                                               TextEmbedder, convert_clip_text)
from reverso_tpu_torch.models.convert import flax_params_from_text, text_params_from_flax

SMALL = ClipTextConfig(vocab_size=300, width=64, depth=2, num_heads=4,
                       context_length=16, embed_dim=32, eot_token_id=299)
TINY = ClipTextConfig(vocab_size=600, width=64, depth=2, num_heads=4,
                      context_length=24, embed_dim=32, eot_token_id=599)
JAX_TOL = 1e-5


def jax_params(cfg, seed=0):
    """The flax tree of the JAX package's own init."""
    tree = jax.jit(JaxEncoder(JaxConfig(**dataclasses.asdict(cfg))).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.context_length), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_params(cfg, seed=0):
    """A flax tree from the port's seeded init (no JAX compile)."""
    return flax_params_from_text(
        TextEmbedder(cfg, None, None, device="cpu", seed=seed).module.state_dict())


def run_both(cfg, tree, ids):
    apply = jax.jit(JaxEncoder(JaxConfig(**dataclasses.asdict(cfg))).apply)
    want = np.asarray(apply({"params": tree}, jnp.asarray(ids)))
    m = ClipTextEncoder(cfg)
    m.load_state_dict(text_params_from_flax(tree, cfg))
    with torch.no_grad():
        got = m(torch.from_numpy(np.asarray(ids, np.int64))).numpy()
    return got, want, m


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_tower_matches_jax(act):
    cfg = dataclasses.replace(SMALL, act=act)
    tree = jax_params(cfg, seed=1)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, cfg.eot_token_id, (5, cfg.context_length)).astype(np.int32)
    for i, n in enumerate((3, 7, 12, 16, 9)):
        ids[i, n - 1] = cfg.eot_token_id
        ids[i, n:] = 0
    got, want, m = run_both(cfg, tree, ids)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=JAX_TOL)
    # the flax tree round-trips through the state dict exactly
    back = flax_params_from_text(m.state_dict())
    leaves = lambda t: {jax.tree_util.keystr(k): v
                        for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = leaves(tree), leaves(back)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n_eot", [0, 1, 2])
def test_pooling_at_the_first_eot(n_eot):
    """Features come from the FIRST eot position (position 0 without one),
    as the JAX tower's argmax over a 0/1 mask: with a causal tower, tokens
    after that position do not change the output."""
    cfg = SMALL
    tree = seeded_params(cfg, seed=2)
    rng = np.random.default_rng(n_eot)
    ids = rng.integers(1, cfg.eot_token_id, (2, cfg.context_length)).astype(np.int32)
    first = {0: 0, 1: 6, 2: 4}[n_eot]
    if n_eot:
        ids[:, first] = cfg.eot_token_id
    if n_eot == 2:
        ids[:, 11] = cfg.eot_token_id
    got, want, m = run_both(cfg, tree, ids)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=JAX_TOL)
    other = ids.copy()
    tail = rng.integers(1, cfg.eot_token_id, other[:, first + 1:].shape)
    other[:, first + 1:] = tail
    with torch.no_grad():
        moved = m(torch.from_numpy(other.astype(np.int64))).numpy()
    np.testing.assert_allclose(moved, got, atol=1e-6, rtol=0)
    if first + 1 < cfg.context_length:   # the pooled position itself matters
        changed = ids.copy()
        changed[:, first] = 1 if n_eot == 0 else 2
        with torch.no_grad():
            diff = m(torch.from_numpy(changed.astype(np.int64))).numpy()
        assert np.abs(diff - got).max() > 1e-3


def hf_model(monkeypatch, act="quick_gelu"):
    monkeypatch.setenv("USE_TF", "0")    # the torch model only: TensorFlow is not imported
    from transformers import CLIPTextConfig as HFCfg, CLIPTextModelWithProjection
    hf = HFCfg(vocab_size=TINY.vocab_size, hidden_size=TINY.width,
               num_hidden_layers=TINY.depth, num_attention_heads=TINY.num_heads,
               intermediate_size=int(TINY.width * TINY.mlp_ratio),
               max_position_embeddings=TINY.context_length,
               projection_dim=TINY.embed_dim, hidden_act=act,
               eos_token_id=TINY.eot_token_id, bos_token_id=598,
               attention_dropout=0.0)
    torch.manual_seed(0)
    return CLIPTextModelWithProjection(hf).eval()


def hf_ids():
    rng = np.random.default_rng(0)
    ids = np.zeros((3, TINY.context_length), np.int64)
    for i, n in enumerate((5, 12, 24)):
        ids[i, 0] = 598
        ids[i, 1:n - 1] = rng.integers(1, 590, n - 2)
        ids[i, n - 1] = TINY.eot_token_id
    return ids


def openai_state_dict(sd):
    """transformers naming -> the OpenAI/PE `transformer.resblocks` naming
    (fused in_proj, `text_projection` as [width, embed_dim])."""
    t = "text_model"
    out = {"token_embedding.weight": sd[f"{t}.embeddings.token_embedding.weight"],
           "positional_embedding": sd[f"{t}.embeddings.position_embedding.weight"],
           "ln_final.weight": sd[f"{t}.final_layer_norm.weight"],
           "ln_final.bias": sd[f"{t}.final_layer_norm.bias"],
           "text_projection": sd["text_projection.weight"].T.contiguous()}
    for i in range(TINY.depth):
        lp, op = f"{t}.encoder.layers.{i}", f"transformer.resblocks.{i}"
        for a, b in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                     ("self_attn.out_proj", "attn.out_proj"),
                     ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[f"{op}.{b}.weight"] = sd[f"{lp}.{a}.weight"]
            out[f"{op}.{b}.bias"] = sd[f"{lp}.{a}.bias"]
        for kind in ("weight", "bias"):
            out[f"{op}.attn.in_proj_{kind}"] = torch.cat(
                [sd[f"{lp}.self_attn.{p}_proj.{kind}"] for p in "qkv"])
    return out


@pytest.mark.parametrize("naming", ["hf", "openai"])
def test_text_parity_vs_hf(naming, tmp_path, monkeypatch):
    """`convert_clip_text` on both namings, and `from_pretrained` of a torch
    file, against transformers at random init."""
    model = hf_model(monkeypatch)
    ids = hf_ids()
    with torch.no_grad():
        ref = model(input_ids=torch.from_numpy(ids)).text_embeds.numpy()
    sd = model.state_dict() if naming == "hf" else openai_state_dict(model.state_dict())
    emb = TextEmbedder(TINY, convert_clip_text(sd, TINY), None, device="cpu")
    with torch.no_grad():
        out = emb.module(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-3)
    vocab, merges = write_bpe(tmp_path)
    torch.save(sd, tmp_path / "text.pt")
    loaded = TextEmbedder.from_pretrained(str(tmp_path / "text.pt"), vocab, merges,
                                          TINY, device="cpu")
    with torch.no_grad():
        again = loaded.module(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(again, out)


def write_bpe(tmp_path):
    """The vocab and merges of `tests/test_cliptext.py`'s fixture."""
    b2u = bytes_to_unicode()

    def u(s):  # ascii text -> unicode-mapped form
        return "".join(b2u[b] for b in s.encode())
    base = [u(c) for c in "abcdefghijklmnopqrstuvwxyz "]
    words = ["cat</w>", "ca", "at</w>", "c", "a", "t</w>", "dog</w>"]
    vocab = {}
    for tok in base + words + ["<|startoftext|>", "<|endoftext|>"]:
        if tok not in vocab:
            vocab[tok] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\nc a\nca t</w>\na t</w>\nd o\ndo g</w>\n")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


@pytest.fixture()
def bpe(tmp_path):
    return ClipBPETokenizer(*write_bpe(tmp_path), context_length=12)


def test_bpe_merges(bpe):
    ids = bpe.encode_text("cat")
    assert ids == [bpe.encoder["cat</w>"]]
    arr = bpe("a cat")
    assert arr.shape == (1, 12)
    assert arr[0, 0] == bpe.sot
    assert bpe.encoder["cat</w>"] in arr[0]
    assert bpe.eot in arr[0]


def test_bpe_truncation(bpe):
    arr = bpe("cat " * 40)
    assert arr.shape == (1, 12)
    assert arr[0, -1] == bpe.eot


def small_text_cfg(bpe, embed_dim):
    return ClipTextConfig(vocab_size=len(bpe.encoder), width=32, depth=1, num_heads=2,
                          context_length=12, embed_dim=embed_dim, eot_token_id=bpe.eot)


def test_from_pretrained_msgpack(tmp_path, bpe):
    """A msgpack written by the port (`save_params` of the flax-layout tree,
    config in the sidecar) loads in the port bit for bit, and in the JAX
    package's `TextEmbedder.from_pretrained` to the same embeddings."""
    from reverso_tpu.models.cliptext import TextEmbedder as JaxEmbedder
    from reverso_tpu_torch.models.checkpoint import save_params

    cfg = small_text_cfg(bpe, 16)
    emb = TextEmbedder(cfg, None, bpe, device="cpu", seed=4)
    path = str(tmp_path / "text.msgpack")
    save_params(path, flax_params_from_text(emb.module.state_dict()),
                meta={"config": dataclasses.asdict(cfg)})
    vocab, merges = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    back = TextEmbedder.from_pretrained(path, vocab, merges, device="cpu")
    assert back.cfg == cfg
    texts = ["a cat", "dog", "cat dog cat"]
    want = emb.embed(texts)
    assert want.dtype == np.float32 and want.shape == (3, 16)
    np.testing.assert_allclose(np.linalg.norm(want, axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(back.embed(texts), want)
    jax_emb = JaxEmbedder.from_pretrained(path, vocab, merges)
    np.testing.assert_allclose(jax_emb.embed(texts), want, atol=JAX_TOL, rtol=0)


def test_engine_search_by_text_matches_jax(tmp_path, bpe):
    """Text queries search one image store through the shared joint space in
    both packages, on the same vision and text weights: same filenames and
    scores, stateless and batched too."""
    from reverso_tpu.config import MODEL_PRESETS, default_config
    from reverso_tpu.engine import Reverso as JaxReverso
    from reverso_tpu.models.cliptext import TextEmbedder as JaxEmbedder
    from reverso_tpu.models.pe import PerceptionEncoder as JaxPE
    from reverso_tpu_torch.config import default_config as torch_default_config
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.models.pe import PerceptionEncoder
    from test_pipeline import make_corpus

    model = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
    jenc = JaxPE(model, seed=1)
    vision = jax.tree_util.tree_map(np.asarray, jenc.params)
    text_cfg = small_text_cfg(bpe, model.embed_dim)
    text_tree = seeded_params(text_cfg, seed=5)

    cfg = default_config()
    jeng = JaxReverso(dataclasses.replace(cfg, model=model, store=dataclasses.replace(
        cfg.store, root_dir=str(tmp_path / "db_j"))), encoder=jenc,
        text_embedder=JaxEmbedder(JaxConfig(**dataclasses.asdict(text_cfg)), text_tree, bpe))
    tcfg = torch_default_config()
    teng = Reverso(dataclasses.replace(tcfg, model=model, store=dataclasses.replace(
        tcfg.store, root_dir=str(tmp_path / "db_t"))),
        encoder=PerceptionEncoder(model, params=vision, device="cpu"),
        text_embedder=TextEmbedder(text_cfg, text_tree, bpe, device="cpu"))
    make_corpus(tmp_path / "imgs", n=5)
    assert "ready for searching" in teng.create_database(str(tmp_path / "imgs"), "txtdb",
                                                         use_direct_pe=True)
    shutil.copytree(tmp_path / "db_t" / "txtdb", tmp_path / "db_j" / "txtdb")
    assert jeng.load_database("txtdb").startswith("✅")

    results = []
    for eng in (jeng, teng):
        _, items = eng.search_by_text("a cat", similarity_threshold=-1.0, max_results=3)
        _, items_s = eng.search_by_text("a cat", similarity_threshold=-1.0, max_results=3,
                                        stateless=True, use_batcher=True)
        eng.searcher.close()
        assert [it["filename"] for it in items_s] == [it["filename"] for it in items]
        results.append(items)
    want, got = results
    assert len(got) == 3 and all(np.isfinite(it["score"]) for it in got)
    assert [it["filename"] for it in got] == [it["filename"] for it in want]
    np.testing.assert_allclose([it["score"] for it in got], [it["score"] for it in want],
                               atol=JAX_TOL, rtol=0)
    # no text encoder -> graceful message
    msg, items2 = Reverso(teng.config, encoder=teng.encoder).search_by_text("a cat")
    assert msg.startswith("❌ No text encoder") and items2 == []
