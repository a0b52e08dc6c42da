"""The port's vision-checkpoint loaders against the JAX package's, on the CPU.

* the torch -> flax-layout converters (`convert_hf_clip_vision`,
  `convert_openai_clip_vision`, `convert_vision_tower`) give trees equal
  array for array to the JAX package's, for a real HF CLIP state dict
  (`hf_clip_tiny_golden.npz`) and for an OpenAI-CLIP / perception_models
  `visual.*` state dict made from a seeded tower (PE's layer-scale gammas
  and attention pool included);
* `PerceptionEncoder.from_torch` (a `.pt` file and an HF-style directory)
  embeds as the JAX package's `from_torch` does, fp32 within 1e-5;
* the msgpack parameter files: a JAX `save_params` file (a bf16 leaf, a
  chunked array) loads in the port array for array, the port's file loads
  in the JAX package and is byte for byte the JAX package's, and
  `from_checkpoint` reads the sidecar meta as the reference does.
"""
import dataclasses
import importlib.util
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from flax import serialization
from reverso_tpu.config import MODEL_PRESETS
from reverso_tpu.models import checkpoint as jckpt
from reverso_tpu.models import convert as jconv
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu_torch.config import MODEL_PRESETS as TORCH_PRESETS
from reverso_tpu_torch.models import checkpoint as tckpt
from reverso_tpu_torch.models import convert as tconv
from reverso_tpu_torch.models.pe import PerceptionEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "hf_clip_tiny_golden.npz")
TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
FAMILIES = {
    "pe": TINY,
    "clip": dataclasses.replace(TINY, use_rope=False, pool_type="cls",
                                layer_scale_init=None),
}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for key in la:
        np.testing.assert_array_equal(la[key], lb[key], err_msg=key)


def _golden_sd():
    data = np.load(GOLDEN)
    return {k[4:]: data[k] for k in data.files if k.startswith("sd::")}, data


def _openai_sd(params, cfg) -> dict:
    """A flax vision tree -> an OpenAI-CLIP / perception_models `visual.*`
    state dict of fp32 tensors (fused in_proj, [W, E] proj): the port's
    state dict of the tree through `chip_smoke.py`'s mapper."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.openai_clip_state_dict(tconv.vision_params_from_flax(params, cfg))


def _seeded_params(family: str, seed: int = 4):
    cfg = FAMILIES[family]
    enc = JaxEncoder(cfg, family=family, seed=seed)
    return jax.tree_util.tree_map(np.asarray, enc.params), cfg


def _images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def test_hf_clip_converter_matches_jax():
    sd, data = _golden_sd()
    import json
    arch = json.loads(bytes(data["config"]).decode())
    cfg = dataclasses.replace(TINY, depth=arch["depth"])
    _assert_trees_equal(tconv.convert_hf_clip_vision(sd, cfg),
                        jconv.convert_hf_clip_vision(sd, cfg))
    _assert_trees_equal(tconv.convert_vision_tower(sd, cfg),
                        jconv.convert_vision_tower(sd, cfg, scheme="hf_clip"))


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_openai_clip_converter_matches_jax(family):
    params, cfg = _seeded_params(family)
    sd = _openai_sd(params, cfg)
    ours = tconv.convert_openai_clip_vision(sd, cfg)
    _assert_trees_equal(ours, jconv.convert_openai_clip_vision(sd, cfg))
    _assert_trees_equal(tconv.convert_vision_tower(sd, cfg), ours)
    # the scheme carries every leaf of the tower: the tree comes back whole
    # (ln_pre only where the family has one)
    _assert_trees_equal(ours, params)


def test_split_qkv_and_scheme_detection():
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    b = np.arange(6, dtype=np.float32)
    for name, want in zip(("q_proj", "k_proj", "v_proj"), range(3)):
        got = tconv._split_qkv(w, b)[name]
        np.testing.assert_array_equal(got["kernel"], w[2 * want:2 * want + 2].T)
        np.testing.assert_array_equal(got["bias"], b[2 * want:2 * want + 2])
    assert "bias" not in tconv._split_qkv(w, None)["q_proj"]
    with pytest.raises(ValueError, match="scheme"):
        tconv.convert_vision_tower({"encoder.x": np.zeros(1)}, TINY)
    with pytest.raises(ValueError):
        tconv.convert_vision_tower({}, TINY, scheme="timm")


def test_bf16_state_dict_converts_at_its_values():
    params, cfg = _seeded_params("pe")
    sd = _openai_sd(params, cfg)
    sd16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    got = tconv.convert_openai_clip_vision(sd16, cfg)
    want = jconv.convert_openai_clip_vision({k: v.float() for k, v in sd16.items()}, cfg)
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("family,layout", [("pe", "pt"), ("pe", "dir"), ("clip", "pt")])
def test_from_torch_matches_jax(tmp_path, family, layout):
    params, cfg = _seeded_params(family, seed=6)
    sd = _openai_sd(params, cfg)
    if layout == "pt":
        path = str(tmp_path / "tower.pt")
    else:
        path = str(tmp_path / "hf")
        os.makedirs(path)
    torch.save(sd, path if layout == "pt" else os.path.join(path, "pytorch_model.bin"))
    imgs = _images()
    ref = np.asarray(JaxEncoder.from_torch(path, cfg, use_flash=True).encode_image(imgs))
    tcfg = dataclasses.replace(TORCH_PRESETS["test-tiny"], dtype="float32",
                               **({} if family == "pe" else dict(
                                   use_rope=False, pool_type="cls", layer_scale_init=None)))
    enc = PerceptionEncoder.from_torch(path, tcfg, device="cpu")
    assert enc.family == family      # "pe" for a RoPE tower, else "clip"
    assert np.abs(enc.encode_image(imgs) - ref).max() <= 1e-5


def test_msgpack_jax_file_loads_in_port(tmp_path, monkeypatch):
    """A JAX `save_params` file with a bf16 leaf and a chunked array
    (flax's chunk bound lowered to 1 KB) loads in the port array for
    array; bf16 comes back as a torch.bfloat16 tensor."""
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": rng.standard_normal(5).astype(ml_dtypes.bfloat16)},
            "big": rng.standard_normal(1000).astype(np.float32),
            "ids": np.arange(7, dtype=np.int32)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    path = str(tmp_path / "p.msgpack")
    jckpt.save_params(path, tree, meta={"preset": "test-tiny"})
    back = tckpt.load_params(path)
    assert isinstance(back["a"]["bias"], torch.Tensor)
    assert back["a"]["bias"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["a"]["bias"].view(torch.int16).numpy(),
                                  tree["a"]["bias"].view(np.int16))
    for key in ("big", "ids"):
        np.testing.assert_array_equal(back[key], tree[key])
        assert back[key].dtype == tree[key].dtype
    np.testing.assert_array_equal(back["a"]["kernel"], tree["a"]["kernel"])
    assert tckpt.load_meta(path) == {"preset": "test-tiny"}


def test_msgpack_port_file_loads_in_jax(tmp_path, monkeypatch):
    """The port's file (a bf16 tensor leaf, a chunked array) loads in the
    JAX package and is byte for byte the file the JAX package writes."""
    rng = np.random.default_rng(1)
    b16 = rng.standard_normal(6).astype(ml_dtypes.bfloat16)
    tree = {"w": rng.standard_normal((40, 9)).astype(np.float32),
            "b": torch.from_numpy(b16.view(np.int16).copy()).view(torch.bfloat16),
            "n": {"scale": np.ones(3, np.float64)}}
    monkeypatch.setattr(tckpt, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    ours, theirs = str(tmp_path / "t.msgpack"), str(tmp_path / "j.msgpack")
    tckpt.save_params(ours, tree, meta={"family": "clip"})
    back = jckpt.load_params(ours)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["b"].view(np.int16), b16.view(np.int16))
    np.testing.assert_array_equal(back["n"]["scale"], tree["n"]["scale"])
    jckpt.save_params(theirs, {"w": tree["w"], "b": b16, "n": tree["n"]})
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert jckpt.load_meta(ours) == {"family": "clip"}
    assert not os.path.exists(ours + ".tmp") and not os.path.exists(ours + ".json.tmp")


def test_msgpack_unknown_extension_raises(tmp_path):
    import msgpack
    path = str(tmp_path / "x.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"a": msgpack.ExtType(9, b"??")}))
    with pytest.raises(ValueError, match="extension type 9"):
        tckpt.load_params(path)


@pytest.mark.parametrize("meta", ["config", "preset"])
def test_from_checkpoint_matches_jax(tmp_path, meta):
    """A JAX `save_params` of a tower's params, with the sidecar meta the
    weight fetcher writes, loads through the port's `from_checkpoint`:
    the config (from `config`, else `preset`) and family as the reference
    reads them, and the same embeddings (bf16 preset: cosine >= 0.999)."""
    jenc = JaxEncoder(MODEL_PRESETS["test-tiny"], family="pe", seed=2)
    path = str(tmp_path / "pe.msgpack")
    side = ({"config": dataclasses.asdict(MODEL_PRESETS["test-tiny"]), "family": "pe"}
            if meta == "config" else {"preset": "test-tiny"})
    jckpt.save_params(path, jenc.params, meta=side)
    imgs = _images(4)
    ref = np.asarray(JaxEncoder.from_checkpoint(path).encode_image(imgs))
    enc = PerceptionEncoder.from_checkpoint(path, device="cpu")
    assert enc.cfg == TORCH_PRESETS["test-tiny"] and enc.family == "pe"
    assert float((enc.encode_image(imgs) * ref).sum(1).min()) >= 0.999
    os.remove(path + ".json")
    with pytest.raises(ValueError, match="sidecar"):
        PerceptionEncoder.from_checkpoint(path, device="cpu")
    enc = PerceptionEncoder.from_checkpoint(path, TORCH_PRESETS["test-tiny"], device="cpu")
    assert enc.family == "pe"
