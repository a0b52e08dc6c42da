"""Parity of the PyTorch port's vision tower with the JAX package's.

The JAX tower's params (seeded flax init) go through the port's parameter
bridge, so both packages run the same weights on the same numpy images; a
real HF CLIP state dict goes through the port's own converter with JAX
blocked. The JAX side
runs its heads-in-lanes Pallas attention in interpret mode, as
tests/test_vit.py does on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from reverso_tpu.config import MODEL_PRESETS
from reverso_tpu.models.pe import PerceptionEncoder as JaxEncoder
from reverso_tpu.models.vit import VisionTransformer as JaxViT
from reverso_tpu_torch.models import (PerceptionEncoder, VisionTransformer,
                                      flax_params_from_vision,
                                      vision_params_from_flax)
from reverso_tpu_torch.models import pe as tpe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = MODEL_PRESETS["test-tiny"]
FAMILIES = {
    "pe": TINY,
    "clip": dataclasses.replace(TINY, use_rope=False, pool_type="cls",
                                layer_scale_init=None),
}


def _jax_params(enc):
    return jax.tree_util.tree_map(np.asarray, enc.params)


def _images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_bridge_round_trip(family):
    cfg = FAMILIES[family]
    params = _jax_params(JaxEncoder(cfg, family=family, seed=3))
    sd = vision_params_from_flax(params, cfg)
    # names and shapes are exactly the port module's
    port = VisionTransformer(cfg, **tpe._FAMILY_KW[family])
    ref_sd = port.state_dict()
    assert set(sd) == set(ref_sd)
    assert all(sd[k].shape == ref_sd[k].shape for k in sd)
    back = flax_params_from_vision(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("family", ["pe", "clip"])
@pytest.mark.parametrize("pad_seq", [False, True])
def test_encode_image_fp32_matches_jax(family, pad_seq):
    cfg = dataclasses.replace(FAMILIES[family], dtype="float32")
    imgs = _images()
    jenc = JaxEncoder(cfg, family=family, seed=0, use_flash=True)
    if pad_seq:
        kw = dict(tpe._FAMILY_KW[family])
        vit = JaxViT(cfg, use_flash=True, pad_seq=True, **kw)
        out = vit.apply({"params": jenc.params}, imgs)
        ref = np.asarray(out / np.linalg.norm(out, axis=1, keepdims=True))
    else:
        ref = np.asarray(jenc.encode_image(imgs))
    tenc = PerceptionEncoder(cfg, family=family, params=_jax_params(jenc),
                             device="cpu", pad_seq=pad_seq)
    out = tenc.encode_image(imgs)
    assert out.shape == (3, cfg.embed_dim) and out.dtype == np.float32
    # fp32 both sides: normalized embeddings agree to summation order
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_encode_image_bf16_matches_jax(family):
    cfg = FAMILIES[family]
    assert cfg.dtype == "bfloat16"
    imgs = _images(4, seed=2)
    jenc = JaxEncoder(cfg, family=family, seed=1, use_flash=True)
    ref = np.asarray(jenc.encode_image(imgs))
    out = PerceptionEncoder(cfg, family=family, params=_jax_params(jenc),
                            device="cpu").encode_image(imgs)
    # bf16 rounds at other places in the two frameworks
    assert float((out * ref).sum(1).min()) >= 0.999


def test_golden_fixture_through_bridge():
    """The frozen HF CLIP state dict + image_embeds: the port's own
    converter -> bridge -> port reproduces the torch original's
    embeddings, with `jax` and `flax` blocked."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np
        from reverso_tpu_torch.config import ModelConfig
        from reverso_tpu_torch.models.convert import convert_vision_tower
        from reverso_tpu_torch.models.pe import PerceptionEncoder
        data = np.load({os.path.join(REPO, "tests", "fixtures", "hf_clip_tiny_golden.npz")!r})
        arch = json.loads(bytes(data["config"]).decode())
        cfg = ModelConfig(name="golden-tiny", use_rope=False, pool_type="cls",
                          layer_scale_init=None, dtype="float32",
                          **{{k: arch[k] for k in ("width", "depth", "num_heads",
                                                  "image_size", "patch_size",
                                                  "embed_dim", "mlp_ratio")}})
        sd = {{k[4:]: data[k] for k in data.files if k.startswith("sd::")}}
        params = convert_vision_tower(sd, cfg, scheme="hf_clip")
        enc = PerceptionEncoder(cfg, family="clip", params=params, device="cpu")
        ours = enc.encode_image(data["pixels"])
        ref = data["image_embeds"]
        ref = ref / np.linalg.norm(ref, axis=1, keepdims=True)
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"]
        print("MINCOS", float((ours * ref).sum(1).min()))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert float(proc.stdout.split("MINCOS")[1]) >= 0.9999


def test_seeded_init_follows_flax_initialisers():
    cfg = dataclasses.replace(TINY, dtype="float32")
    a = PerceptionEncoder(cfg, seed=5, device="cpu")
    b = PerceptionEncoder(cfg, seed=5, device="cpu")
    c = PerceptionEncoder(cfg, seed=6, device="cpu")
    sa, sb, sc = (e.module.state_dict() for e in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.q_proj.weight"],
                           sc["blocks.0.attn.q_proj.weight"])
    w = sa["blocks.0.mlp.fc1.weight"]            # lecun normal, fan_in = width
    assert abs(float(w.std()) - cfg.width ** -0.5) < 0.1 * cfg.width ** -0.5
    assert float(w.abs().max()) <= 2 * cfg.width ** -0.5 / 0.8796 + 1e-6
    assert torch.all(sa["blocks.0.mlp.fc1.bias"] == 0)
    assert torch.all(sa["blocks.0.ls1.gamma"] == cfg.layer_scale_init)
    assert torch.all(sa["blocks.1.ln2.weight"] == 1)
    assert abs(float(sa["pos_embed"].std()) - 0.02) < 0.004
    emb = a.encode_image(_images(2))
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("family", ["pe", "clip"])
def test_region_masks_pool_regions_like_jax(family):
    """The tower's `region_masks` [B, R, P]: (pooled, regions[, tokens])
    from one forward, as the JAX tower returns them, fp32."""
    cfg = dataclasses.replace(FAMILIES[family], dtype="float32")
    imgs = _images(2, seed=6)
    masks = np.random.default_rng(6).random((2, 3, cfg.num_patches)).astype(np.float32)
    masks[:, 0] *= masks[:, 0] > 0.5
    jenc = JaxEncoder(cfg, family=family, seed=2, use_flash=True)
    vit = JaxViT(cfg, use_flash=True, **tpe._FAMILY_KW[family])
    jp, jr, jt = map(np.asarray, vit.apply({"params": jenc.params}, imgs,
                                           region_masks=masks, return_tokens=True))
    enc = PerceptionEncoder(cfg, family=family, params=_jax_params(jenc), device="cpu")
    with torch.inference_mode():
        tp, tr, tt = enc.module(torch.from_numpy(imgs), region_masks=torch.from_numpy(masks),
                                return_tokens=True)
        tp2, tr2 = enc.module(torch.from_numpy(imgs), region_masks=torch.from_numpy(masks))
    assert tr.shape == (2, 3, cfg.embed_dim) and tt.shape == (2, cfg.seq_len, cfg.width)
    assert torch.equal(tp, tp2) and torch.equal(tr, tr2)
    for a, b in ((tp, jp), (tr, jr), (tt, jt)):
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("family,image_size,width", [
    ("pe", 264, 64),     # S = 33 * 33 + 1 = 1090 > 1032, RoPE
    ("clip", 32, 72),    # head_dim 18: not a multiple of 4
])
def test_long_sequences_not_ported(family, image_size, width):
    """Past the heads-in-lanes kernel's envelope (S > 1032 or head_dim % 4
    != 0) attention takes the [B, H, S, D] flash kernel, as the JAX
    package's dispatch does; on the CPU its plain version. The tower
    agrees with the JAX tower's plain (`use_flash=False`) path."""
    cfg = dataclasses.replace(FAMILIES[family], dtype="float32",
                              image_size=image_size, width=width)
    imgs = np.random.default_rng(4).standard_normal(
        (2, image_size, image_size, 3)).astype(np.float32)
    jenc = JaxEncoder(cfg, family=family, seed=2, use_flash=False)
    ref = np.asarray(jenc.encode_image(imgs))
    out = PerceptionEncoder(cfg, family=family, params=_jax_params(jenc),
                            device="cpu").encode_image(imgs)
    # fp32 both sides: normalized embeddings agree to summation order
    assert np.abs(out - ref).max() <= 1e-5
