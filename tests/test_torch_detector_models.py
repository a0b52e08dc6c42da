"""Parity of the port's detector towers with the JAX package's.

Swin, BERT, GroundingDINO and SAM at the JAX package's tiny test widths:
each test draws flax parameters from a seed, carries them across with
`params_from_flax`, feeds both packages the same numpy inputs and compares
in fp32 on the CPU (the port's ops take their plain versions there). The
transformers -> flax converters are checked by building the same tree
through both packages' copies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.models import groundingdino as jgd
from reverso_tpu.models import sam as jsam
from reverso_tpu.models import swin as jswin
from reverso_tpu.models import text as jtext
from reverso_tpu_torch.models import convert as tconv
from reverso_tpu_torch.models import groundingdino as tgd
from reverso_tpu_torch.models import sam as tsam
from reverso_tpu_torch.models import swin as tswin
from reverso_tpu_torch.models import text as ttext
from reverso_tpu_torch.models.layers import init_weights


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _port(module, flax_params):
    module.load_state_dict(tconv.params_from_flax(flax_params))
    return module.eval().requires_grad_(False)


def _perturb(tree, seed, names):
    """Randomize leaves the flax init leaves at zeros / ones (rel-pos,
    pos-embed, norms), for a stronger check."""
    rng = np.random.default_rng(seed)

    def walk(node, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else (v + rng.standard_normal(v.shape).astype(np.float32) * 0.05
                      if any(n in path + (k,) for n in names) else v)
                for k, v in node.items()}
    return walk(tree)


@pytest.mark.parametrize("img", [64, 56])    # 56: not a multiple of window * patch
def test_swin_matches_jax(img):
    cfg_j = jswin.SwinConfig(embed_dim=24, depths=(2, 2), num_heads=(2, 4),
                             window_size=4, out_stages=(0, 1))
    cfg_t = tswin.SwinConfig(**dataclasses.asdict(cfg_j))
    x = np.random.default_rng(1).standard_normal((2, img, img, 3)).astype(np.float32)
    model = jswin.SwinBackbone(cfg_j)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = _perturb(params, 0, ("relative_position_bias_table",))
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    out = _port(tswin.SwinBackbone(cfg_t), params)(torch.from_numpy(x))
    assert sorted(out) == sorted(ref)
    for s in ref:
        # fp32 both sides; sums in another order
        np.testing.assert_allclose(out[s].numpy(), np.asarray(ref[s]), atol=2e-5, rtol=1e-4)


def test_bert_matches_jax():
    cfg_j = jtext.BertConfig(vocab_size=500, hidden_size=64, num_layers=2,
                             num_heads=4, intermediate_size=128,
                             max_position_embeddings=64)
    cfg_t = ttext.BertConfig(**dataclasses.asdict(cfg_j))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, (2, 12))
    mask = np.ones((2, 12, 12), bool)
    mask[1, :, 8:] = False
    pos = np.tile(np.arange(12), (2, 1)) % 5
    model = jtext.BertEncoder(cfg_j)
    args = (jnp.asarray(ids), jnp.asarray(mask), None, jnp.asarray(pos))
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), *args)["params"])
    ref = np.asarray(jax.jit(model.apply)({"params": params}, *args))
    out = _port(ttext.BertEncoder(cfg_t), params)(
        torch.from_numpy(ids), torch.from_numpy(mask), None,
        torch.from_numpy(pos)).numpy()
    # fp32 both sides; LayerNorm variance formulas differ by rounding
    np.testing.assert_allclose(out, ref, atol=3e-5, rtol=1e-4)


def _dino_inputs(b=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    ids = np.array([[101, 10, 11, 1012, 12, 13, 1012, 102, 0, 0],
                    [101, 20, 21, 1012, 22, 23, 1012, 102, 0, 0]])[:b]
    token_mask = ids != 0
    token_mask[:, 0] = True
    attn, pos = jgd.generate_text_masks(ids)
    return imgs, ids, attn, pos, token_mask


def test_text_masks_match_jax():
    _, ids, attn, pos, _ = _dino_inputs()
    ta, tp = tgd.generate_text_masks(ids)
    np.testing.assert_array_equal(ta, attn)
    np.testing.assert_array_equal(tp, pos)
    np.testing.assert_array_equal(tgd.sine_position_2d(5, 7, 32, 20.0),
                                  jgd.sine_position_2d(5, 7, 32, 20.0))


@pytest.fixture(scope="module")
def dino_pair():
    cfg_j = jgd.tiny_test_config()
    inputs = _dino_inputs()
    model = jgd.GroundingDino(cfg_j)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0),
                                         *(jnp.asarray(a) for a in inputs))["params"])
    params = _perturb(params, 1, ("layer_norm_vision", "layer_norm_text",
                                  "decoder_norm", "enc_output_norm"))
    port = _port(tgd.GroundingDino(tgd.tiny_test_config()), params)
    return model, params, port


def test_grounding_dino_matches_jax(dino_pair):
    model, params, port = dino_pair
    inputs = _dino_inputs()
    apply = jax.jit(lambda p, *a: model.apply({"params": p}, *a,
                                              mutable=["intermediates"]))
    (logits, boxes), state = apply(params, *(jnp.asarray(a) for a in inputs))
    ref_idx = np.asarray(state["intermediates"]["topk_proposal_idx"][0])
    t_in = [torch.from_numpy(np.asarray(a)) for a in inputs]
    out_logits, out_boxes = port(*t_in)
    out_logits, out_boxes = out_logits.numpy(), out_boxes.numpy()
    # fp32 CPU on both sides: the two-stage top-k selection is exact
    np.testing.assert_array_equal(port.topk_proposal_idx.numpy(), ref_idx)
    logits, boxes = np.asarray(logits), np.asarray(boxes)
    finite = np.isfinite(logits)
    assert (np.isfinite(out_logits) == finite).all()
    # fp32 both sides, 2+2 layers of sums in another order
    np.testing.assert_allclose(out_logits[finite], logits[finite], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out_boxes, boxes, atol=1e-5, rtol=1e-4)


def test_select_top_breaks_ties_to_the_lower_index():
    s = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    assert tgd.select_top(s, 3).tolist() == [[1, 3, 0]]
    ref = jax.lax.top_k(jnp.asarray(s.numpy()), 3)[1]
    assert np.asarray(ref).tolist() == [[1, 3, 0]]


@pytest.fixture(scope="module")
def sam_pair():
    cfg_j = jsam.tiny_sam_config()
    model = jsam.Sam(cfg_j)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)),
                                          jnp.zeros((1, 1, 4)))["params"])
    params = _perturb(params, 2, ("rel_pos_h", "rel_pos_w", "pos_embed",
                                  "neck_ln1", "upscale_ln"))
    port = _port(tsam.Sam(tsam.tiny_sam_config()), params)
    return model, params, port


@pytest.mark.parametrize("multimask", [False, True])
def test_sam_matches_jax(sam_pair, multimask):
    model, params, port = sam_pair
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    boxes = np.sort(rng.uniform(0, 64, (2, 3, 2, 2)), axis=2).reshape(2, 3, 4)
    boxes = boxes.astype(np.float32)
    apply = jax.jit(lambda p, x, bx: model.apply({"params": p}, x, bx,
                                                 multimask_output=multimask))
    ref_m, ref_i = apply(params, jnp.asarray(imgs), jnp.asarray(boxes))
    out_m, out_i = port(torch.from_numpy(imgs), torch.from_numpy(boxes),
                        multimask_output=multimask)
    # fp32 both sides; sums in another order
    np.testing.assert_allclose(out_m.numpy(), np.asarray(ref_m), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out_i.numpy(), np.asarray(ref_i), atol=1e-5, rtol=1e-4)


def test_sam_global_layer_takes_the_rel_bias_path():
    """At a 48 x 48 grid (S = 2304 > 2048) the port's global layer runs
    flash_attention with the rel-pos bias parts (on the CPU its plain
    version) while the JAX package's CPU path builds the dense [S, S] bias:
    the two agree."""
    cfg_j = jsam.SamVisionCfg(hidden_size=32, num_heads=2, num_layers=1,
                              global_attn_indexes=(0,), image_size=384,
                              patch_size=8, output_channels=16)
    cfg_t = tsam.SamVisionCfg(**dataclasses.asdict(cfg_j))
    x = np.random.default_rng(0).standard_normal((1, 384, 384, 3)).astype(np.float32)
    enc = jsam.SamVisionEncoder(cfg_j)
    params = _np_tree(jax.jit(enc.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = _perturb(params, 3, ("rel_pos_h", "rel_pos_w"))
    ref = np.asarray(jax.jit(enc.apply)({"params": params}, jnp.asarray(x)))
    out = _port(tsam.SamVisionEncoder(cfg_t), params)(torch.from_numpy(x)).numpy()
    # fp32 both sides; one global layer over 2304 tokens, sums in another order
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def hf_state_dicts():
    """Random transformers state dicts of the tiny GroundingDINO and SAM."""
    from test_groundingdino import make_hf_model as make_dino
    from test_sam import make_hf_model as make_sam
    return (make_dino(jgd.tiny_test_config()).state_dict(),
            make_sam(jsam.tiny_sam_config()).state_dict())


def test_hf_converters_match_jax(hf_state_dicts):
    """The port's transformers -> flax converters give the JAX package's
    trees on one random transformers state dict per tower."""
    from reverso_tpu.models.swin import convert_swin

    dsd, ssd = hf_state_dicts
    dcfg, scfg = jgd.tiny_test_config(), jsam.tiny_sam_config()
    prefix = "model.backbone.conv_encoder.model."
    pairs = [
        (jgd.convert_grounding_dino(dsd, dcfg), tconv.convert_grounding_dino(dsd, dcfg)),
        (jsam.convert_sam(ssd, scfg), tconv.convert_sam(ssd, scfg)),
        (convert_swin(dsd, dcfg.swin, prefix=prefix),
         tconv.convert_swin(dsd, dcfg.swin, prefix=prefix)),
    ]
    for ref, out in pairs:
        jl, jt = jax.tree_util.tree_flatten_with_path(ref)
        tl, tt = jax.tree_util.tree_flatten_with_path(out)
        assert jt == tt
        for (_, a), (_, b) in zip(jl, tl):
            np.testing.assert_array_equal(a, b)


def test_from_pretrained_loads_transformers_checkpoints(hf_state_dicts, tmp_path):
    """`GroundedSamDetector.from_pretrained` reads a safetensors and a
    torch checkpoint directory and loads the weights the JAX package's
    converters give."""
    from safetensors.torch import save_file
    from reverso_tpu_torch.detect.grounded import GroundedSamDetector

    dsd, ssd = hf_state_dicts
    (tmp_path / "dino").mkdir()
    (tmp_path / "sam").mkdir()
    # tied heads share storage; safetensors wants one tensor per key
    save_file({k: v.clone().contiguous() for k, v in dsd.items()},
              str(tmp_path / "dino" / "model.safetensors"))
    torch.save(ssd, str(tmp_path / "sam" / "pytorch_model.bin"))
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n.\nperson\n")
    det = GroundedSamDetector.from_pretrained(
        str(tmp_path / "dino"), str(tmp_path / "sam"), str(tmp_path / "vocab.txt"),
        dino_cfg=tgd.tiny_test_config(), sam_cfg=tsam.tiny_sam_config(),
        dino_size=64, text_len=16, device="cpu")
    dcfg, scfg = jgd.tiny_test_config(), jsam.tiny_sam_config()
    for module, tree in ((det.dino, jgd.convert_grounding_dino(dsd, dcfg)),
                         (det.sam, jsam.convert_sam(ssd, scfg))):
        want = tconv.params_from_flax(_np_tree(tree))
        got = module.state_dict()
        assert set(got) == set(want)
        for key, val in want.items():
            torch.testing.assert_close(got[key], val, rtol=0, atol=0)


def test_seeded_init_is_deterministic_and_sane():
    a, b, c = (tgd.GroundingDino(tgd.tiny_test_config()) for _ in range(3))
    for m, seed in ((a, 4), (b, 4), (c, 5)):
        init_weights(m, torch.Generator().manual_seed(seed))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["level_embed"], sc["level_embed"])
    assert torch.all(sa["encoder_layer0.fusion_layer.vision_param"] == 1e-4)
    assert torch.all(sa["decoder_norm.weight"] == 1.0)
    w = sa["enc_output.weight"]
    assert abs(float(w.std()) - w.shape[1] ** -0.5) < 0.3 * w.shape[1] ** -0.5
