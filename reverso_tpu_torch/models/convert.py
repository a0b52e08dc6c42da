"""Parameter bridge between the JAX package's flax trees and this package's
state dicts.

The flax `VisionTransformer` tree (nested dict of arrays, e.g. the output
of `convert_vision_tower` below or of a flax `init` in the JAX package)
maps onto `models.vit.VisionTransformer` by name:

  * `block{i}` -> `blocks.{i}`;
  * Dense `kernel` [in, out] -> Linear `weight` [out, in];
  * Conv `kernel` HWIO -> `weight` OIHW;
  * LayerNorm `scale` -> `weight`; biases, gammas, cls/pos/probe as they are.

Both directions are exact (transposes only), so the two packages run the
same weights. The CLIP text tower's tree (`models.cliptext`) maps the same
way, its token embedding's `embedding` becoming a `weight`
(`text_params_from_flax`, `flax_params_from_text`).

The detector's towers (Swin, BERT, GroundingDINO, SAM) keep the flax
module names as they are (`params_from_flax`), and this module also
carries this package's own copies of the JAX package's torch -> flax-layout
converters: the vision towers' (`convert_hf_clip_vision`,
`convert_openai_clip_vision`, `convert_vision_tower`; HF CLIP and the
OpenAI-CLIP / perception_models `visual.*` scheme with PE's layer-scale
gammas and attention pool), which `PerceptionEncoder.from_torch` chains
with `vision_params_from_flax`, and the detectors' (`convert_swin`,
`convert_bert`, `convert_grounding_dino`, `convert_sam`), which
`GroundedSamDetector.from_pretrained` chains with `params_from_flax`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig

_BLOCK = re.compile(r"^block(\d+)$")
_BLOCKS = re.compile(r"^blocks\.(\d+)\.")


def is_flax_tree(params: Mapping[str, Any]) -> bool:
    """A flax tree nests Mappings; a state dict is flat."""
    return any(isinstance(v, Mapping) for v in params.values())


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def vision_params_from_flax(params_np: Mapping[str, Any],
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax vision-tower tree (numpy or torch leaves, e.g. a bf16 tensor
    from `models.checkpoint.load_params`) -> state dict of fp32 CPU
    tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        *mods, name = path
        mods = [f"blocks.{_BLOCK.match(m).group(1)}" if _BLOCK.match(m) else m
                for m in mods]
        arr = _np(leaf)
        if name == "kernel":
            name = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif name == "scale":
            name = "weight"
        sd[".".join(mods + [name])] = torch.from_numpy(np.array(arr))
    if "proj.weight" in sd and sd["proj.weight"].shape[0] != cfg.embed_dim:
        raise ValueError(f"proj maps to {sd['proj.weight'].shape[0]} dims, "
                         f"config says {cfg.embed_dim}")
    return sd


def text_params_from_flax(params_np: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """Flax `ClipTextEncoder` tree (numpy or torch leaves) -> state dict of
    `models.cliptext.ClipTextEncoder`: the vision map, with the token
    embedding's `embedding` as its `weight`."""
    tree = dict(params_np)
    tree["token_embedding"] = {"weight": tree["token_embedding"]["embedding"]}
    return vision_params_from_flax(tree, cfg)


def flax_params_from_text(state_dict: Mapping[str, Any]) -> dict:
    """Inverse of `text_params_from_flax`: state dict -> flax tree of fp32
    numpy arrays (what the JAX package's `ClipTextEncoder` and msgpack
    files hold)."""
    tree = flax_params_from_vision(state_dict)
    tree["token_embedding"] = {"embedding": tree["token_embedding"].pop("kernel").T}
    return tree


def flax_params_from_vision(state_dict: Mapping[str, Any]) -> dict:
    """Inverse of `vision_params_from_flax`: state dict -> flax tree of
    fp32 numpy arrays."""
    norm_mods = {"ln", "ln1", "ln2", "ln_pre", "ln_post", "ln_final"}
    tree: dict = {}
    for key, val in state_dict.items():
        arr = (val.detach().cpu().float().numpy() if isinstance(val, torch.Tensor)
               else np.asarray(val, np.float32))
        *mods, name = _BLOCKS.sub(r"block\1.", key).split(".")
        if name == "weight":
            if mods and mods[-1] in norm_mods:
                name = "scale"
            else:
                name = "kernel"
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


# ---------------------------------------------------------------------------
# Detector towers: flax tree -> state dict, module names kept
# ---------------------------------------------------------------------------

# flax ConvTranspose kernels [kh, kw, in, out] run the taps mirrored
# against torch's ConvTranspose2d [in, out, kh, kw] (see convert_sam)
_CONV_TRANSPOSE = ("upscale_conv1", "upscale_conv2")


def params_from_flax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax tree of a detector tower -> state dict of fp32 CPU tensors.

    Module paths are kept; Dense kernels [in, out] become Linear weights
    [out, in], Conv kernels HWIO become OIHW, ConvTranspose kernels are
    un-mirrored into [in, out, kh, kw], LayerNorm/GroupNorm `scale` and
    Embed `embedding` become `weight`; every other leaf is kept as it is."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        *mods, name = path
        arr = _np(leaf)
        if name == "kernel":
            name = "weight"
            if arr.ndim == 4 and mods and mods[-1] in _CONV_TRANSPOSE:
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                arr = arr.T
        elif name in ("scale", "embedding"):
            name = "weight"
        sd[".".join(mods + [name])] = torch.from_numpy(np.array(arr))
    return sd


# ---------------------------------------------------------------------------
# transformers state dicts -> flax-layout trees (copies of the JAX
# package's converters, which live in modules that import flax)
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):   # a torch tensor (bf16 has no numpy dtype)
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def _linear(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _ln(sd: Mapping[str, Any], prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def convert_hf_clip_vision(sd: Mapping[str, Any], cfg: ModelConfig) -> dict:
    """HF CLIPVisionModelWithProjection -> VisionTransformer params."""
    sd = dict(sd)
    v = "vision_model"
    params: Dict[str, Any] = {}
    params["patch_embed"] = {
        "kernel": _np(sd[f"{v}.embeddings.patch_embedding.weight"])
        .transpose(2, 3, 1, 0)}
    if f"{v}.embeddings.patch_embedding.bias" in sd:
        params["patch_embed"]["bias"] = _np(sd[f"{v}.embeddings.patch_embedding.bias"])
    params["cls_token"] = _np(sd[f"{v}.embeddings.class_embedding"]).reshape(1, 1, -1)
    params["pos_embed"] = _np(sd[f"{v}.embeddings.position_embedding.weight"])[None]
    # HF ships the typo'd "pre_layrnorm" name
    pre = f"{v}.pre_layrnorm" if f"{v}.pre_layrnorm.weight" in sd else f"{v}.pre_layernorm"
    params["ln_pre"] = _ln(sd, pre)

    for i in range(cfg.depth):
        lp = f"{v}.encoder.layers.{i}"
        params[f"block{i}"] = {
            "ln1": _ln(sd, f"{lp}.layer_norm1"),
            "ln2": _ln(sd, f"{lp}.layer_norm2"),
            "attn": {
                "q_proj": _linear(sd, f"{lp}.self_attn.q_proj"),
                "k_proj": _linear(sd, f"{lp}.self_attn.k_proj"),
                "v_proj": _linear(sd, f"{lp}.self_attn.v_proj"),
                "out_proj": _linear(sd, f"{lp}.self_attn.out_proj"),
            },
            "mlp": {
                "fc1": _linear(sd, f"{lp}.mlp.fc1"),
                "fc2": _linear(sd, f"{lp}.mlp.fc2"),
            },
        }
    params["ln_post"] = _ln(sd, f"{v}.post_layernorm")
    params["proj"] = {"kernel": _np(sd["visual_projection.weight"]).T}
    return params


def _split_qkv(w: np.ndarray, b: np.ndarray | None):
    """Fused in_proj [3W, W] -> three flax Dense params."""
    w3 = np.split(w, 3, axis=0)
    b3 = np.split(b, 3, axis=0) if b is not None else [None] * 3
    out = {}
    for name, wi, bi in zip(("q_proj", "k_proj", "v_proj"), w3, b3):
        out[name] = {"kernel": wi.T.astype(np.float32)}
        if bi is not None:
            out[name]["bias"] = bi.astype(np.float32)
    return out


def convert_openai_clip_vision(sd: Mapping[str, Any], cfg: ModelConfig,
                               prefix: str = "visual.") -> dict:
    """OpenAI-CLIP / perception_models style `visual.*` tower."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {}
    params["patch_embed"] = {
        "kernel": _np(sd["conv1.weight"]).transpose(2, 3, 1, 0)}
    if "conv1.bias" in sd:
        params["patch_embed"]["bias"] = _np(sd["conv1.bias"])
    if "class_embedding" in sd:
        params["cls_token"] = _np(sd["class_embedding"]).reshape(1, 1, -1)
    if "positional_embedding" in sd:
        params["pos_embed"] = _np(sd["positional_embedding"])[None]
    if "ln_pre.weight" in sd:
        params["ln_pre"] = _ln(sd, "ln_pre")

    for i in range(cfg.depth):
        lp = f"transformer.resblocks.{i}"
        blk: Dict[str, Any] = {
            "ln1": _ln(sd, f"{lp}.ln_1"),
            "ln2": _ln(sd, f"{lp}.ln_2"),
            "mlp": {
                "fc1": _linear(sd, f"{lp}.mlp.c_fc"),
                "fc2": _linear(sd, f"{lp}.mlp.c_proj"),
            },
        }
        attn = _split_qkv(_np(sd[f"{lp}.attn.in_proj_weight"]),
                          _np(sd[f"{lp}.attn.in_proj_bias"])
                          if f"{lp}.attn.in_proj_bias" in sd else None)
        attn["out_proj"] = _linear(sd, f"{lp}.attn.out_proj")
        blk["attn"] = attn
        if f"{lp}.ls_1.gamma" in sd:
            blk["ls1"] = {"gamma": _np(sd[f"{lp}.ls_1.gamma"])}
            blk["ls2"] = {"gamma": _np(sd[f"{lp}.ls_2.gamma"])}
        params[f"block{i}"] = blk

    if "ln_post.weight" in sd:
        params["ln_post"] = _ln(sd, "ln_post")
    if "attn_pool.probe" in sd:
        pool: Dict[str, Any] = {"probe": _np(sd["attn_pool.probe"]).reshape(1, 1, -1)}
        pool_bias = sd.get("attn_pool.attn.in_proj_bias")
        pool.update(_split_qkv(
            _np(sd["attn_pool.attn.in_proj_weight"]),
            _np(pool_bias) if pool_bias is not None else None))
        pool["out_proj"] = _linear(sd, "attn_pool.attn.out_proj")
        pool["ln"] = _ln(sd, "attn_pool.layernorm")
        params["attn_pool"] = pool
    if "proj" in sd:
        # OpenAI keeps proj as [W, E] already
        params["proj"] = {"kernel": _np(sd["proj"])}
    elif "proj.weight" in sd:
        params["proj"] = {"kernel": _np(sd["proj.weight"]).T}
    return params


def convert_vision_tower(sd: Mapping[str, Any], cfg: ModelConfig,
                         scheme: str = "auto") -> dict:
    if scheme == "auto":
        keys = list(sd.keys())
        if any(k.startswith("vision_model.") for k in keys):
            scheme = "hf_clip"
        elif any(k.startswith("visual.") for k in keys):
            scheme = "openai_clip"
        else:
            raise ValueError("cannot detect state-dict naming scheme")
    if scheme == "hf_clip":
        return convert_hf_clip_vision(sd, cfg)
    if scheme == "openai_clip":
        return convert_openai_clip_vision(sd, cfg)
    raise ValueError(scheme)


def convert_swin(sd: Mapping[str, Any], cfg, prefix: str = "") -> dict:
    """transformers Swin(Backbone|Model) state dict -> SwinBackbone tree."""
    sub = ({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
           if prefix else dict(sd))
    params: dict = {
        "patch_embed": {
            "kernel": _np(sub["embeddings.patch_embeddings.projection.weight"])
            .transpose(2, 3, 1, 0),
            "bias": _np(sub["embeddings.patch_embeddings.projection.bias"]),
        },
        "embed_norm": _ln(sub, "embeddings.norm"),
    }
    for s, depth in enumerate(cfg.depths):
        for b in range(depth):
            lp = f"encoder.layers.{s}.blocks.{b}"
            params[f"stage{s}_block{b}"] = {
                "ln_before": _ln(sub, f"{lp}.layernorm_before"),
                "ln_after": _ln(sub, f"{lp}.layernorm_after"),
                "attn": {
                    "query": _linear(sub, f"{lp}.attention.self.query"),
                    "key": _linear(sub, f"{lp}.attention.self.key"),
                    "value": _linear(sub, f"{lp}.attention.self.value"),
                    "proj": _linear(sub, f"{lp}.attention.output.dense"),
                    "relative_position_bias_table": _np(
                        sub[f"{lp}.attention.self.relative_position_bias_table"]),
                },
                "fc1": _linear(sub, f"{lp}.intermediate.dense"),
                "fc2": _linear(sub, f"{lp}.output.dense"),
            }
        if s < len(cfg.depths) - 1:
            dp = f"encoder.layers.{s}.downsample"
            params[f"downsample{s}"] = {
                "norm": _ln(sub, f"{dp}.norm"),
                "reduction": {"kernel": _np(sub[f"{dp}.reduction.weight"]).T},
            }
    for s in cfg.out_stages:
        # SwinBackbone: hidden_states_norms.stage{s+1}; SwinModel: layernorm
        key = f"hidden_states_norms.stage{s + 1}"
        if f"{key}.weight" in sub:
            params[f"out_norm{s}"] = _ln(sub, key)
        elif "layernorm.weight" in sub and s == len(cfg.depths) - 1:
            params[f"out_norm{s}"] = _ln(sub, "layernorm")
    return params


def convert_bert(sd: Mapping[str, Any], cfg, prefix: str = "") -> dict:
    """transformers BertModel state dict -> BertEncoder tree."""
    def g(key):
        return sd[prefix + key]

    params: dict = {
        "word_embeddings": {"embedding": _np(g("embeddings.word_embeddings.weight"))},
        "token_type_embeddings": {"embedding": _np(g("embeddings.token_type_embeddings.weight"))},
        "position_embeddings": _np(g("embeddings.position_embeddings.weight")),
        "emb_ln": {"scale": _np(g("embeddings.LayerNorm.weight")),
                   "bias": _np(g("embeddings.LayerNorm.bias"))},
    }
    # filter by prefix before stripping: slicing every key would mangle
    # non-prefixed entries (cls heads, pooler) into junk names
    sub = ({k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)} if prefix else dict(sd))
    for i in range(cfg.num_layers):
        lp = f"encoder.layer.{i}"
        params[f"layer{i}"] = {
            "self": {
                "query": _linear(sub, f"{lp}.attention.self.query"),
                "key": _linear(sub, f"{lp}.attention.self.key"),
                "value": _linear(sub, f"{lp}.attention.self.value"),
            },
            "attn_output": _linear(sub, f"{lp}.attention.output.dense"),
            "attn_ln": _ln(sub, f"{lp}.attention.output.LayerNorm"),
            "intermediate": _linear(sub, f"{lp}.intermediate.dense"),
            "output": _linear(sub, f"{lp}.output.dense"),
            "out_ln": _ln(sub, f"{lp}.output.LayerNorm"),
        }
    return params


def convert_grounding_dino(sd: Mapping[str, Any], cfg) -> dict:
    """transformers GroundingDinoForObjectDetection state dict ->
    GroundingDino tree."""
    sd = dict(sd)
    sub = lambda prefix: {k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)}

    def mha(prefix):
        return {name: _linear(sd, f"{prefix}.{name}")
                for name in ("query", "key", "value", "out_proj")}

    def deform(prefix):
        return {name: _linear(sd, f"{prefix}.{name}")
                for name in ("sampling_offsets", "attention_weights",
                             "value_proj", "output_proj")}

    def mlp_head(prefix, n):
        return {f"layers_{i}": _linear(sd, f"{prefix}.layers.{i}")
                for i in range(n)}

    params: dict = {
        "backbone": convert_swin(sd, cfg.swin,
                                 prefix="model.backbone.conv_encoder.model."),
        "text_backbone": convert_bert(sub("model.text_backbone."), cfg.text),
        "text_projection": _linear(sd, "model.text_projection"),
        "level_embed": _np(sd["model.level_embed"]),
        "query_position_embeddings": _np(
            sd["model.query_position_embeddings.weight"]),
        "enc_output": _linear(sd, "model.enc_output"),
        "enc_output_norm": _ln(sd, "model.enc_output_norm"),
        "encoder_output_bbox_embed": mlp_head(
            "model.encoder_output_bbox_embed", 3),
        "bbox_embed": mlp_head("bbox_embed.0", 3),
        "decoder_norm": _ln(sd, "model.decoder.layer_norm"),
        "reference_points_head": mlp_head(
            "model.decoder.reference_points_head", 2),
    }
    for i in range(cfg.num_feature_levels):
        params[f"input_proj_{i}_conv"] = {
            "kernel": _np(sd[f"model.input_proj_vision.{i}.0.weight"])
            .transpose(2, 3, 1, 0),
            "bias": _np(sd[f"model.input_proj_vision.{i}.0.bias"]),
        }
        params[f"input_proj_{i}_norm"] = {
            "scale": _np(sd[f"model.input_proj_vision.{i}.1.weight"]),
            "bias": _np(sd[f"model.input_proj_vision.{i}.1.bias"]),
        }
    for i in range(cfg.encoder_layers):
        lp = f"model.encoder.layers.{i}"
        fl, te, de = (f"{lp}.fusion_layer", f"{lp}.text_enhancer_layer",
                      f"{lp}.deformable_layer")
        params[f"encoder_layer{i}"] = {
            "fusion_layer": {
                "layer_norm_vision": _ln(sd, f"{fl}.layer_norm_vision"),
                "layer_norm_text": _ln(sd, f"{fl}.layer_norm_text"),
                "vision_param": _np(sd[f"{fl}.vision_param"]),
                "text_param": _np(sd[f"{fl}.text_param"]),
                "attn": {name: _linear(sd, f"{fl}.attn.{name}")
                         for name in ("vision_proj", "text_proj",
                                      "values_vision_proj", "values_text_proj",
                                      "out_vision_proj", "out_text_proj")},
            },
            "text_enhancer_layer": {
                "self_attn": mha(f"{te}.self_attn"),
                "fc1": _linear(sd, f"{te}.fc1"),
                "fc2": _linear(sd, f"{te}.fc2"),
                "layer_norm_before": _ln(sd, f"{te}.layer_norm_before"),
                "layer_norm_after": _ln(sd, f"{te}.layer_norm_after"),
            },
            "deformable_layer": {
                "self_attn": deform(f"{de}.self_attn"),
                "self_attn_layer_norm": _ln(sd, f"{de}.self_attn_layer_norm"),
                "fc1": _linear(sd, f"{de}.fc1"),
                "fc2": _linear(sd, f"{de}.fc2"),
                "final_layer_norm": _ln(sd, f"{de}.final_layer_norm"),
            },
        }
    for i in range(cfg.decoder_layers):
        lp = f"model.decoder.layers.{i}"
        params[f"decoder_layer{i}"] = {
            "self_attn": mha(f"{lp}.self_attn"),
            "self_attn_layer_norm": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "encoder_attn_text": mha(f"{lp}.encoder_attn_text"),
            "encoder_attn_text_layer_norm": _ln(sd, f"{lp}.encoder_attn_text_layer_norm"),
            "encoder_attn": deform(f"{lp}.encoder_attn"),
            "encoder_attn_layer_norm": _ln(sd, f"{lp}.encoder_attn_layer_norm"),
            "fc1": _linear(sd, f"{lp}.fc1"),
            "fc2": _linear(sd, f"{lp}.fc2"),
            "final_layer_norm": _ln(sd, f"{lp}.final_layer_norm"),
        }
    return params


def convert_sam(sd: Mapping[str, Any], cfg) -> dict:
    """transformers SamModel state dict -> Sam tree."""
    def chan_ln(prefix):
        return {"scale": _np(sd[f"{prefix}.weight"]),
                "bias": _np(sd[f"{prefix}.bias"])}

    def conv(key):
        return _np(sd[key]).transpose(2, 3, 1, 0)

    vis: dict = {
        "patch_embed": {
            "kernel": conv("vision_encoder.patch_embed.projection.weight"),
            "bias": _np(sd["vision_encoder.patch_embed.projection.bias"]),
        },
        "pos_embed": _np(sd["vision_encoder.pos_embed"]),
        "neck_conv1": {"kernel": conv("vision_encoder.neck.conv1.weight")},
        "neck_ln1": chan_ln("vision_encoder.neck.layer_norm1"),
        "neck_conv2": {"kernel": conv("vision_encoder.neck.conv2.weight")},
        "neck_ln2": chan_ln("vision_encoder.neck.layer_norm2"),
    }
    for i in range(cfg.vision.num_layers):
        lp = f"vision_encoder.layers.{i}"
        vis[f"layer{i}"] = {
            "layer_norm1": _ln(sd, f"{lp}.layer_norm1"),
            "layer_norm2": _ln(sd, f"{lp}.layer_norm2"),
            "attn": {
                "qkv": _linear(sd, f"{lp}.attn.qkv"),
                "proj": _linear(sd, f"{lp}.attn.proj"),
                "rel_pos_h": _np(sd[f"{lp}.attn.rel_pos_h"]),
                "rel_pos_w": _np(sd[f"{lp}.attn.rel_pos_w"]),
            },
            "mlp_lin1": _linear(sd, f"{lp}.mlp.lin1"),
            "mlp_lin2": _linear(sd, f"{lp}.mlp.lin2"),
        }

    prompt: dict = {
        "shared_embedding": {"positional_embedding": _np(
            sd["prompt_encoder.shared_embedding.positional_embedding"])},
        "not_a_point_embed": _np(sd["prompt_encoder.not_a_point_embed.weight"]),
        "no_mask_embed": _np(sd["prompt_encoder.no_mask_embed.weight"]),
    }
    for i in range(4):
        prompt[f"point_embed_{i}"] = _np(
            sd[f"prompt_encoder.point_embed.{i}.weight"])

    def sam_attn(prefix):
        return {n: _linear(sd, f"{prefix}.{n}")
                for n in ("q_proj", "k_proj", "v_proj", "out_proj")}

    def conv_transpose(key):
        # torch ConvTranspose2d places weight[:, :, di, dj] at output
        # offset (di, dj); a flax ConvTranspose runs the HWIO kernel
        # mirrored, so the spatial axes reverse
        return _np(sd[key]).transpose(2, 3, 0, 1)[::-1, ::-1].copy()

    dec: dict = {
        "iou_token": _np(sd["mask_decoder.iou_token.weight"]),
        "mask_tokens": _np(sd["mask_decoder.mask_tokens.weight"]),
        "final_attn": sam_attn("mask_decoder.transformer.final_attn_token_to_image"),
        "final_ln": _ln(sd, "mask_decoder.transformer.layer_norm_final_attn"),
        "upscale_conv1": {
            "kernel": conv_transpose("mask_decoder.upscale_conv1.weight"),
            "bias": _np(sd["mask_decoder.upscale_conv1.bias"])},
        "upscale_conv2": {
            "kernel": conv_transpose("mask_decoder.upscale_conv2.weight"),
            "bias": _np(sd["mask_decoder.upscale_conv2.bias"])},
        "upscale_ln": chan_ln("mask_decoder.upscale_layer_norm"),
        "iou_proj_in": _linear(sd, "mask_decoder.iou_prediction_head.proj_in"),
        "iou_proj_out": _linear(sd, "mask_decoder.iou_prediction_head.proj_out"),
    }
    for i in range(cfg.decoder.iou_head_depth - 2):
        dec[f"iou_mid_{i}"] = _linear(
            sd, f"mask_decoder.iou_prediction_head.layers.{i}")
    for i in range(cfg.decoder.num_multimask_outputs + 1):
        hp = f"mask_decoder.output_hypernetworks_mlps.{i}"
        dec[f"hyper_{i}_proj_in"] = _linear(sd, f"{hp}.proj_in")
        dec[f"hyper_{i}_mid_0"] = _linear(sd, f"{hp}.layers.0")
        dec[f"hyper_{i}_proj_out"] = _linear(sd, f"{hp}.proj_out")
    for i in range(cfg.decoder.num_layers):
        lp = f"mask_decoder.transformer.layers.{i}"
        dec[f"block{i}"] = {
            "self_attn": sam_attn(f"{lp}.self_attn"),
            "cross_attn_token_to_image": sam_attn(f"{lp}.cross_attn_token_to_image"),
            "cross_attn_image_to_token": sam_attn(f"{lp}.cross_attn_image_to_token"),
            "layer_norm1": _ln(sd, f"{lp}.layer_norm1"),
            "layer_norm2": _ln(sd, f"{lp}.layer_norm2"),
            "layer_norm3": _ln(sd, f"{lp}.layer_norm3"),
            "layer_norm4": _ln(sd, f"{lp}.layer_norm4"),
            "mlp_lin1": _linear(sd, f"{lp}.mlp.lin1"),
            "mlp_lin2": _linear(sd, f"{lp}.mlp.lin2"),
        }
    return {
        "shared_image_embedding": _np(
            sd["shared_image_embedding.positional_embedding"]),
        "vision_encoder": vis,
        "prompt_encoder": prompt,
        "mask_decoder": dec,
    }
