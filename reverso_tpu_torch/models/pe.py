"""PerceptionEncoder: the engine-facing embedding model.

Wraps the PyTorch VisionTransformer with the engine's `encode_image`
semantics: a batch of preprocessed host images in, fp32 L2-normalized
embeddings out, as a host numpy array (the ingest pipeline and the engine
call `np.asarray` on the result), and the masked ROI region embeddings of
the region mode (`encode_regions`, with `pool_masks` pooling pixel masks
onto the patch grid on the host). The tower runs on one explicit device;
asking for CUDA where there is none raises. `from_torch` loads a torch
CLIP/PE vision checkpoint through the converters of `models/convert.py`,
`from_checkpoint` a converted msgpack file (`models/checkpoint.py`), as
the JAX package's loaders do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig, MODEL_PRESETS
from ..ops.norm import l2_normalize
from ..utils.profiling import span
from .convert import convert_vision_tower, is_flax_tree, vision_params_from_flax
from .vit import VisionTransformer

# Per-family architectural quirks not captured by ModelConfig's size fields.
_FAMILY_KW = {
    "pe": dict(act="gelu", use_ln_pre=False, patch_bias=True),
    "clip": dict(act="quick_gelu", use_ln_pre=True, patch_bias=False),
}

# CLIP/PE preprocessing constants (resize + center crop + normalize).
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA; without CUDA it raises, as an explicit CUDA device
    does. Only an explicit `device="cpu"` runs on the CPU: nothing falls
    back to it quietly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available "
                           f"(pass device='cpu' to run on the CPU)")
    return device


class PerceptionEncoder:
    """Batched image -> embedding model.

    `params` is either the JAX package's flax parameter tree (nested dict of
    arrays) or this package's state dict; `None` draws a seeded init from a
    `torch.Generator(seed)`. `quant="int8"` switches the MLPs to the int8
    kernel (the same parameters load either way)."""

    def __init__(self, cfg: ModelConfig, *, family: str = "pe",
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 device=None, pad_seq: bool = False, quant: Optional[str] = None):
        if quant is not None and quant != cfg.quant:
            cfg = dataclasses.replace(cfg, quant=quant)
        self.cfg = cfg
        self.family = family
        self.device = resolve_device(device)
        module = VisionTransformer(cfg, pad_seq=pad_seq, **_FAMILY_KW[family])
        if params is None:
            module.init_weights(torch.Generator().manual_seed(seed))
        else:
            if is_flax_tree(params):
                params = vision_params_from_flax(params, cfg)
            module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v, np.float32))
                 if not isinstance(v, torch.Tensor) else v.float()
                 for k, v in params.items()})
        self.module = module.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_preset(cls, name: str, **kw) -> "PerceptionEncoder":
        return cls(MODEL_PRESETS[name], **kw)

    @classmethod
    def from_torch(cls, path: str, cfg: ModelConfig, *,
                   scheme: str = "auto", family: Optional[str] = None,
                   **kw) -> "PerceptionEncoder":
        """Convert a torch CLIP/PE vision checkpoint (HF dir, .safetensors
        or .bin/.pt; `scheme` "hf_clip", "openai_clip" or "auto") and load
        it. `family` defaults to "pe" for RoPE towers, else "clip"."""
        from ..detect.grounded import load_torch_state_dict

        params = convert_vision_tower(load_torch_state_dict(path), cfg, scheme=scheme)
        if family is None:
            family = "pe" if cfg.use_rope else "clip"
        return cls(cfg, family=family, params=params, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None,
                        **kw) -> "PerceptionEncoder":
        """Load converted params saved by either package's `save_params`
        (msgpack + sidecar meta json carrying the architecture: `config`,
        else `preset`, and `family`)."""
        from .checkpoint import load_meta, load_params

        meta = load_meta(path) or {}
        if cfg is None:
            if "config" in meta:
                cfg = ModelConfig(**meta["config"])
            elif meta.get("preset") in MODEL_PRESETS:
                cfg = MODEL_PRESETS[meta["preset"]]
            else:
                raise ValueError(f"no sidecar meta next to {path}; pass cfg= explicitly")
        kw.setdefault("family", meta.get("family", "pe" if cfg.use_rope else "clip"))
        return cls(cfg, params=load_params(path), **kw)

    @torch.inference_mode()
    def encode_image(self, images, *, normalized: bool = True) -> np.ndarray:
        """images: [B, H, W, 3] float (already mean/std preprocessed).
        Returns L2-normalized [B, embed_dim] fp32 embeddings on the host."""
        if not normalized:
            raise ValueError("embeddings are always L2-normalized")
        with span("encode_image"):
            with span("encode_image.upload"):
                x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
            with span("encode_image.forward"):
                out = self.module(x)
            with span("encode_image.normalize"):
                out = l2_normalize(out.float())
            with span("encode_image.download", waits=True):
                return out.cpu().numpy()

    @torch.inference_mode()
    def encode_with_tokens(self, images):
        """Returns (embeddings [B, E] fp32 L2-normalized, tokens [B, S, W]
        in fp32: the tower's last tokens, widened from its dtype exactly),
        both on the host."""
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        out, tokens = self.module(x, return_tokens=True)
        return (l2_normalize(out.float()).cpu().numpy(),
                tokens.float().cpu().numpy())

    @torch.inference_mode()
    def encode_regions(self, images, masks):
        """Masked ROI region embeddings from one forward.

        images: [B, H, W, 3] preprocessed at the model resolution; masks:
        [B, R, H, W] bool/float masks at that resolution (mean-pooled onto
        the patch grid here), or [B, R, g*g] masks already pooled onto the
        grid (any coverage in [0, 1]; `pool_masks` makes them on the host).
        Returns (global [B, E], regions [B, R, E]), fp32 L2-normalized, on
        the host."""
        p, g = self.cfg.patch_size, self.cfg.grid_size
        m = torch.as_tensor(np.asarray(masks, np.float32))
        b, r = m.shape[:2]
        if m.ndim == 4:
            mg = m.reshape(b, r, g, p, g, p).mean(dim=(3, 5)).reshape(b, r, g * g)
        elif m.ndim == 3:
            if m.shape[2] != g * g:
                raise ValueError(f"pooled masks must be [B, R, {g * g}], got "
                                 f"{tuple(m.shape)}")
            mg = m
        else:
            raise ValueError(f"masks must be [B, R, H, W] or [B, R, {g * g}], "
                             f"got {tuple(m.shape)}")
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        pooled, regions = self.module(x, region_masks=mg.to(self.device))
        return (l2_normalize(pooled.float()).cpu().numpy(),
                l2_normalize(regions.float()).cpu().numpy())

    def pool_masks(self, masks_list, r_pad: int) -> np.ndarray:
        """Host-side patch-grid pooling for `encode_regions`'s [B, R, g*g]
        form: per image a list/array of [H, W] bool/float masks at any
        resolution, area-averaged onto the g x g grid over the integer
        block bounds `arange(g + 1) * h // g` (a block at least one pixel
        wide), as the JAX package's path without OpenCV does: soft masks
        keep their weights. Returns [B, r_pad, g*g] float32; pad regions
        stay all zero (the empty-mask fallback of the pooling)."""
        g = self.cfg.grid_size
        out = np.zeros((len(masks_list), r_pad, g * g), np.float32)
        for j, masks in enumerate(masks_list):
            for i, m in enumerate(masks[:r_pad]):
                out[j, i] = _block_means(np.asarray(m), g).reshape(-1)
        return out

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim


def _block_means(m: np.ndarray, g: int) -> np.ndarray:
    """[h, w] mask -> [g, g] means over the blocks [ys[i], max(ys[i+1],
    ys[i]+1)) x [xs[j], ...], ys = arange(g + 1) * h // g, through an
    integral image in float64 (a bool mask's block sums are exact)."""
    h, w = m.shape
    ys, xs = np.arange(g + 1) * h // g, np.arange(g + 1) * w // g
    y0, x0 = ys[:-1], xs[:-1]
    y1 = np.minimum(np.maximum(ys[1:], y0 + 1), h)
    x1 = np.minimum(np.maximum(xs[1:], x0 + 1), w)
    sat = np.zeros((h + 1, w + 1), np.float64)
    sat[1:, 1:] = m.astype(np.float64).cumsum(0).cumsum(1)
    sums = (sat[y1][:, x1] - sat[y0][:, x1] - sat[y1][:, x0] + sat[y0][:, x0])
    area = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    return (sums / area).astype(np.float32)


def preprocess_images(batch: np.ndarray) -> np.ndarray:
    """[B, H, W, 3] pixels -> normalized float32.

    The 0-255 vs 0-1 convention comes from the DTYPE: integer arrays are
    0-255 (divided by 255), float arrays must already be 0-1 (torchvision
    ToTensor semantics). A content heuristic would mis-scale near-black
    uint8 batches and make one image's normalization depend on its
    batchmates.
    """
    batch = np.asarray(batch)
    if np.issubdtype(batch.dtype, np.integer):
        x = batch.astype(np.float32) / 255.0
    else:
        x = batch.astype(np.float32)
    return (x - IMAGE_MEAN) / IMAGE_STD
