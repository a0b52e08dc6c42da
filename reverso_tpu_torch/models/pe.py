"""PerceptionEncoder: the engine-facing embedding model.

Wraps the PyTorch VisionTransformer with the engine's `encode_image`
semantics: a batch of preprocessed host images in, fp32 L2-normalized
embeddings out, as a host numpy array (the ingest pipeline and the engine
call `np.asarray` on the result). The tower runs on one explicit device;
asking for CUDA where there is none raises.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..config import ModelConfig, MODEL_PRESETS
from ..ops.norm import l2_normalize
from .convert import is_flax_tree, vision_params_from_flax
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
    `torch.Generator(seed)`."""

    def __init__(self, cfg: ModelConfig, *, family: str = "pe",
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0,
                 device=None, pad_seq: bool = False):
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

    @torch.inference_mode()
    def encode_image(self, images, *, normalized: bool = True) -> np.ndarray:
        """images: [B, H, W, 3] float (already mean/std preprocessed).
        Returns L2-normalized [B, embed_dim] fp32 embeddings on the host."""
        if not normalized:
            raise ValueError("embeddings are always L2-normalized")
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        out = self.module(x)
        return l2_normalize(out.float()).cpu().numpy()

    @property
    def embed_dim(self) -> int:
        return self.cfg.embed_dim


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
