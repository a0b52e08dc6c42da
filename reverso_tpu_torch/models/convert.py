"""Parameter bridge between the JAX package's flax trees and this package's
state dicts.

The flax `VisionTransformer` tree (nested dict of arrays, e.g. the output
of `reverso_tpu.models.convert.convert_vision_tower` or of a flax `init`)
maps onto `models.vit.VisionTransformer` by name:

  * `block{i}` -> `blocks.{i}`;
  * Dense `kernel` [in, out] -> Linear `weight` [out, in];
  * Conv `kernel` HWIO -> `weight` OIHW;
  * LayerNorm `scale` -> `weight`; biases, gammas, cls/pos/probe as they are.

Both directions are exact (transposes only), so the two packages run the
same weights.
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
    """Flax vision-tower tree -> state dict of fp32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params_np):
        *mods, name = path
        mods = [f"blocks.{_BLOCK.match(m).group(1)}" if _BLOCK.match(m) else m
                for m in mods]
        arr = np.asarray(leaf, np.float32)
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


def flax_params_from_vision(state_dict: Mapping[str, Any]) -> dict:
    """Inverse of `vision_params_from_flax`: state dict -> flax tree of
    fp32 numpy arrays."""
    norm_mods = {"ln", "ln1", "ln2", "ln_pre", "ln_post"}
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
