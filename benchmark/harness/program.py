"""What the benchmark takes from the program: its configuration object
and its counters. Everything else of the program is reached through the
entries a cell drives."""
from __future__ import annotations

import collections
import dataclasses
import os

from .cell import ROOT

# the configuration file's keys that the program's ModelConfig takes
MODEL_KEYS = ("image_size", "patch_size", "width", "depth", "num_heads", "mlp_ratio",
              "embed_dim", "use_cls_token", "pool_type", "use_rope", "use_abs_pos",
              "use_ln_post", "layer_scale_init", "dtype", "param_dtype", "norm_dtype")


def outside_checkout():
    """None where the program imports from this checkout, else what was
    found: a run measures the code beside it, never an installed copy."""
    try:
        import reverso_tpu_torch
    except ImportError as e:
        return f"the program is not in this checkout: {e}"
    where = os.path.dirname(os.path.abspath(reverso_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        return f"reverso_tpu_torch imports from {where}, not from the checkout {ROOT}"
    return None


def model_config(cfg: dict, **changes):
    from reverso_tpu_torch.config import ModelConfig

    mc = ModelConfig(name=cfg["name"], **{k: cfg[k] for k in MODEL_KEYS})
    return dataclasses.replace(mc, **changes) if changes else mc


def counters() -> tuple:
    """Copies of the program's launch counters."""
    from reverso_tpu_torch import kernels

    return (dict(kernels.launches), collections.Counter(kernels.shape_launches),
            dict(kernels.plain_dispatches))


def counted_since(before: tuple) -> tuple:
    """The counters' growth since `before`: (launches, shape launches,
    plain dispatches)."""
    now = counters()
    launches = {k: v - before[0].get(k, 0) for k, v in now[0].items() if v - before[0].get(k, 0)}
    shapes = {k: v - before[1].get(k, 0) for k, v in now[1].items() if v - before[1].get(k, 0)}
    plain = {k: v - before[2].get(k, 0) for k, v in now[2].items()}
    return launches, shapes, plain


def build_seconds() -> float:
    """Seconds this process spent building the kernel library (0 where the
    checkout's build was current)."""
    from reverso_tpu_torch import kernels

    kernels.lib()
    return kernels.build_seconds
