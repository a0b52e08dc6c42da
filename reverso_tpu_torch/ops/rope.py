"""2D axial rotary position embedding for ViT patch grids.

PE-Core applies rotary embeddings over the 2D patch grid. Convention:

  * head_dim D splits in half: first half rotates with the patch's x
    coordinate, second half with y;
  * each half uses D/4 frequency pairs with the usual geometric spacing;
  * the class token (sequence position 0 when present) gets the identity
    rotation (cos=1, sin=0).

The tables are numpy, identical to the JAX package's, so both packages
rotate by the same constants.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def rope_2d_tables(grid: int, head_dim: int, *, cls_token: bool = True,
                   base: float = 10000.0):
    """Precompute (cos, sin) tables, each [S, head_dim] float32 numpy."""
    assert head_dim % 4 == 0, "head_dim must be divisible by 4 for 2D rope"
    d_axis = head_dim // 2           # dims per axis
    n_freq = d_axis // 2             # rotation pairs per axis
    freqs = base ** (-np.arange(n_freq, dtype=np.float64) * 2 / d_axis)

    pos = np.arange(grid * grid)
    px, py = pos % grid, pos // grid
    ang_x = px[:, None] * freqs[None, :]       # [P, n_freq]
    ang_y = py[:, None] * freqs[None, :]
    # pair layout: [x pairs | y pairs], each pair duplicated (rotate-half)
    ang = np.concatenate([ang_x, ang_x, ang_y, ang_y], axis=1)  # [P, D]
    cos, sin = np.cos(ang), np.sin(ang)
    if cls_token:
        cos = np.concatenate([np.ones((1, head_dim)), cos], axis=0)
        sin = np.concatenate([np.zeros((1, head_dim)), sin], axis=0)
    return cos.astype(np.float32), sin.astype(np.float32)


def _rotate_half_axial(x: torch.Tensor) -> torch.Tensor:
    """Rotate within each axis half: [a, b | c, d] -> [-b, a | -d, c]."""
    q = x.shape[-1] // 4
    a, b, c, e = x[..., :q], x[..., q:2 * q], x[..., 2 * q:3 * q], x[..., 3 * q:]
    return torch.cat([-b, a, -e, c], dim=-1)


def wide(x: torch.Tensor) -> torch.Tensor:
    """x widened to fp32 for a plain version's arithmetic; float64 stays
    float64 (`gradcheck` runs the plain versions in float64)."""
    return x if x.dtype == torch.float64 else x.float()


def rotate(x: torch.Tensor, cos, sin, scale: float = 1.0) -> torch.Tensor:
    """fp32 rotation of x [..., S, D] by cos/sin [S, D], times `scale`,
    rounded back to x's dtype (float64 rotates in float64)."""
    cos = torch.as_tensor(cos, dtype=torch.float32, device=x.device)
    sin = torch.as_tensor(sin, dtype=torch.float32, device=x.device)
    x32 = wide(x)
    out = x32 * cos + _rotate_half_axial(x32) * sin
    if scale != 1.0:
        out = out * scale
    return out.to(x.dtype)


def apply_rope_2d(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x: [B, H, S, D]; cos/sin: [S, D]. fp32 rotation, cast back."""
    return rotate(x, cos, sin)
