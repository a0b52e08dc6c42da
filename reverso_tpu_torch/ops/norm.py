"""Normalization helpers shared by embed + search paths."""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` in fp32 then cast back.

    Every embedding is normalized before storage and search, so cosine
    similarity reduces to a dot product. fp32 norm accumulation keeps bf16
    inputs stable.
    """
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(n, min=eps)).to(x.dtype)
