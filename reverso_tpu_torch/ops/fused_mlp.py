"""Fused transformer MLP: the CUDA kernel and its plain version.

y = act(x @ W1^T + b1) @ W2^T + b2 with weights in PyTorch Linear layout
(W1 [H, W], W2 [W, H]). On a CUDA tensor `fused_mlp` launches
`csrc/fused_mlp.cu`, which streams the hidden dimension in chunks and
never writes the [T, H] hidden tensor to device memory; on a CPU tensor
it runs `mlp_ref`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

ACT_CODES = {"gelu": 0, "quick_gelu": 1}


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h, approximate="none")
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(act)


def mlp_ref(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain version: fp32 accumulation of dtype-rounded operands, bias
    added in fp32, h rounded to x's dtype before the second product."""
    h = torch.matmul(x.float(), w1.float().t()) + b1.float()
    h = _act(h, act).to(x.dtype)
    y = torch.matmul(h.float(), w2.float().t()) + b2.float()
    return y.to(x.dtype)


def fused_mlp(x, w1, b1, w2, b2, *, act: str = "gelu"):
    """Fused MLP over [..., T, W] inputs (leading dims flattened).

    The kernel's output is as wide as its input, so the MLP must be
    square: W1 [H, W], W2 [W, H]."""
    width = x.shape[-1]
    if w1.shape[1] != width or w2.shape[0] != width \
            or w1.shape[0] != w2.shape[1]:
        raise ValueError(
            f"fused_mlp requires a square MLP (w1 [H, {width}], "
            f"w2 [{width}, H]); got w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if act not in ACT_CODES:
        raise ValueError(act)
    shape = x.shape
    x2 = x.reshape(-1, width)
    if x.device.type == "cpu":
        return mlp_ref(x2, w1, b1, w2, b2, act=act).reshape(shape)
    if x.dtype not in kernels.DTYPE_CODES or any(
            t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise ValueError("fused_mlp: x, weights and biases must share one "
                         "dtype (float32 or bfloat16)")
    x2 = x2.contiguous()
    kernels.require_cuda("fused_mlp", x2, w1, b1, w2, b2)
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(shape)
    with torch.cuda.device(x.device):   # launch on the tensors' card
        status = kernels.lib().rv_fused_mlp(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), x2.shape[0], width, w1.shape[0],
            ACT_CODES[act], kernels.DTYPE_CODES[x.dtype],
            kernels.stream_ptr(x.device))
    kernels.check("fused_mlp", status)
    kernels.launches["fused_mlp"] += 1
    return out.reshape(shape)
