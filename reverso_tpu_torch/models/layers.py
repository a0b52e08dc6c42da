"""Layers shared by the detector's towers (Swin, BERT, GroundingDINO, SAM).

They keep the JAX package's conventions, so its flax trees load by name
(`models.convert.params_from_flax`) and both packages compute the same
thing: activations are channels-last (NHWC for maps), parameters are
fp32 and cast to the activation dtype at use, and normalisations compute
in fp32 and cast back. A parameter that is neither a layer's weight nor
its bias is made by `new_param`, which records the flax initialiser that
`init_weights` draws it from.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .vit import Linear, _lecun_normal_


def new_param(shape, init: str = "zeros", std: float = 1.0) -> nn.Parameter:
    """A parameter with its flax initialiser: "zeros", "ones",
    ("normal", std) or ("const", value)."""
    p = nn.Parameter(torch.zeros(*shape))
    p.flax_init = (init, std)
    return p


class LayerNorm32(nn.Module):
    """LayerNorm over the last axis in fp32, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class GroupNorm32(nn.Module):
    """GroupNorm of an NHWC map in fp32, cast back to the input dtype."""

    def __init__(self, dim: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class Conv2d(nn.Module):
    """Convolution of an NHWC map; weight OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2d(nn.Module):
    """Transposed convolution of an NHWC map; weight [in, out, kh, kw] as
    torch's ConvTranspose2d keeps it."""

    def __init__(self, cin: int, cout: int, kernel: int, *, stride: int):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=self.stride)
        return y.permute(0, 2, 3, 1)


class Embed(nn.Module):
    def __init__(self, num: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num, dim))

    def forward(self, ids, dtype):
        return F.embedding(ids, self.weight).to(dtype)


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded init after the flax initialisers, drawn in module order from
    `gen` (a CPU generator: initialise before moving to the device):
    lecun-normal Dense/Conv kernels and embeddings, zero biases, unit
    norms, and each `new_param` from its recorded initialiser."""
    for m in module.modules():
        if isinstance(m, Linear):
            m.reset_parameters(gen)
        elif isinstance(m, Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, ConvTranspose2d):
            w = m.weight
            _lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], gen)
        elif isinstance(m, Embed):
            _lecun_normal_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, (LayerNorm32, GroupNorm32)):
            m.weight.fill_(1.0)
        if isinstance(m, (Conv2d, ConvTranspose2d, LayerNorm32, GroupNorm32)) \
                and m.bias is not None:
            m.bias.zero_()
        for p in m.parameters(recurse=False):
            init = getattr(p, "flax_init", None)
            if init is None:
                continue
            kind, std = init
            if kind == "zeros":
                p.zero_()
            elif kind == "ones":
                p.fill_(1.0)
            elif kind == "const":
                p.fill_(std)
            elif kind == "normal":
                p.normal_(0.0, std, generator=gen)
            else:
                raise ValueError(f"unknown initialiser {kind!r}")


def attend(q, k, v, mask_bias=None):
    """Plain [..., S, D] attention as the JAX towers write it: scores in
    the input dtype, cast to fp32 and divided by sqrt(D), plus an fp32
    additive bias; fp32 softmax; p in the input dtype for the PV product."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
    if mask_bias is not None:
        s = s + mask_bias
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)
