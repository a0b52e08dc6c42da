"""Normalization helpers shared by embed + search paths, and the vision
tower's fused residual + LayerNorm pass.

`add_layernorm` is one norm site of the tower: r = x + gamma * y (the
residual stream after a sublayer's output y, LayerScale's gamma where the
tower has one), then h = LayerNorm(r) computed in fp32 and cast back to
the activation dtype. `add_layernorm_ref` is the plain composition the
tower's modules ran, every rounding where they round it. On the card one
launch of `csrc/add_layernorm.cu` reads x and y and writes r and h, the
rule is `norm_route`'s; a call autograd records goes through
`AddLayerNormFunction`, whose backward is plain PyTorch. Without y it is a
LayerNorm alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .fused_mlp import _aligned

# widths the fused pass takes: 16-byte vectors, at most 12 a lane of a
# warp (`csrc/add_layernorm.cu`)
_VEC_BYTES, _MAX_VECS = 16, 12 * 32


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` in fp32 then cast back.

    Every embedding is normalized before storage and search, so cosine
    similarity reduces to a dot product. fp32 norm accumulation keeps bf16
    inputs stable.
    """
    x32 = x.float()
    n = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(n, min=eps)).to(x.dtype)


def add_layernorm_ref(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor,
                      bias: torch.Tensor, *, gamma: Optional[torch.Tensor] = None,
                      eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32):
    """(r, h): r = x + y * gamma.to(y.dtype) (x + y without gamma, x itself
    without y), h = layer_norm(r in `compute_dtype`, weight and bias in it)
    cast back to r's dtype."""
    if y is not None:
        if gamma is not None:
            y = y * gamma.to(y.dtype)
        x = x + y
    cd = compute_dtype
    h = F.layer_norm(x.to(cd), (x.shape[-1],), weight.to(cd), bias.to(cd), eps).to(x.dtype)
    return x, h


def norm_route(x: torch.Tensor, y: Optional[torch.Tensor], compute_dtype: torch.dtype) -> str:
    """"kernel", "plain" or "shape", from what the call can observe alone:
    "plain" on the CPU; on the card "kernel" where the kernel takes the
    activation dtype (bf16, fp32) and the width (W % 8 == 0, at most 12
    16-byte vectors a lane), else "shape" (the plain composition too).
    Grad mode does not enter: the fused pass has a backward."""
    if not x.is_cuda:
        return "plain"
    w = x.shape[-1]
    if (x.dtype not in kernels.DTYPE_CODES or compute_dtype != torch.float32
            or (y is not None and (y.dtype != x.dtype or y.shape != x.shape))
            or w % 8 != 0 or w * x.element_size() > _MAX_VECS * _VEC_BYTES):
        return "shape"
    return "kernel"


def add_layernorm(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: torch.Tensor, *, gamma: Optional[torch.Tensor] = None,
                  eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32):
    """`add_layernorm_ref`'s (r, h) over [..., W] (r is x where y is None):
    on the card one pass of the fused kernel, r bit for bit the plain one's
    and h within the order of its fp32 sums, through `AddLayerNormFunction`
    where autograd records the call; on the CPU the plain composition. A
    CUDA call the kernel does not take is counted in
    `kernels.plain_dispatches["norm_shape"]`."""
    route = norm_route(x, y, compute_dtype)
    if route != "kernel":
        if route == "shape":
            kernels.plain_dispatches["norm_shape"] += 1
        return add_layernorm_ref(x, y, weight, bias, gamma=gamma, eps=eps,
                                 compute_dtype=compute_dtype)
    if kernels.grad_recorded(x, y, weight, bias, gamma):
        out = AddLayerNormFunction.apply(x, y, weight, bias, gamma, eps)
        return (x, out) if y is None else out
    return _norm_launch(x, y, weight, bias, gamma, eps)


def _norm_launch(x, y, weight, bias, gamma, eps: float, stats: bool = False):
    """One launch of the fused pass: (r, h), r being x where y is None;
    with `stats` also each row's fp32 mean and 1 / sqrt(var + eps), shaped
    [..., 1] as `aten.native_layer_norm` returns them."""
    w = x.shape[-1]
    # 16-byte vector loads and stores: contiguous rows from an aligned base
    x, y = (None if t is None else _aligned(t.contiguous()) for t in (x, y))
    prm = [None if p is None else p.to(x.device, torch.float32).contiguous()
           for p in (weight, bias, gamma)]
    kernels.require_cuda("add_layernorm", *(t for t in (x, y, *prm) if t is not None))
    h = torch.empty_like(x)
    r = x if y is None else torch.empty_like(x)
    rows = x.numel() // w
    mean, rstd = ((torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
                   for _ in range(2)) if stats else (None, None))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):   # launch on the tensors' card
        status = kernels.lib().rv_add_layernorm(
            ptr(x), ptr(y), ptr(prm[2]), ptr(prm[0]), ptr(prm[1]),
            None if y is None else r.data_ptr(), h.data_ptr(), ptr(mean), ptr(rstd), rows, w,
            eps, kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x.device))
    kernels.check("add_layernorm", status)
    kernels.launches["add_layernorm"] += 1
    kernels.shape_launches[("add_layernorm", (rows, w, str(x.dtype).split(".")[-1],
                                              y is not None, gamma is not None))] += 1
    return (r, h, mean, rstd) if stats else (r, h)


class AddLayerNormFunction(torch.autograd.Function):
    """The fused pass with its gradient: the forward is one launch
    (`_norm_launch`, which also writes each row's mean and 1 / sqrt(var +
    eps)), the backward plain PyTorch, as the plain composition's autograd
    takes it: PyTorch's layer_norm backward over r in fp32 from those
    statistics, cast to r's dtype and added to r's incoming gradient; x
    gets that sum, y it times gamma (rounded to the activation dtype),
    gamma the sum over rows of it times y. Returns (r, h), or h alone where
    y is None (r is then x). On CPU tensors the forward is the plain
    composition with PyTorch's own statistics (for the tests). Arguments:
    x, y, weight, bias, gamma, eps."""

    @staticmethod
    def forward(ctx, x, y, weight, bias, gamma, eps):
        if x.device.type == "cpu":
            r = add_layernorm_ref(x, y, weight, bias, gamma=gamma)[0]
            h, mean, rstd = torch.ops.aten.native_layer_norm(
                r.float(), (r.shape[-1],), weight.float(), bias.float(), eps)
            h = h.to(r.dtype)
        else:
            r, h, mean, rstd = _norm_launch(x, y, weight, bias, gamma, eps, stats=True)
        ctx.residual = y is not None
        ctx.save_for_backward(r, mean, rstd, weight, bias, gamma,
                              y if gamma is not None else None)
        return (r, h) if ctx.residual else h

    @staticmethod
    def backward(ctx, *grads):
        r, mean, rstd, weight, bias, gamma, y = ctx.saved_tensors
        dr, dh = grads if ctx.residual else (None, grads[0])
        need = ctx.needs_input_grad
        d, dw, db = torch.ops.aten.native_layer_norm_backward(
            dh.float(), r.float(), (r.shape[-1],), mean, rstd, weight.float(), bias.float(),
            (True, need[2], need[3]))
        d = d.to(r.dtype)
        if dr is not None:
            d = dr + d
        dy = dgamma = None
        if ctx.residual and need[1]:
            dy = d if gamma is None else d * gamma.to(d.dtype)
        if gamma is not None and need[4]:
            dgamma = (d * y).sum_to_size(gamma.shape).to(gamma.dtype)
        return (d if need[0] else None, dy, None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype), dgamma, None)
