"""Dynamic int8 quantization: the quantizers and the int8 linear layer.

Weights are quantized per output unit, activations per row on the fly,
both symmetric to +-127. The quantizers carry the JAX package's exact
arithmetic, so they agree with it bit for bit: `127 / amax` is computed
once and multiplied in (a division per element could land one ulp off at
a halfway point), rounding is half to even, amax is floored at 1e-30,
and the two scales differ in form: a weight's is `amax / 127`, a row's
`amax * (1 / 127)`.

Weights here are in PyTorch's Linear layout ([out, in]), so "per output
unit" is per row of the weight; the JAX package's [in, out] kernels are
quantized per column, which is the same set of numbers.

`int8_linear` has no kernel of its own: its s8 x s8 -> s32 product is
`torch._int_mm` on the card and an int32 matmul on the CPU, both exact.
"""
from __future__ import annotations

from typing import Optional

import torch

from .topk import INT8_D_MAX

_AMAX_FLOOR = 1e-30


def fdiv(a, b) -> torch.Tensor:
    """a / b correctly rounded, elementwise. PyTorch computes `c / t` as
    `t.reciprocal() * c`, and on the card divides by a Python number as a
    multiply by its reciprocal: one rounding more than the reference's
    division, so both operands are made tensors of one shape."""
    a = a if isinstance(a, torch.Tensor) else torch.full_like(b, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(a, b)
    return torch.div(a, b)


def quantize_weight_int8(w: torch.Tensor):
    """Per-output-unit symmetric int8 quantization of a Linear weight.

    w [out, in] -> (w8 [out, in] int8, scale [out] f32), w ~= w8 * scale."""
    w32 = w.float()
    amax = torch.clamp(w32.abs().amax(dim=1, keepdim=True), min=_AMAX_FLOOR)
    w8 = torch.clamp(torch.round(w32 * fdiv(127.0, amax)), -127, 127).to(torch.int8)
    return w8, fdiv(amax, 127.0)[:, 0]


def quantize_rows_int8(x: torch.Tensor):
    """Per-row dynamic symmetric int8 quantization over the last dim.

    Returns (x8 [..., d] int8, scale [..., 1] f32)."""
    x32 = x.float()
    amax = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=_AMAX_FLOOR)
    x8 = torch.clamp(torch.round(x32 * fdiv(127.0, amax)), -127, 127).to(torch.int8)
    return x8, amax * (1.0 / 127.0)


def _int_mm_ok(m: int, k: int, n: int) -> bool:
    """torch._int_mm's shape rules on CUDA: more than 16 rows, k a multiple
    of 8 and at least 16, n a multiple of 8."""
    return m > 16 and k >= 16 and k % 8 == 0 and n % 8 == 0


def int_dot(a8: torch.Tensor, b8: torch.Tensor, *, int_mm: bool = False) -> torch.Tensor:
    """Exact s32 product of a8 [M, K] and b8 [N, K] int8 (b transposed).

    CPU: an int32 matmul. CUDA: `torch._int_mm` where it is asked for and
    its shape rules hold, else fp32 matmuls over slices of at most
    INT8_D_MAX of K (every partial sum of integer-valued operands stays an
    integer below 2^24, exact with or without TF32), summed in int32."""
    if a8.device.type == "cpu":
        return torch.matmul(a8.int(), b8.int().t())
    m, k = a8.shape
    if int_mm and _int_mm_ok(m, k, b8.shape[0]):
        return torch._int_mm(a8.contiguous(), b8.t().contiguous())
    out = None
    for lo in range(0, k, INT8_D_MAX):
        hi = min(k, lo + INT8_D_MAX)
        part = torch.matmul(a8[:, lo:hi].float(), b8[:, lo:hi].float().t()).int()
        out = part if out is None else out + part
    return out


def int8_linear(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                b: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """y = x @ dequant(w8)^T + b with one s8 product.

    w8 [out, in] int8 and w_scale [out] from `quantize_weight_int8`; x is
    quantized per row on the fly; the s32 dot is dequantized in f32 as
    dot * (row_scale * col_scale), then the bias is added. Output dtype
    defaults to x's."""
    out_dtype = out_dtype or x.dtype
    shape = x.shape
    x8, xs = quantize_rows_int8(x.reshape(-1, shape[-1]))
    y = int_dot(x8, w8, int_mm=True).float() * (xs * w_scale.float()[None, :])
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype).reshape(*shape[:-1], w8.shape[0])
