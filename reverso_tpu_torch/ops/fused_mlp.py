"""Fused transformer MLP: the CUDA kernels and their plain versions.

y = act(x @ W1^T + b1) @ W2^T + b2 with weights in PyTorch Linear layout
(W1 [H, W], W2 [W, H]). On a CPU tensor `fused_mlp` runs `mlp_ref`; on a
CUDA tensor it launches the wgmma + TMA GEMMs of `csrc/fused_mlp.cu`, by
the rule in `mlp_route`: bf16 goes to two GEMMs with fused epilogues (h =
bf16(act(x W1^T + b1)) through a bf16 scratch of [T, H], then y = bf16(h
W2^T + b2)), at widths that are not multiples of 8 through zero-padded
copies the split pass makes; fp32 to the same GEMMs on three bf16 parts a
value (the TPU kernel's Precision.HIGHEST: six bf16 products summed in
fp32, h kept in fp32 as its three parts). The weights' parts come from
`split_mlp_weights` (the tower makes them once) or, without them, from
the split pass on every call. `mlp_split_ref` spells the fp32 contract
out.

`fused_mlp(..., quant=True)` is the int8 mode (`ModelConfig.quant="int8"`):
x is quantized per row, the weights per output unit (after the cast to
x's dtype), both products run s8 x s8 -> s32, and the hidden activation
is re-quantized per (row, 512-wide hidden chunk): the chunk is part of
the function, not a tiling choice. The order of the arithmetic is
`f32(s32) * (xs * s1) + b1`, the activation, the quantization, then
`acc += f32(s32) * (hs * s2)` chunk by chunk in hidden order, and
`(acc + b2)` cast to x's dtype. gelu is the Abramowitz & Stegun erf
polynomial here, as in the JAX package's int8 kernel: one ulp at a
rounding boundary flips an int8 quantum. `mlp_int8_ref` spells that out;
`fused_mlp_int8` takes weights quantized once (`quantize_mlp_weights`)
and on a CUDA tensor launches the int8 kernels (a row quantizer, then two
s8 wgmma + TMA GEMMs through int8 scratch of the call's shape); weights
at an unaligned base are copied first.

Gradients: with grad mode on and an input that requires grad, a CUDA call
of `fused_mlp` goes through `FusedMLPFunction`. Its forward is the launch
above; its backward launches a kernel of `csrc/fused_mlp_bwd.cu` by the
rule in `mlp_bwd_route` (bf16: `rv_fused_mlp_bwd_tc` on wgmma + TMA; fp32:
`rv_fused_mlp_bwd_split`, the same kernel on three bf16 parts a value, the
forward's weight parts reused), which recomputes z = x W1^T + b1, writes h
= act(z) and dz = (dY W2) * act'(z) and db1's partial column sums, and
leaves the three weight-sized products and the other sums to
`torch.matmul` and `sum`. `mlp_grad_ref` is its plain version, and
`mlp_grad_split_ref` spells out the fp32 route's arithmetic. The int8
mode (K5) has no gradient on the card yet (ROADMAP queue 1 item 20c): a
CUDA call under grad raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .quant import int_dot, quantize_rows_int8, quantize_weight_int8
from .rope import wide
from .split import round_pitch, split_matmul, split_parts

ACT_CODES = {"gelu": 0, "quick_gelu": 1}
# the int8 mode's hidden re-quantization unit (the JAX kernel's hidden_tile)
HIDDEN_CHUNK = 512
# the int8 kernel's row pitch unit in bytes (TMA's 16-byte row strides)
_Q8_PITCH = 16


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h, approximate="none")
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(act)


def mlp_ref(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain version: fp32 accumulation of dtype-rounded operands, bias
    added in fp32, h rounded to x's dtype before the second product
    (float64 computes in float64, for `gradcheck`)."""
    h = torch.matmul(wide(x), wide(w1).t()) + wide(b1)
    h = _act(h, act).to(x.dtype)
    y = torch.matmul(wide(h), wide(w2).t()) + wide(b2)
    return y.to(x.dtype)


def mlp_grad_ref(x, w1, b1, w2, b2, dy, act: str = "gelu"):
    """Plain version of K4's gradient: `torch.autograd.grad` of `mlp_ref`
    against the output gradient `dy`. Returns (dx, dw1, db1, dw2, db2),
    each in its input's dtype."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_(True) for t in (x, w1, b1, w2, b2))
        y = mlp_ref(*ins, act=act)
        return torch.autograd.grad(y, ins, dy.to(y.dtype))


def mlp_split_ref(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain version of the fp32 mode on the tensor cores: both products as
    the six bf16 products of three-way splits (`split_matmul`), the bias
    added in fp32, gelu through the Abramowitz & Stegun erf as the TPU
    kernel computes it, h kept in fp32. Used by the tests and
    `chip_smoke.py` against the kernel; no path of the port calls it."""
    h = split_matmul(x.float(), w1.float().t()) + b1.float()
    h = _act_poly(h, act)
    return split_matmul(h, w2.float().t()) + b2.float()


def _act_grad(z: torch.Tensor, act: str) -> torch.Tensor:
    """act'(z) in fp32, as the backward kernels compute it: the exact-erf
    GELU's cdf(z) + z pdf(z), or quick-GELU's s + 1.702 z s (1 - s) with s =
    sigmoid(1.702 z)."""
    if act == "gelu":
        return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) \
            + z * 0.3989422804014327 * torch.exp(-0.5 * z * z)
    if act == "quick_gelu":
        sg = torch.sigmoid(1.702 * z)
        return sg + 1.702 * z * sg * (1.0 - sg)
    raise ValueError(act)


def mlp_grad_split_ref(x, w1, b1, w2, b2, dy, act: str = "gelu"):
    """Plain version of the fp32 backward route's arithmetic
    (`rv_fused_mlp_bwd_split`, then the wrapper's products) on [T, W] rows;
    returns (dx, dw1, db1, dw2, db2) in fp32. Inside the kernel: z = x W1^T +
    b1 and g = dY W2, each as the six bf16 products of three-way splits
    (`split_matmul`), h = act(z) (the exact erf GELU) and dz = g * act'(z)
    in fp32, db1 = dz's column sums; then the plain fp32 products dW2 = dY^T
    h, dW1 = dz^T x and dx = dz W1 and db2 = dY's column sums. Used by the
    tests and `chip_smoke.py` against the kernel; no path of the port calls
    it."""
    x, w1, b1, w2, dy = (t.float() for t in (x, w1, b1, w2, dy))
    z = split_matmul(x, w1.t()) + b1
    g = split_matmul(dy, w2)
    h = _act(z, act)
    dz = g * _act_grad(z, act)
    return (torch.matmul(dz, w1), torch.matmul(dz.t(), x), dz.sum(0),
            torch.matmul(dy.t(), h), dy.sum(0))


def mlp_route(device_type: str, dtype: torch.dtype, width: int, hidden: int) -> str:
    """Which implementation serves a fused MLP call: "plain" for CPU
    tensors; on the card "tensor_core" for bf16 (the two wgmma + TMA GEMMs;
    widths and hidden sizes that are not multiples of 8, TMA's 16-byte row
    strides, through zero-padded copies: "tensor_core_padded"), "split"
    for fp32 (the same GEMMs on three bf16 parts a value). A rule between
    kernels by dtype and shape, not a fallback."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.float32:
        return "split"
    if width % 8 == 0 and hidden % 8 == 0:
        return "tensor_core"
    return "tensor_core_padded"


def mlp_bwd_route(device_type: str, dtype: torch.dtype, width: int, hidden: int) -> str:
    """Which implementation serves the backward of a fused MLP call:
    "plain" for CPU tensors; on the card "tensor_core" for bf16 (the wgmma +
    TMA kernel; widths and hidden sizes that are not multiples of 8 through
    zero-padded copies: "tensor_core_padded"), "split" for fp32 (the same
    kernel on three bf16 parts a value, at any width). A rule between
    kernels by dtype and shape, not a fallback."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.float32:
        return "split"
    if width % 8 == 0 and hidden % 8 == 0:
        return "tensor_core"
    return "tensor_core_padded"


def _check_square(x, w1, w2) -> int:
    width = x.shape[-1]
    if w1.shape[1] != width or w2.shape[0] != width \
            or w1.shape[0] != w2.shape[1]:
        raise ValueError(
            f"fused_mlp requires a square MLP (w1 [H, {width}], "
            f"w2 [{width}, H]); got w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    return width


class SplitMLPWeights(NamedTuple):
    """An fp32 MLP's weights as the split pass's bf16 parts, in Linear
    layout with K padded to a pitch of 8 (`ops/split.py`)."""
    w1: torch.Tensor   # [3, H, Wp] bf16
    w2: torch.Tensor   # [3, W, Hp] bf16


def split_mlp_weights(w1, w2) -> SplitMLPWeights:
    """The weights' parts for the fp32 mode: hi, mid and lo of W1 [H, W]
    and W2 [W, H], made once by the split pass (the tower caches them)."""
    return SplitMLPWeights(split_parts(w1.float(), 3), split_parts(w2.float(), 3))


def _aligned(t: torch.Tensor, align: int = 16) -> torch.Tensor:
    """t itself where its base is aligned, else a copy (a fresh allocation
    is): the copy only where TMA or a vector load needs it."""
    return t.clone() if t.data_ptr() % align else t


def _launch_tc(x2, w1, b1, w2, b2, act: str) -> torch.Tensor:
    """The two bf16 GEMMs on [T, W] rows at W, H % 8 == 0."""
    t, width, hidden = x2.shape[0], x2.shape[1], w1.shape[0]
    out = torch.empty_like(x2)
    h = torch.empty((t, hidden), dtype=x2.dtype, device=x2.device)
    with torch.cuda.device(x2.device):   # launch on the tensors' card
        status = kernels.lib().rv_fused_mlp_tc(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            h.data_ptr(), out.data_ptr(), t, width, hidden, ACT_CODES[act],
            kernels.stream_ptr(x2.device))
    kernels.check("fused_mlp", status)
    return out


def _no_grad_on_card(name: str, *tensors) -> None:
    """The int8 mode has no backward kernel: a CUDA call that autograd
    would record raises instead of returning an output without a
    gradient."""
    if tensors[0].device.type != "cpu" and kernels.grad_recorded(*tensors):
        raise NotImplementedError(
            f"{name}: the int8 MLP (K5) has no gradient on the card yet "
            f"(ROADMAP queue 1 item 20c); train with quant='none'")


def fused_mlp(x, w1, b1, w2, b2, *, act: str = "gelu", quant: bool = False,
              parts: Optional[SplitMLPWeights] = None):
    """Fused MLP over [..., T, W] inputs (leading dims flattened).

    The kernel's output is as wide as its input, so the MLP must be
    square: W1 [H, W], W2 [W, H]. `quant=True` runs the int8 mode, with
    the weights quantized on this call (the tower quantizes once and
    calls `fused_mlp_int8`). In fp32 on the card, `parts` are the weights'
    bf16 parts from `split_mlp_weights(w1, w2)` (without them the split
    pass makes them on this call). Any view is taken: x is made
    contiguous, and a base TMA cannot take is copied. On the card, a call
    autograd records goes through `FusedMLPFunction` (its backward is a
    kernel too; `parts` get no gradient)."""
    width = _check_square(x, w1, w2)
    if act not in ACT_CODES:
        raise ValueError(act)
    if quant:
        _no_grad_on_card("fused_mlp", x, w1, b1, w2, b2)
        return fused_mlp_int8(x, quantize_mlp_weights(w1, b1, w2, b2, x.dtype), act=act)
    shape = x.shape
    x2 = x.reshape(-1, width)
    hidden = w1.shape[0]
    route = mlp_route(x.device.type, x.dtype, width, hidden)
    if route == "plain":
        return mlp_ref(x2, w1, b1, w2, b2, act=act).reshape(shape)
    if x.dtype not in kernels.DTYPE_CODES or any(
            t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise ValueError("fused_mlp: x, weights and biases must share one "
                         "dtype (float32 or bfloat16)")
    if kernels.grad_recorded(x2, w1, b1, w2, b2):
        return FusedMLPFunction.apply(x2, w1, b1, w2, b2, act, parts).reshape(shape)
    return _mlp_launch(x2, w1, b1, w2, b2, act, parts).reshape(shape)


def _mlp_launch(x2, w1, b1, w2, b2, act: str, parts: Optional[SplitMLPWeights]):
    """K4's forward on the card over [T, W] rows by `mlp_route`."""
    width, hidden = x2.shape[1], w1.shape[0]
    route = mlp_route(x2.device.type, x2.dtype, width, hidden)
    x2 = x2.contiguous()
    w1, b1, w2, b2 = (t.contiguous() for t in (w1, b1, w2, b2))
    kernels.require_cuda("fused_mlp", x2, w1, b1, w2, b2)
    t = x2.shape[0]
    if t == 0:
        return torch.empty_like(x2)
    if route == "split":
        wp, hp = round_pitch(width), round_pitch(hidden)
        if parts is None:
            parts = split_mlp_weights(w1, w2)
        elif parts.w1.shape != (3, hidden, wp) or parts.w2.shape != (3, width, hp):
            raise ValueError(f"fused_mlp: weight parts {tuple(parts.w1.shape)}, "
                             f"{tuple(parts.w2.shape)} do not fit W {width}, H {hidden}")
        kernels.require_cuda("fused_mlp", x2, *parts)
        out = torch.empty_like(x2)
        # scratch, made for this call's shape: x's and h's parts
        xp = torch.empty((3, t, wp), dtype=torch.bfloat16, device=x2.device)
        hpart = torch.empty((3, t, hp), dtype=torch.bfloat16, device=x2.device)
        w1p, w2p = (_aligned(p) for p in parts)
        with torch.cuda.device(x2.device):   # launch on the tensors' card
            status = kernels.lib().rv_fused_mlp_split(
                x2.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(),
                xp.data_ptr(), hpart.data_ptr(), out.data_ptr(), t, width, hidden,
                ACT_CODES[act], kernels.stream_ptr(x2.device))
        kernels.check("fused_mlp", status)
        kernels.launches["fused_mlp_split"] += 1
        kernels.shape_launches[("fused_mlp_split", (t, width, hidden))] += 1
    elif route == "tensor_core":
        # TMA and 16-byte stores: 16-byte aligned x and weights, 4-byte
        # aligned biases (read as bf16 pairs)
        x2, w1, w2 = _aligned(x2), _aligned(w1), _aligned(w2)
        b1, b2 = _aligned(b1, 4), _aligned(b2, 4)
        out = _launch_tc(x2, w1, b1, w2, b2, act)
        kernels.launches["fused_mlp_tc"] += 1
        kernels.shape_launches[("fused_mlp_tc", (t, width, hidden, act))] += 1
    else:
        # widths TMA cannot take: x and the weights zero-padded to a pitch of
        # 8 by the split pass's one-part form, the biases by zeros; the pad
        # columns of h are act(0) = 0 against zero columns of W2
        wp, hp = round_pitch(width), round_pitch(hidden)
        xp = split_parts(x2, 1)[0]
        w1p = split_parts(w1, 1, out_rows=hp)[0]
        w2p = split_parts(w2, 1, out_rows=wp)[0]
        b1p, b2p = F.pad(b1, (0, hp - hidden)), F.pad(b2, (0, wp - width))
        out = _launch_tc(xp, w1p, b1p, w2p, b2p, act)[:, :width].contiguous()
        kernels.launches["fused_mlp_tc"] += 1
        kernels.shape_launches[("fused_mlp_tc", (t, width, hidden, act))] += 1
    kernels.launches["fused_mlp"] += 1
    return out


def _mlp_bwd_launch(x2, w1, b1, w2, dy2, act: str,
                    parts: Optional[SplitMLPWeights] = None):
    """K4's backward kernel on the card, by `mlp_bwd_route`: h = act(z) and
    dz = (dY W2) * act'(z), both [T, H] in x's dtype, from z = x W1^T + b1
    recomputed inside the kernel, and db1 = the column sums of dz in fp32,
    from the kernel's per-128-row-tile column sums, [ceil(T / 128), H] fp32,
    which `sum(0)` adds in a fixed order. In bf16 (`rv_fused_mlp_bwd_tc`) at
    W or H % 8 != 0 it runs on zero-padded copies, as the forward's
    "tensor_core_padded" route: the pad columns of x, dY and W1 add nothing
    to either product, and the pad columns of h, dz and db1 are cut off. In
    fp32 (`rv_fused_mlp_bwd_split`) it reads the weights' bf16 parts
    (`parts`, the forward's; without them the split pass makes them on this
    call) and splits x and dY itself into scratch of the call's shape; h
    and dz come back at a pitch of H rounded up to 8 and are cut to H."""
    t, width = x2.shape
    hidden = w1.shape[0]
    dy2 = dy2.to(x2.dtype)
    route = mlp_bwd_route(x2.device.type, x2.dtype, width, hidden)
    wp, hp = width, hidden
    if route != "tensor_core":
        wp, hp = round_pitch(width), round_pitch(hidden)
    if route == "tensor_core_padded":
        x2, dy2 = F.pad(x2, (0, wp - width)), F.pad(dy2, (0, wp - width))
        w1, b1 = F.pad(w1, (0, wp - width, 0, hp - hidden)), F.pad(b1, (0, hp - hidden))
        w2 = F.pad(w2, (0, hp - hidden, 0, wp - width))
    x2, dy2 = _aligned(x2.contiguous()), _aligned(dy2.contiguous())
    w1, w2 = _aligned(w1.contiguous()), _aligned(w2.contiguous())
    b1 = b1.contiguous()
    kernels.require_cuda("fused_mlp backward", x2, w1, b1, w2, dy2)
    h = torch.empty((t, hp), dtype=x2.dtype, device=x2.device)
    dz = torch.empty_like(h)
    part = torch.empty((-(-t // 128), hp), dtype=torch.float32, device=x2.device)
    if t:
        if route == "split":
            if parts is None:
                parts = split_mlp_weights(w1, w2)
            elif parts.w1.shape != (3, hidden, wp) or parts.w2.shape != (3, width, hp):
                raise ValueError(f"fused_mlp backward: weight parts {tuple(parts.w1.shape)}, "
                                 f"{tuple(parts.w2.shape)} do not fit W {width}, H {hidden}")
            w1p, w2p = (_aligned(p) for p in parts)
            kernels.require_cuda("fused_mlp backward", x2, w1p, w2p)
            # scratch, made for this call's shape: x's and dY's parts
            xp, dyp = (torch.empty((3, t, wp), dtype=torch.bfloat16, device=x2.device)
                       for _ in range(2))
            with torch.cuda.device(x2.device):   # launch on the tensors' card
                status = kernels.lib().rv_fused_mlp_bwd_split(
                    x2.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                    dy2.data_ptr(), xp.data_ptr(), dyp.data_ptr(), h.data_ptr(), dz.data_ptr(),
                    part.data_ptr(), t, width, hidden, ACT_CODES[act], wp, hp,
                    kernels.stream_ptr(x2.device))
        else:
            with torch.cuda.device(x2.device):   # launch on the tensors' card
                status = kernels.lib().rv_fused_mlp_bwd_tc(
                    x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    dy2.data_ptr(), h.data_ptr(), dz.data_ptr(), part.data_ptr(), t, wp, hp,
                    ACT_CODES[act], kernels.stream_ptr(x2.device))
        kernels.check("fused_mlp backward", status)
        kernels.launches["fused_mlp_bwd"] += 1
        kernels.launches["fused_mlp_bwd_split" if route == "split" else "fused_mlp_bwd_tc"] += 1
        kernels.shape_launches[("fused_mlp_bwd", (t, width, hidden, act,
                                                  str(x2.dtype)))] += 1
    db1 = part.sum(0)
    if hp != hidden:
        h, dz, db1 = h[:, :hidden].contiguous(), dz[:, :hidden].contiguous(), db1[:hidden]
    return h, dz, db1


class FusedMLPFunction(torch.autograd.Function):
    """K4 with its gradient over [T, W] rows: the forward launches K4
    (`_mlp_launch`), the backward the kernel `mlp_bwd_route` picks for h,
    dz and db1 (`_mlp_bwd_launch`), then dW2 = dY^T h, dW1 = dz^T x and dx =
    dz W1 as `torch.matmul` (plain products, as XLA's dots of the autodiff
    in JAX) and db2 as a column sum in fp32. It saves x, W1, b1 and W2 and
    recomputes z in the backward. The gradients go to the tensors passed in
    (the tower passes its parameters cast to the activation dtype);
    `parts`, the fp32 route's cached bf16 parts, get none, and the fp32
    backward reads them again (the weights do not change between a
    forward and its backward). On CPU tensors
    the forward and the backward are the plain versions (for `gradcheck`).
    Arguments after b2: the activation and the fp32 route's weight parts or
    None."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, act, parts):
        ctx.act, ctx.parts = act, parts
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return mlp_ref(x2, w1, b1, w2, b2, act=act)
        return _mlp_launch(x2, w1, b1, w2, b2, act, parts)

    @staticmethod
    def backward(ctx, dy):
        x2, w1, b1, w2, b2 = ctx.saved_tensors
        if x2.device.type == "cpu":
            return (*mlp_grad_ref(x2, w1, b1, w2, b2, dy, act=ctx.act), None, None)
        need = ctx.needs_input_grad
        dy = dy.to(x2.dtype)
        h, dz, db1 = _mlp_bwd_launch(x2, w1, b1, w2, dy, ctx.act, ctx.parts)
        dx = torch.matmul(dz, w1) if need[0] else None
        dw1 = torch.matmul(dz.t(), x2) if need[1] else None
        db1 = db1.to(b1.dtype) if need[2] else None
        dw2 = torch.matmul(dy.t(), h) if need[3] else None
        db2 = dy.sum(0, dtype=torch.float32).to(b2.dtype) if need[4] else None
        return dx, dw1, db1, dw2, db2, None, None


# ---------------------------------------------------------------------------
# int8 mode (K5)
# ---------------------------------------------------------------------------

def gelu_exactish(x: torch.Tensor) -> torch.Tensor:
    """erf-based gelu through the Abramowitz & Stegun 7.1.26 polynomial
    (|err| <= 1.5e-7 in erf), op for op as the JAX package's int8 kernel
    and csrc/fused_mlp.cu compute it."""
    z = x * 0.7071067811865476
    sign = torch.sign(z)
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    erf = sign * (1.0 - poly * torch.exp(-az * az))
    return 0.5 * x * (1.0 + erf)


def _act_poly(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return gelu_exactish(h)
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    raise ValueError(act)


class Int8MLPWeights(NamedTuple):
    """An MLP's weights quantized per output unit, in Linear layout."""
    w1: torch.Tensor   # [H, W] int8
    s1: torch.Tensor   # [H] f32
    b1: torch.Tensor   # [H] f32 (dtype-rounded)
    w2: torch.Tensor   # [W, H] int8
    s2: torch.Tensor   # [W] f32
    b2: torch.Tensor   # [W] f32 (dtype-rounded)


def quantize_mlp_weights(w1, b1, w2, b2, dtype) -> Int8MLPWeights:
    """The weights cast to the activation dtype first, as the JAX tower
    does, then quantized per output unit; biases rounded to the dtype and
    widened to f32."""
    w1_8, s1 = quantize_weight_int8(w1.to(dtype))
    w2_8, s2 = quantize_weight_int8(w2.to(dtype))
    return Int8MLPWeights(w1_8, s1, b1.to(dtype).float(), w2_8, s2,
                          b2.to(dtype).float())


def mlp_int8_plain(x2: torch.Tensor, qw: Int8MLPWeights, act: str) -> torch.Tensor:
    """The int8 contract on [T, W] rows, chunk by chunk in hidden order."""
    hid = qw.w1.shape[0]
    x8, xs = quantize_rows_int8(x2)                       # [T, W], [T, 1]
    acc = None
    for lo in range(0, hid, HIDDEN_CHUNK):
        hi = min(hid, lo + HIDDEN_CHUNK)
        h = int_dot(x8, qw.w1[lo:hi]).float() * (xs * qw.s1[lo:hi]) + qw.b1[lo:hi]
        h8, hs = quantize_rows_int8(_act_poly(h, act))
        term = int_dot(h8, qw.w2[:, lo:hi]).float() * (hs * qw.s2)
        acc = term if acc is None else acc + term
    if acc is None:
        acc = x2.new_zeros((x2.shape[0], qw.w2.shape[0]), dtype=torch.float32)
    return (acc + qw.b2).to(x2.dtype)


def mlp_int8_ref(x, w1, b1, w2, b2, act: str = "gelu"):
    """Plain version of the int8 mode from the raw weights: quantize them
    (after the cast to x's dtype), then the chunked int8 contract. The s32
    products are exact (an int32 matmul on the CPU; on the card fp32
    matmuls of integer-valued operands, every partial sum below 2^24)."""
    width = _check_square(x, w1, w2)
    shape = x.shape
    qw = quantize_mlp_weights(w1, b1, w2, b2, x.dtype)
    return mlp_int8_plain(x.reshape(-1, width), qw, act).reshape(shape)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _kernel_weights(qw: Int8MLPWeights):
    """The int8 kernel's weight layout: W1 [H, Wp] and W2 [W, Hp], K
    zero-padded to whole 16-byte rows (Wp, Hp: W, H rounded up to 16), so
    that TMA can read them; the pad computes zeros. Every preset's widths
    are multiples of 16, so there this returns the weights themselves."""
    hid, width = qw.w1.shape
    wp, hp = _round_up(width, _Q8_PITCH), _round_up(hid, _Q8_PITCH)
    w1 = F.pad(qw.w1, (0, wp - width)) if wp != width else qw.w1
    w2 = F.pad(qw.w2, (0, hp - hid)) if hp != hid else qw.w2
    return w1.contiguous(), w2.contiguous()


def fused_mlp_int8(x, qw: Int8MLPWeights, *, act: str = "gelu"):
    """The int8 mode over [..., T, W] with weights from
    `quantize_mlp_weights`. CPU tensors run the plain version; CUDA
    tensors launch the int8 kernel (K5)."""
    width = _check_square(x, qw.w1, qw.w2)
    if act not in ACT_CODES:
        raise ValueError(act)
    shape = x.shape
    x2 = x.reshape(-1, width)
    if x.device.type == "cpu":
        return mlp_int8_plain(x2, qw, act).reshape(shape)
    _no_grad_on_card("fused_mlp_int8", x2, *qw)
    if x.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"fused_mlp_int8: unsupported dtype {x.dtype}")
    x2 = x2.contiguous()
    w1, w2 = _kernel_weights(qw)
    kernels.require_cuda("fused_mlp_int8", x2, w1, qw.s1, qw.b1, w2, qw.s2, qw.b2)
    out = torch.empty_like(x2)
    t, hid = x2.shape[0], qw.w1.shape[0]
    if t == 0:
        return out.reshape(shape)
    w1, w2 = _aligned(w1), _aligned(w2)   # TMA: a copy only of an unaligned base
    # scratch, made for this call's shape: x and h quantized, their scales
    i8 = dict(dtype=torch.int8, device=x.device)
    x8 = torch.empty((t, w1.shape[1]), **i8)
    h8 = torch.empty((t, w2.shape[1]), **i8)
    xs = torch.empty(t, dtype=torch.float32, device=x.device)
    hs = torch.empty((t, -(-hid // HIDDEN_CHUNK)), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):   # launch on the tensors' card
        status = kernels.lib().rv_fused_mlp_int8(
            x2.data_ptr(), w1.data_ptr(), qw.s1.data_ptr(), qw.b1.data_ptr(),
            w2.data_ptr(), qw.s2.data_ptr(), qw.b2.data_ptr(), x8.data_ptr(),
            xs.data_ptr(), h8.data_ptr(), hs.data_ptr(), out.data_ptr(), t, width,
            hid, ACT_CODES[act], kernels.DTYPE_CODES[x.dtype],
            kernels.stream_ptr(x.device))
    kernels.check("fused_mlp_int8", status)
    kernels.launches["fused_mlp_int8"] += 1
    kernels.shape_launches[("fused_mlp_int8", (t, width, hid, str(x.dtype)))] += 1
    return out.reshape(shape)
