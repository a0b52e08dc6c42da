"""Multi-head attention: CUDA kernels and their plain versions.

`flash_attention_heads` consumes [B, S, W] activations with the heads
sliced out of the width, applies 2D RoPE to q and k and honours
`kv_valid`; on a CPU tensor it runs `flash_attention_heads_ref`.

`flash_attention` is attention over [B, H, S, D] with `kv_valid` and an
optional SAM-style decomposed relative-position bias; on a CPU tensor it
runs `attention_ref`, the plain [B, H, S, D] attention the pooling head
also uses.

On a CUDA tensor each launches a hand-written kernel, by the rules in
`heads_route` and `attention_route`; both run every call on
`csrc/flash_tc.cuh`. `flash_attention_heads` takes its bf16 core
(`rv_flash_heads_tc`: through TMA at head dims % 16 == 0, else the
producer's lanes copy and rotate the rows) and its split mode in fp32
(`rv_flash_heads_split`, RoPE applied by the lanes before the split).
`flash_attention` takes the bf16 core at any head dim up to 128
(zero-padded to a multiple of 16 in shared memory) and for SAM's rel-pos
bias in fp32 at head dims % 16 == 0 (`rv_flash_attn_tc`), the rest of
fp32 on the split mode (`rv_flash_attn_split`). Both take any view: a
non-contiguous one is copied, and bases TMA cannot take go through the
lanes.

The bias mode on the bf16 core computes what the TPU kernel computes
(reverso_tpu/ops/attention.py:148-200: one bf16 MXU pass for fp32 inputs,
the bias added in fp32): bf16(q * scale), bf16(k), bf16(p) and bf16(v)
with fp32 sums and an fp32 bias; `attention_bf16_ref` spells that out.
The split mode computes the TPU kernel's fp32 contract, Precision.HIGHEST:
each fp32 operand split into three bf16 parts and six bf16 products
summed in fp32; `attention_split_ref` and, with RoPE on [B, S, W],
`flash_attention_heads_split_ref` spell that out. On the CPU both entries
keep the exact fp32 plain versions, which is what the JAX package computes
on the CPU.

Gradients: with grad mode on and an input that requires grad, a CUDA call
of `flash_attention_heads` goes through `FlashHeadsFunction`, whose forward
is the launch above and whose backward is a kernel too, by the rule in
`heads_bwd_route`: the wgmma + TMA kernels of `csrc/flash_heads_bwd_tc.cu`
at every head dim <= 128, which read the forward's output and each row's
log-sum-exp (the forward writes it under autograd): bf16 at head dims %
16 == 0 with aligned bases on q, k, v and dO as they are
(`rv_flash_heads_bwd_tc`), fp32 on their split mode (three bf16 parts a
value, six products, as the fp32 forward) and bf16 at other head dims or
bases on zero-padded copies (`rv_flash_heads_bwd_parts`, which writes the
operands' parts in a prep pass). `flash_attention_heads_grad_ref` is the
plain gradient; `flash_attention_heads_grad_tc_ref` and
`flash_attention_heads_grad_split_ref` spell out the bf16 and fp32
routes' arithmetic. The JAX package has no backward for its
Pallas kernels, so these replace none. A CUDA call of `flash_attention` (K6, K7) under grad
raises: its gradient is ROADMAP queue 1 item 20c. On the CPU both entries
run their plain versions, which PyTorch differentiates itself.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .rope import _rotate_half_axial, rotate, wide
from .split import split_matmul

_LOG2E = 1.4426950408889634   # the kernels' log-sum-exp is in base 2


def heads_route(device_type: str, dtype: torch.dtype, head_dim: int,
                aligned: bool = True) -> str:
    """Which implementation serves a `flash_attention_heads` call: "plain"
    for CPU tensors; on the card, all on the tensor-core core,
    "tensor_core" for bf16 at head_dim % 16 == 0, <= 128, with bases TMA
    takes (`aligned`: 16-byte aligned q, k and v), "copy" for bf16 at other
    head dims or bases (the producer's lanes copy and rotate the rows,
    head dims padded to a multiple of 16 in shared memory), "split" for
    fp32 (three bf16 parts a value, six products). Head dims above 128
    keep their route, and its kernel refuses them. A rule between kernels
    by dtype and shape, not a fallback."""
    if device_type == "cpu":
        return "plain"
    if dtype != torch.bfloat16:
        return "split"
    if head_dim % 16 == 0 and head_dim <= 128 and aligned:
        return "tensor_core"
    return "copy"


def heads_bwd_route(device_type: str, dtype: torch.dtype, head_dim: int,
                    aligned: bool = True) -> str:
    """Which implementation serves the backward of a `flash_attention_heads`
    call: "plain" for CPU tensors; on the card the wgmma + TMA kernels,
    whose forward keeps each row's log-sum-exp: "tensor_core" for bf16 at
    head_dim % 16 == 0, <= 128 with 16-byte aligned q, k and v (`aligned`),
    read as they are; "tensor_core_padded" for bf16 at other head dims or
    bases, and "split" for fp32 (three bf16 parts a value) at any head dim
    and base, on the parts a prep pass writes with the head dim
    zero-padded to a multiple of 16. Head dims above 128 keep their route,
    and its kernel refuses them. A rule between kernels by dtype and
    shape, not a fallback."""
    if device_type == "cpu":
        return "plain"
    if dtype != torch.bfloat16:
        return "split"
    if head_dim % 16 == 0 and head_dim <= 128 and aligned:
        return "tensor_core"
    return "tensor_core_padded"


def attention_route(device_type: str, dtype: torch.dtype, head_dim: int,
                    rel_bias: bool = False) -> str:
    """Which implementation serves a `flash_attention` call: "plain" for
    CPU tensors; on the card "tensor_core" for bf16 (head dims past a
    multiple of 16 zero-padded in shared memory) and for SAM's rel-pos
    bias in fp32 at head_dim % 16 == 0 (the TPU kernel computes the bias
    mode in one bf16 pass for fp32 inputs too); "split" for the rest of
    fp32 (the TPU kernel's Precision.HIGHEST: three bf16 parts a value,
    six products). Head dims above 128 keep their route, and its kernel
    refuses them. A rule between kernels by dtype and shape, not a
    fallback."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.bfloat16 or (rel_bias and head_dim % 16 == 0):
        return "tensor_core"
    return "split"


def rel_bias_dense(bias_h: torch.Tensor, bias_w: torch.Tensor,
                   grid: int) -> torch.Tensor:
    """[..., Sq, G] row and column parts -> the [..., Sq, G*G] bias
    bias[q, k] = bias_h[q, k // G] + bias_w[q, k % G], in fp32."""
    dense = bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    return dense.reshape(*bias_h.shape[:-1], grid * grid)


def attention_ref(q, k, v, *, kv_valid: Optional[int] = None, scale=None,
                  mask_bias=None, rel_bias=None):
    """Plain attention. q, k, v: [B, H, S, D] (kv may have S_kv != S_q).

    Scores accumulate in fp32 from the dtype-rounded inputs, softmax is
    fp32, and p is rounded to the input dtype before the PV product.
    `mask_bias` [B, S_q, S_kv] is added to the scaled scores;
    `rel_bias=(bias_h [B, H, Sq, G], bias_w [B, H, Sq, G], G)` adds
    bias_h[q, k // G] + bias_w[q, k % G] for keys on a G x G grid."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if rel_bias is not None:
        s = s + rel_bias_dense(*rel_bias)
    if kv_valid is not None:
        s[..., kv_valid:] = float("-inf")
    if mask_bias is not None:
        s = s + mask_bias[:, None].float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_bf16_ref(q, k, v, *, kv_valid: Optional[int] = None, scale=None,
                       rel_bias=None):
    """Plain version of the tensor-core [B, H, S, D] attention in either
    dtype, the TPU kernel's contract for SAM's bias mode: bf16(q * scale),
    bf16(k) and bf16(v) whatever the input dtype, scores summed in fp32,
    the fp32 bias of `rel_bias` added, a one-pass softmax with p = exp(s -
    max) rounded to bf16 for the PV product while the row sum stays fp32,
    o = (p v) / l in the input dtype. Used by the tests and `chip_smoke.py`
    against the kernel; no path of the port calls it."""
    bf16 = torch.bfloat16
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    qs = (q.float() * scale).to(bf16).float()
    s = torch.matmul(qs, k.to(bf16).float().transpose(-1, -2))
    if rel_bias is not None:
        s = s + rel_bias_dense(*rel_bias)
    if kv_valid is not None:
        s[..., kv_valid:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p.to(bf16).float(), v.to(bf16).float()) / l).to(q.dtype)


def attention_split_ref(q, k, v, *, kv_valid: Optional[int] = None, scale=None,
                        rel_bias=None):
    """Plain version of the split mode ([B, H, S, D] fp32 on the tensor
    cores): q * scale in fp32, k, p and v each split into three bf16 parts,
    every product the six bf16 products summed in fp32 (`split_matmul`),
    the fp32 bias of `rel_bias` added, a one-pass softmax with p = exp(s -
    max) kept in fp32, o = (p v) / l in fp32. Used by the tests and
    `chip_smoke.py` against the kernel; no path of the port calls it."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = split_matmul(q.float() * scale, k.float().transpose(-1, -2))
    if rel_bias is not None:
        s = s + rel_bias_dense(*rel_bias)
    if kv_valid is not None:
        s[..., kv_valid:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    return split_matmul(p, v.float()) / l


def _split(t: torch.Tensor, heads: int) -> torch.Tensor:   # [B,S,W] -> [B,H,S,hd]
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def flash_attention_heads_ref(q, k, v, *, heads: int, cos=None, sin=None,
                              scale: Optional[float] = None,
                              kv_valid: Optional[int] = None):
    """Plain version of the heads-in-lanes kernel, [B, S, W] in and out.

    Same rounding points as the kernel: q and k rotate in fp32 with the
    scale folded into q, round to the activation dtype, score in fp32;
    p rounds to the dtype for the PV product while the row sum stays fp32.
    """
    b, s, w = q.shape
    hd = w // heads
    scale = float(scale) if scale is not None else hd ** -0.5
    qh, kh, vh = _split(q, heads), _split(k, heads), _split(v, heads)
    if cos is not None:
        qh = rotate(qh, cos, sin, scale)
        kh = rotate(kh, cos, sin)
        sc = torch.matmul(wide(qh), wide(kh).transpose(-1, -2))
    else:
        sc = torch.matmul(wide(qh), wide(kh).transpose(-1, -2)) * scale
    kv = s if kv_valid is None else min(int(kv_valid), s)
    if kv < s:
        sc[..., kv:] = float("-inf")
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(wide(p.to(q.dtype)), wide(vh)) / l
    return o.to(q.dtype).transpose(1, 2).reshape(b, s, w)


def flash_attention_heads_split_ref(q, k, v, *, heads: int, cos=None, sin=None,
                                    scale: Optional[float] = None,
                                    kv_valid: Optional[int] = None,
                                    return_lse: bool = False):
    """Plain version of the split mode on [B, S, W] (fp32 on the tensor
    cores): q and k rotated in fp32 as the reference rotates them, the
    scale folded into q, then both products as the six bf16 products of
    three-way splits (`split_matmul`), a one-pass softmax with p = exp(s -
    max) kept in fp32, o = (p v) / l in fp32. With `return_lse`, (o, lse):
    each query row's log-sum-exp of the scores in base 2, [B * heads, S]
    fp32, as the kernel's `lse` output holds it. Used by the tests and
    `chip_smoke.py` against the kernel; no path of the port calls it."""
    b, s, w = q.shape
    hd = w // heads
    scale = float(scale) if scale is not None else hd ** -0.5
    qh, kh, vh = (_split(t.float(), heads) for t in (q, k, v))
    if cos is not None:
        qh, kh = rotate(qh, cos, sin, scale), rotate(kh, cos, sin)
    else:
        qh = qh * scale
    sc = split_matmul(qh, kh.transpose(-1, -2))
    kv = s if kv_valid is None else min(int(kv_valid), s)
    if kv < s:
        sc[..., kv:] = float("-inf")
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    o = split_matmul(p, vh) / l
    o = o.transpose(1, 2).reshape(b, s, w)
    if not return_lse:
        return o
    lse = (m + torch.log(l)) * _LOG2E
    return o, lse.reshape(b * heads, s)


def _table(t, shape, device) -> torch.Tensor:
    """A RoPE table as the kernels read it: fp32 and contiguous."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).contiguous()
    if t.shape != shape:
        raise ValueError(f"rope tables must be {list(shape)}, got {tuple(t.shape)}")
    return t


def flash_attention_heads_grad_ref(q, k, v, do, *, heads: int, cos=None, sin=None,
                                   scale: Optional[float] = None,
                                   kv_valid: Optional[int] = None):
    """Plain version of K3's gradient: `torch.autograd.grad` of
    `flash_attention_heads_ref` at (q, k, v) against the output gradient
    `do`, all [B, S, W]. Returns (dq, dk, dv) in q's dtype."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_heads_ref(q, k, v, heads=heads, cos=cos, sin=sin,
                                      scale=scale, kv_valid=kv_valid)
        return torch.autograd.grad(o, (q, k, v), do.to(o.dtype))


def _rot_t(y, cos, sin):
    """The transpose of the RoPE rotation on [..., S, D] in fp32: rot^T(y) =
    y cos - rh(y sin), rh the axial rotate-half ([a, b | c, e] -> [-b, a |
    -e, c]); each product and the difference rounded once, as the backward
    kernels compute it."""
    cos = torch.as_tensor(cos, dtype=torch.float32, device=y.device)
    sin = torch.as_tensor(sin, dtype=torch.float32, device=y.device)
    return y * cos - _rotate_half_axial(y * sin)


def flash_attention_heads_grad_tc_ref(q, k, v, do, *, heads: int, cos=None, sin=None,
                                      scale: Optional[float] = None,
                                      kv_valid: Optional[int] = None, tile: int = 64):
    """Plain version of the tensor-core backward's arithmetic
    (`rv_flash_heads_bwd_tc`) on [B, S, W] q, k, v and the output gradient
    `do`; returns (dq, dk, dv) in q's dtype. The forward's statistics as
    the forward kernel keeps them: each row's log-sum-exp in fp32 and its
    output rounded to q's dtype (`flash_attention_heads_ref`), D =
    rowsum(fp32(do) * fp32(o)); then qr = rot(q) * scale and kr = rot(k)
    rounded to q's dtype (without RoPE q and k, the scale on the fp32
    scores), P = exp(s - lse) and dS = P (dP - D) in fp32, each rounded to
    q's dtype before its product; every product summed in fp32 over
    `tile`-row tiles of its reduction, in order; dq = rot^T(scale dS kr),
    dk = rot^T(dS^T qr) (times the scale without RoPE), dv = P^T do, each
    rounded once."""
    b, s, w = q.shape
    hd = w // heads
    dt = q.dtype
    scale = float(scale) if scale is not None else hd ** -0.5
    kv = s if kv_valid is None else min(int(kv_valid), s)
    o = flash_attention_heads_ref(q, k, v, heads=heads, cos=cos, sin=sin, scale=scale,
                                  kv_valid=kv_valid)
    qh, kh, vh, doh, oh = (_split(t, heads) for t in (q, k, v, do.to(dt), o))
    if cos is not None:
        qr, kr, mul = rotate(qh, cos, sin, scale), rotate(kh, cos, sin), 1.0
    else:
        qr, kr, mul = qh, kh, scale
    qr, kr, vf, dof = (t.float() for t in (qr, kr, vh, doh))
    sc = torch.matmul(qr, kr.transpose(-1, -2)) * mul
    if kv < s:
        sc[..., kv:] = float("-inf")
    lse = torch.logsumexp(sc, dim=-1, keepdim=True)
    d = (dof * oh.float()).sum(-1, keepdim=True)
    p = torch.exp(sc - lse)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    p, ds = p.to(dt).float(), ds.to(dt).float()

    def tiled(a, bm):   # a @ bm, fp32 sums over `tile` rows of the reduction
        out = torch.zeros(*a.shape[:-1], bm.shape[-1], dtype=torch.float32, device=a.device)
        for lo in range(0, a.shape[-1], tile):
            out = out + torch.matmul(a[..., lo:lo + tile], bm[..., lo:lo + tile, :])
        return out

    dq = tiled(ds, kr) * scale
    dk = tiled(ds.transpose(-1, -2), qr) * (1.0 if cos is not None else scale)
    dv = tiled(p.transpose(-1, -2), dof)
    if cos is not None:
        dq, dk = _rot_t(dq, cos, sin), _rot_t(dk, cos, sin)
    return tuple(t.to(dt).transpose(1, 2).reshape(b, s, w) for t in (dq, dk, dv))


def flash_attention_heads_grad_split_ref(q, k, v, do, *, heads: int, cos=None, sin=None,
                                         scale: Optional[float] = None,
                                         kv_valid: Optional[int] = None):
    """Plain version of the split-mode backward's arithmetic
    (`rv_flash_heads_bwd_parts`, fp32 on the tensor cores) on [B, S, W] q,
    k, v and the output gradient `do`; returns (dq, dk, dv) in fp32. The
    forward's output as the split forward computes it
    (`flash_attention_heads_split_ref`), D = rowsum(do * o); qr = rot(q) *
    scale (q * scale without RoPE) and kr = rot(k) in fp32, as the split
    forward folds the scale into q; every product the six bf16 products of
    its operands' three-way splits (`split_matmul`): s = qr kr^T, each
    row's log-sum-exp, P = exp(s - lse) and dS = P (do v^T - D) in fp32 (P
    and dS split like any operand), dq = rot^T(scale dS kr), dk =
    rot^T(dS^T qr), dv = P^T do."""
    b, s, w = q.shape
    hd = w // heads
    scale = float(scale) if scale is not None else hd ** -0.5
    kv = s if kv_valid is None else min(int(kv_valid), s)
    o = flash_attention_heads_split_ref(q, k, v, heads=heads, cos=cos, sin=sin, scale=scale,
                                        kv_valid=kv_valid)
    qh, kh, vh, doh, oh = (_split(t.float(), heads) for t in (q, k, v, do, o))
    if cos is not None:
        qr, kr = rotate(qh, cos, sin, scale), rotate(kh, cos, sin)
    else:
        qr, kr = qh * scale, kh
    sc = split_matmul(qr, kr.transpose(-1, -2))
    if kv < s:
        sc[..., kv:] = float("-inf")
    p = torch.exp(sc - torch.logsumexp(sc, dim=-1, keepdim=True))
    d = (doh * oh).sum(-1, keepdim=True)
    ds = p * (split_matmul(doh, vh.transpose(-1, -2)) - d)
    dq = split_matmul(ds, kr) * scale
    dk = split_matmul(ds.transpose(-1, -2), qr)
    dv = split_matmul(p.transpose(-1, -2), doh)
    if cos is not None:
        dq, dk = _rot_t(dq, cos, sin), _rot_t(dk, cos, sin)
    return tuple(t.transpose(1, 2).reshape(b, s, w) for t in (dq, dk, dv))


def _aligned16(*tensors) -> bool:
    """Whether every base is 16-byte aligned, as TMA needs."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_heads(q, k, v, heads: int) -> int:
    b, s, w = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if w % heads or (w // heads) % 4:
        raise ValueError(f"width {w} must split into {heads} heads of a "
                         f"multiple of 4")
    if q.dtype not in kernels.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_heads: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    return w // heads


def _heads_launch(q, k, v, heads: int, tables: tuple, scale: float, kv: int,
                  lse: Optional[torch.Tensor] = None):
    """K3's forward on the card: contiguous q, k, v [B, S, W] of one dtype,
    `tables` () or the (cos, sin) [S, hd] fp32 tables on the card. `lse`,
    [B * heads, S] fp32, takes each query row's log-sum-exp in base 2,
    log2(sum_k 2^(s_k * log2(e))) of the scores s (scaled), for the
    tensor-core backward (bf16) or its split mode (fp32)."""
    b, s, w = q.shape
    kernels.require_cuda("flash_attention_heads", q, k, v, *tables,
                         *(() if lse is None else (lse,)))
    # the kernels read the tables' rows 16 bytes at a time: a copy only
    # where the caller's table is not 16-byte aligned
    tables = tuple(t.clone() if t.data_ptr() % 16 else t for t in tables)
    use_rope = bool(tables)
    route = heads_route(q.device.type, q.dtype, w // heads, _aligned16(q, k, v))
    split = route == "split"
    if lse is not None and (lse.shape != (b * heads, s) or lse.dtype != torch.float32):
        raise ValueError("flash_attention_heads: lse is [B * heads, S] fp32")
    o = torch.empty_like(q)
    cos_p = tables[0].data_ptr() if use_rope else None
    sin_p = tables[1].data_ptr() if use_rope else None
    with torch.cuda.device(q.device):   # launch on the tensors' card
        if split:
            status = kernels.lib().rv_flash_heads_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_p, sin_p, o.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, w, heads, kv, scale,
                int(use_rope), kernels.stream_ptr(q.device))
        else:
            status = kernels.lib().rv_flash_heads_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), cos_p, sin_p, o.data_ptr(),
                None if lse is None else lse.data_ptr(), b, s, w, heads, kv, scale,
                int(use_rope), kernels.stream_ptr(q.device))
    kernels.check("flash_attention_heads", status)
    kernels.launches["flash_heads"] += 1
    if split:
        kernels.launches["flash_heads_split"] += 1
        kernels.shape_launches[("flash_heads_split", (b, s, w, heads))] += 1
    else:
        kernels.launches["flash_heads_tc"] += 1
        kernels.shape_launches[("flash_heads_tc", (b, s, w, heads, use_rope))] += 1
    return o


def _heads_bwd_launch(q, k, v, do, heads: int, tables: tuple, scale: float, kv: int,
                      o: torch.Tensor, lse: torch.Tensor):
    """K3's backward on the card: (dq, dk, dv) in q's dtype from the
    forward's inputs, its output `o` and its `lse` ([B * heads, S] fp32)
    and the output gradient, by `heads_bwd_route`. Scratch made for the
    call: D = rowsum(dO * O) [B * heads, S] fp32; on the "tensor_core" route
    with RoPE the rotated q and k [B, S, W] (`rv_flash_heads_bwd_tc`); on
    "split" and "tensor_core_padded" the four operands' bf16 parts [4,
    PARTS, B, S, heads * HD] (HD: the head dim rounded up to 16; PARTS 3 in
    fp32, 1 in bf16; `rv_flash_heads_bwd_parts`)."""
    b, s, w = q.shape
    hd = w // heads
    do = do.to(q.dtype).contiguous()
    kernels.require_cuda("flash_attention_heads backward", q, k, v, do, o, lse, *tables)
    tables = tuple(t.clone() if t.data_ptr() % 16 else t for t in tables)
    use_rope = bool(tables)
    route = heads_bwd_route(q.device.type, q.dtype, hd, _aligned16(q, k, v))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b * heads, s), dtype=torch.float32, device=q.device)
    cos_p = tables[0].data_ptr() if use_rope else None
    sin_p = tables[1].data_ptr() if use_rope else None
    if route == "tensor_core":
        do = do if _aligned16(do) else do.clone()   # TMA: a 16-byte aligned base
        rot = [torch.empty_like(q), torch.empty_like(k)] if use_rope else [None, None]
        with torch.cuda.device(q.device):   # launch on the tensors' card
            status = kernels.lib().rv_flash_heads_bwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), cos_p, sin_p,
                *(None if t is None else t.data_ptr() for t in rot), dsum.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, w, heads, kv, scale,
                int(use_rope), kernels.stream_ptr(q.device))
    else:
        n_parts, pitch = 3 if route == "split" else 1, heads * (-(-hd // 16) * 16)
        parts = torch.empty((4, n_parts, b, s, pitch), dtype=torch.bfloat16, device=q.device)
        with torch.cuda.device(q.device):   # launch on the tensors' card
            status = kernels.lib().rv_flash_heads_bwd_parts(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), cos_p, sin_p, parts.data_ptr(), dsum.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, w, heads, kv, scale,
                int(use_rope), kernels.DTYPE_CODES[q.dtype], pitch,
                kernels.stream_ptr(q.device))
    kernels.check("flash_attention_heads backward", status)
    kernels.launches["flash_heads_bwd_split" if route == "split" else "flash_heads_bwd_tc"] += 1
    kernels.launches["flash_heads_bwd"] += 1
    kernels.shape_launches[("flash_heads_bwd", (b, s, w, heads, use_rope,
                                                str(q.dtype)))] += 1
    return dq, dk, dv


class FlashHeadsFunction(torch.autograd.Function):
    """K3 with its gradient: the forward launches the heads-in-lanes kernel
    (`_heads_launch`), the backward the kernels `heads_bwd_route` picks
    (`_heads_bwd_launch`). It saves q, k and v before RoPE and recomputes
    the scores in the backward; the forward also writes each row's
    log-sum-exp, which it saves with its output (the output projection
    keeps that tensor anyway). On CPU tensors the forward
    and the backward are the plain versions (the tower differentiates the
    plain forward itself there; this path is for `gradcheck`). Arguments
    after v: heads, the (cos, sin) tables or (None, None), the scale and
    the number of valid keys."""

    @staticmethod
    def forward(ctx, q, k, v, heads, cos, sin, scale, kv):
        ctx.heads, ctx.scale, ctx.kv = heads, scale, kv
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, cos, sin, None, None)
            return flash_attention_heads_ref(q, k, v, heads=heads, cos=cos, sin=sin,
                                             scale=scale, kv_valid=kv)
        tables = () if cos is None else (cos, sin)
        b, s, w = q.shape
        lse = torch.empty((b * heads, s), dtype=torch.float32, device=q.device)
        o = _heads_launch(q, k, v, heads, tables, scale, kv, lse)
        ctx.save_for_backward(q, k, v, cos, sin, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_heads_grad_ref(
                q, k, v, do, heads=ctx.heads, cos=cos, sin=sin, scale=ctx.scale,
                kv_valid=ctx.kv)
        else:
            tables = () if cos is None else (cos, sin)
            dq, dk, dv = _heads_bwd_launch(q, k, v, do, ctx.heads, tables, ctx.scale,
                                           ctx.kv, o, lse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_heads(q, k, v, *, heads: int, cos=None, sin=None,
                          scale: Optional[float] = None,
                          kv_valid: Optional[int] = None):
    """Attention over [B, S, W] with heads sliced from the width and
    optional in-kernel 2D RoPE (cos/sin [S, head_dim] tables).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    `heads_route` picks, through `FlashHeadsFunction` when autograd records
    the call (its backward is a kernel too). Any view is taken: a
    non-contiguous one is copied first, and bases TMA cannot take go
    through the producer's lanes."""
    b, s, w = q.shape
    hd = w // heads if heads and w % heads == 0 else 0
    if heads_route(q.device.type, q.dtype, hd) == "plain":
        return flash_attention_heads_ref(q, k, v, heads=heads, cos=cos,
                                         sin=sin, scale=scale,
                                         kv_valid=kv_valid)
    hd = _check_heads(q, k, v, heads)
    scale = float(scale) if scale is not None else hd ** -0.5
    kv = s if kv_valid is None else max(0, min(int(kv_valid), s))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tables = (_table(cos, (s, hd), q.device),
              _table(sin, (s, hd), q.device)) if cos is not None else ()
    if kernels.grad_recorded(q, k, v):
        cos_t, sin_t = tables if tables else (None, None)
        return FlashHeadsFunction.apply(q, k, v, heads, cos_t, sin_t, scale, kv)
    return _heads_launch(q, k, v, heads, tables, scale, kv)


def flash_attention(q, k, v, *, kv_valid: Optional[int] = None,
                    scale: Optional[float] = None, rel_bias=None):
    """Attention over [B, H, S, D] (kv may have S_kv != S_q); keys at or
    past `kv_valid` are masked.

    rel_bias=(bias_h [B, H, Sq, G], bias_w [B, H, Sq, G], G) adds SAM's
    decomposed relative-position bias bias_h[q, k // G] + bias_w[q, k % G]
    for keys on a G x G grid (S_kv == G * G); the kernel adds it inside the
    tile, so the [Sq, S_kv] bias never exists on the card. On the bf16
    core (either dtype) the products take bf16 operands, as the TPU
    kernel's do (`attention_bf16_ref`); in the split mode fp32 operands
    (`attention_split_ref`); the output keeps q's dtype.

    CPU tensors run `attention_ref`; CUDA tensors launch the kernel
    `attention_route` picks, and raise where autograd would record the
    call (no backward kernel yet: ROADMAP queue 1 item 20c)."""
    b, h, sq, d = q.shape
    route = attention_route(q.device.type, q.dtype, d, rel_bias is not None)
    if route == "plain":
        return attention_ref(q, k, v, kv_valid=kv_valid, scale=scale,
                             rel_bias=rel_bias)
    if kernels.grad_recorded(q, k, v, *(rel_bias[:2] if rel_bias is not None else ())):
        raise NotImplementedError(
            "flash_attention: the [B, H, S, D] kernels (K6, K7) have no gradient "
            "on the card yet (ROADMAP queue 1 item 20c); the ViT trains on "
            "flash_attention_heads, S <= 1032")
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(f"q/k/v shapes disagree: {q.shape} {k.shape} {v.shape}")
    if q.dtype not in kernels.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    scale = float(scale) if scale is not None else d ** -0.5
    kv = skv if kv_valid is None else max(0, min(int(kv_valid), skv))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if rel_bias is not None:
        bias_h, bias_w, grid = rel_bias
        grid = int(grid)
        if skv != grid * grid:
            raise ValueError(f"rel_bias grid {grid} needs {grid * grid} keys, "
                             f"got {skv}")
        biases = tuple(t.to(torch.float32).contiguous() for t in (bias_h, bias_w))
        if any(t.shape != (b, h, sq, grid) for t in biases):
            raise ValueError(f"rel_bias parts must be [{b}, {h}, {sq}, {grid}]")
    else:
        grid, biases = 0, ()
    kernels.require_cuda("flash_attention", q, k, v, *biases)
    split = route == "split"
    o = torch.empty_like(q)
    bh_p = biases[0].data_ptr() if biases else None
    bw_p = biases[1].data_ptr() if biases else None
    if not split and grid:
        # the TPU kernel's operands: bf16(q * scale) (the scale folded in
        # before the rounding; a bf16 product rounds its fp32 value once),
        # bf16 k and v; the kernel's scale is then 1
        bf16 = torch.bfloat16
        q = (q * scale).to(bf16)
        k, v = k.to(bf16), v.to(bf16)
        scale = 1.0
    with torch.cuda.device(q.device):   # launch on the tensors' card
        if split:
            status = kernels.lib().rv_flash_attn_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bh_p, bw_p, o.data_ptr(),
                b * h, sq, skv, d, grid, kv, scale, kernels.stream_ptr(q.device))
        else:
            status = kernels.lib().rv_flash_attn_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bh_p, bw_p, o.data_ptr(),
                b * h, sq, skv, d, grid, kv, scale, kernels.DTYPE_CODES[o.dtype],
                kernels.stream_ptr(q.device))
    kernels.check("flash_attention", status)
    mode = "flash_attn_relbias" if grid else "flash_attn"
    kernels.launches[mode] += 1
    kernels.launches[f"{mode}_split" if split else f"{mode}_tc"] += 1
    return o
