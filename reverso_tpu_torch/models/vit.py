"""Vision transformer (PE-Core / CLIP family) in PyTorch.

A config-driven tower covering both the PE-Core layout (2D RoPE, attention
pooling, LayerScale) and the HF CLIP layout (absolute positions, CLS
pooling, quick-GELU, pre-LN, no patch bias), with the JAX package's
numerics: fp32 parameters cast to the activation dtype at use, fp32
LayerNorms cast back to the activation dtype (each fused with the residual
add before it, `ops/norm.py::add_layernorm`), attention through the
heads-in-lanes kernel (or, past its envelope, the [B, H, S, D] flash
kernel) and the MLP through the fused kernel (its int8 mode under
`ModelConfig.quant="int8"`; the projections stay in the activation dtype,
as in the JAX package). Images come in NHWC, as in the JAX package (NCHW
is accepted too). With `region_masks` the tower also pools masked ROI
region embeddings from the same forward.

Module and parameter names follow the flax tree (`block{i}` becomes
`blocks.{i}`), so `models.convert` maps one onto the other.

With `tp` (a `parallel/tensor.py::DataShard`, given by
`ModelShards.forward`) the blocks run tensor-parallel over the model
shards of one data shard: each shard's attention (K3) on its H / tp heads
and its MLP (K4) on its H_mlp / tp hidden units, the partial outputs
summed on the data shard's home device. Without it the forward is the
one-device one.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.attention import attention_ref, flash_attention, flash_attention_heads
from ..ops.fused_mlp import (fused_mlp, fused_mlp_int8, quantize_mlp_weights,
                             split_mlp_weights)
from ..ops.norm import add_layernorm
from ..ops.rope import apply_rope_2d, rope_2d_tables

# sequences the heads-in-lanes kernel takes (ViT-L/14-336 is 577 tokens);
# the same bound as the reference dispatch
_HEADS_KERNEL_MAX_S = 1032


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax `lecun_normal`: truncated normal (+-2 sigma) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class Linear(nn.Module):
    """Dense layer with fp32 params used in the activation dtype."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return _linear(x, self.weight, self.bias)


def _linear(x, weight, bias=None):
    """x W^T + b with the fp32 parameters cast to x's dtype."""
    b = None if bias is None else bias.to(x.dtype)
    return F.linear(x, weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in `compute_dtype` (fp32 by default), cast back
    to the input dtype (`ops/norm.py::add_layernorm` without a residual)."""

    def __init__(self, dim: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _add_norm(x, None, None, self)[1]


def _add_norm(x, y, ls, ln):
    """One norm site: (r, h) with r = x + ls(y) (x where y is None) and h =
    ln(r), in one pass of `add_layernorm`; h is None where `ln` is None
    (the residual's add alone)."""
    gamma = None if ls is None else ls.gamma
    if ln is None:
        return x + (y if ls is None else ls(y)), None
    return add_layernorm(x, y, ln.weight, ln.bias, gamma=gamma, eps=ln.eps,
                         compute_dtype=ln.compute_dtype)


class MHA(nn.Module):
    """Multi-head self-attention with optional 2D RoPE."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.q_proj, self.k_proj = Linear(w, w), Linear(w, w)
        self.v_proj, self.out_proj = Linear(w, w), Linear(w, w)

    def forward(self, x, rope=None, kv_valid: Optional[int] = None, tp=None):
        if tp is not None:
            return self._forward_tp(x, rope, kv_valid, tp)
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        return self.out_proj(_attend(q, k, v, self.cfg.num_heads, rope, kv_valid))

    def _forward_tp(self, x, ropes, kv_valid, tp):
        """Model shard m: q, k, v of its H / tp heads (the column-parallel
        pieces), attention on them, then out_proj's row-parallel piece
        gives a partial [B, S, W]. out_proj's bias enters on shard 0 only;
        `tp.reduce` sums the partials. `ropes`: (cos, sin) per shard."""
        heads = self.cfg.num_heads // tp.size
        partials = []
        for m, dev in enumerate(tp.devices):
            xm = x.to(dev)
            q, k, v = (_linear(xm, *tp.column(lin, m))
                       for lin in (self.q_proj, self.k_proj, self.v_proj))
            o = _attend(q, k, v, heads, None if ropes is None else ropes[m], kv_valid)
            partials.append(_linear(o, tp.row(self.out_proj, m),
                                    self.out_proj.bias if m == 0 else None))
        return tp.reduce(partials)


def _attend(q, k, v, h: int, rope, kv_valid):
    """Attention of q, k, v [B, S, W] (W = h heads) with optional 2D RoPE
    -> [B, S, W]: the heads-in-lanes kernel where it takes the shape (no
    head transposes, RoPE in-kernel), else [B, H, S, D] flash attention."""
    b, s, w = q.shape
    hd = w // h
    cos, sin = rope if rope is not None else (None, None)
    if s <= _HEADS_KERNEL_MAX_S and hd % 4 == 0:
        return flash_attention_heads(q, k, v, heads=h, cos=cos, sin=sin, kv_valid=kv_valid)
    split = lambda t: t.reshape(b, s, h, hd).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    if rope is not None:
        q, k = apply_rope_2d(q, cos, sin), apply_rope_2d(k, cos, sin)
    o = flash_attention(q, k, v, kv_valid=kv_valid)
    return o.transpose(1, 2).reshape(b, s, w)


class MLP(nn.Module):
    """The block MLP through the fused kernel; `quant=True` takes its int8
    mode, with the weights quantized once per activation dtype and device
    (the JAX package quantizes them on every call: the same numbers) and
    quantized again after any change to the parameters. In fp32 on the
    card the kernel takes the weights as three bf16 parts each, split once
    in the same way (`_split_weights`)."""

    def __init__(self, cfg: ModelConfig, act: str = "gelu"):
        super().__init__()
        hidden = int(cfg.width * cfg.mlp_ratio)
        self.act = act
        self.quant = cfg.quant == "int8"
        self.fc1 = Linear(cfg.width, hidden)
        self.fc2 = Linear(hidden, cfg.width)
        # caches, not state: the state dict is the tower's parameters
        self._int8 = {}
        self._split = {}

    def _int8_weights(self, dtype: torch.dtype):
        prms = (self.fc1.weight, self.fc1.bias, self.fc2.weight, self.fc2.bias)
        key = (dtype,) + tuple((p.device, p.data_ptr(), p._version) for p in prms)
        if key not in self._int8:
            self._int8 = {key: quantize_mlp_weights(*prms, dtype)}
        return self._int8[key]

    def _split_weights(self, w1=None, w2=None, resident=None, slot=None):
        """The fp32 weights' bf16 parts (`split_mlp_weights`) of w1, w2
        (default: fc1's and fc2's weights), cached by `slot` (None on one
        device; (model shard, device) with `tp`) and made again after any
        change to `resident` (the parameters they come from: w1 and w2, or
        a shard's resident pieces)."""
        if w1 is None:
            w1, w2 = self.fc1.weight, self.fc2.weight
        key = (w1.device,) + tuple((p.data_ptr(), p._version) for p in (resident or (w1, w2)))
        if self._split.get(slot, (None,))[0] != key:
            with torch.no_grad():
                self._split[slot] = (key, split_mlp_weights(w1, w2))
        return self._split[slot][1]

    def forward(self, x, tp=None):
        dt = x.dtype
        if tp is not None:
            return self._forward_tp(x, tp)
        if self.quant:
            return fused_mlp_int8(x, self._int8_weights(dt), act=self.act)
        parts = self._split_weights() if dt == torch.float32 and x.is_cuda else None
        return fused_mlp(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt),
                         self.fc2.weight.to(dt), self.fc2.bias.to(dt),
                         act=self.act, parts=parts)

    def _forward_tp(self, x, tp):
        """Model shard m: the fused MLP on fc1's hidden pieces [H / tp] and
        fc2's matching column piece, a partial [..., W]. fc2's bias enters
        on shard 0 only (zeros on the others); `tp.reduce` sums the
        partials. In fp32 on the card each shard's weight parts are split
        once and cached by shard (`_split_weights`)."""
        if self.quant:
            raise NotImplementedError("the int8 MLP has no tensor-parallel form; "
                                      "train with quant='none'")
        dt = x.dtype
        partials = []
        for m, dev in enumerate(tp.devices):
            (w1, b1), w2 = tp.column(self.fc1, m), tp.row(self.fc2, m)
            b2 = self.fc2.bias if m == 0 else torch.zeros_like(self.fc2.bias, device=dev)
            parts = None
            if dt == torch.float32 and dev.type == "cuda":
                resident = (tp.piece(self.fc1, "weight", m), tp.piece(self.fc2, "weight", m))
                parts = self._split_weights(w1, w2, resident, (m, dev))
            partials.append(fused_mlp(x.to(dev), w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt),
                                      act=self.act, parts=parts))
        return tp.reduce(partials)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.init = init
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """A pre-LN block. The tower runs it through `sublayers`, with its
    residual adds fused into the norm sites that follow them."""

    def __init__(self, cfg: ModelConfig, act: str = "gelu"):
        super().__init__()
        norm_dtype = getattr(torch, cfg.norm_dtype)
        self.ln1 = LayerNorm(cfg.width, norm_dtype)
        self.attn = MHA(cfg)
        self.ln2 = LayerNorm(cfg.width, norm_dtype)
        self.mlp = MLP(cfg, act)
        if cfg.layer_scale_init is not None:
            self.ls1 = LayerScale(cfg.width, cfg.layer_scale_init)
            self.ls2 = LayerScale(cfg.width, cfg.layer_scale_init)
        else:
            self.ls1 = self.ls2 = None

    def sublayers(self, x, h, rope=None, kv_valid: Optional[int] = None, tp=None):
        """The block from h = ln1(x) on: attention, its residual add fused
        with ln2, the MLP. Returns (x, y): the residual after attention and
        the MLP's output, whose add (with ls2) the caller fuses with the
        next norm site."""
        y = self.attn(h, rope, kv_valid, tp)
        x, h = _add_norm(x, y, self.ls1, self.ln2)
        return x, self.mlp(h, tp)


class AttentionPool(nn.Module):
    """Probe attention pooling (PE-Core head): a learned query attends over
    all tokens, [B, S, W] -> [B, W].

    With `mask_bias` [B, R, S] the probe fills R query slots, each attending
    under its own additive bias (pad tokens, or a region's mask), and the
    result is [B, R, W]: R region embeddings in one call, sharing the
    pooling head's weights. Scores and softmax are fp32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        w = cfg.width
        self.cfg = cfg
        self.probe = nn.Parameter(torch.zeros(1, 1, w))
        self.q_proj, self.k_proj = Linear(w, w), Linear(w, w)
        self.v_proj, self.out_proj = Linear(w, w), Linear(w, w)
        self.ln = LayerNorm(w)

    def forward(self, x, mask_bias=None):   # [B, S, W] -> [B, W] | [B, R, W]
        h = self.cfg.num_heads
        b, s, w = x.shape
        hd = w // h
        r = 1 if mask_bias is None else mask_bias.shape[1]
        xq = self.probe.to(x.dtype).expand(b, r, w)
        split = lambda t: t.reshape(b, t.shape[1], h, hd).transpose(1, 2)
        q, k, v = (split(self.q_proj(xq)), split(self.k_proj(x)),
                   split(self.v_proj(x)))
        o = attention_ref(q, k, v, mask_bias=mask_bias)
        o = self.ln(self.out_proj(o.transpose(1, 2).reshape(b, r, w)))
        return o[:, 0, :] if mask_bias is None else o


class VisionTransformer(nn.Module):
    """Config-driven ViT producing image embeddings.

    forward returns the final embedding [B, embed_dim] before
    normalization (PerceptionEncoder L2-normalizes)."""

    def __init__(self, cfg: ModelConfig, *, act: str = "gelu",
                 use_ln_pre: bool = False, patch_bias: bool = True,
                 pad_seq: bool = False):
        super().__init__()
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"unsupported quant {cfg.quant!r}")
        if act not in ("gelu", "quick_gelu"):
            raise ValueError(f"unsupported activation {act!r}")
        self.cfg = cfg
        self.act = act
        self.pad_seq = pad_seq
        w = cfg.width
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, bias=patch_bias)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, w))
                          if cfg.use_cls_token else None)
        self.pos_embed = (nn.Parameter(torch.zeros(1, cfg.seq_len, w))
                          if cfg.use_abs_pos else None)
        self.ln_pre = LayerNorm(w) if use_ln_pre else None
        self.blocks = nn.ModuleList(Block(cfg, act) for _ in range(cfg.depth))
        self.ln_post = LayerNorm(w) if cfg.use_ln_post else None
        if cfg.pool_type == "attn":
            self.attn_pool = AttentionPool(cfg)
        elif cfg.pool_type not in ("cls", "mean"):
            raise ValueError(cfg.pool_type)
        self.proj = Linear(w, cfg.embed_dim, bias=False)
        self._rope_cache: dict = {}

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The flax initialisers: lecun-normal kernels, zero biases, unit
        LayerNorms, N(0, 0.02) for cls/pos/probe and `layer_scale_init`
        for gamma, drawn in module order from `gen` (a CPU generator:
        initialise before moving to the device)."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(gen)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init)
            elif isinstance(m, AttentionPool):
                m.probe.normal_(0.0, 0.02, generator=gen)
        conv = self.patch_embed
        _lecun_normal_(conv.weight, conv.weight[0].numel(), gen)
        if conv.bias is not None:
            conv.bias.zero_()
        for prm in (self.cls_token, self.pos_embed):
            if prm is not None:
                prm.normal_(0.0, 0.02, generator=gen)

    def _rope(self, seq: int, device: torch.device):
        """(cos, sin) device tables for a `seq`-long (maybe padded) sequence;
        pad rows get the identity rotation."""
        key = (seq, device)
        if key not in self._rope_cache:
            cfg = self.cfg
            hd = cfg.width // cfg.num_heads
            cos, sin = rope_2d_tables(cfg.grid_size, hd, cls_token=cfg.use_cls_token)
            pad = seq - cos.shape[0]
            if pad > 0:
                cos = np.concatenate([cos, np.ones((pad, hd), np.float32)])
                sin = np.concatenate([sin, np.zeros((pad, hd), np.float32)])
            self._rope_cache[key] = (torch.from_numpy(cos).to(device),
                                     torch.from_numpy(sin).to(device))
        return self._rope_cache[key]

    def forward(self, images, *, return_tokens: bool = False,
                region_masks=None, tp=None):
        """Returns the embedding [B, embed_dim] (before normalization), with
        `return_tokens` also the tokens [B, S, W]. `region_masks` [B, R, P]
        (patch-grid weights, no CLS slot) adds the masked ROI region
        embeddings [B, R, embed_dim]: (pooled, regions[, tokens]). `tp`:
        the blocks run tensor-parallel over one data shard (module
        docstring)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        x = images.to(dtype)
        if x.shape[-1] == 3:
            x = x.permute(0, 3, 1, 2)          # NHWC -> NCHW for the conv
        b = x.shape[0]
        conv = self.patch_embed
        bias = None if conv.bias is None else conv.bias.to(dtype)
        x = F.conv2d(x, conv.weight.to(dtype), bias, stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)       # [B, P, W], row-major grid

        if self.cls_token is not None:
            x = torch.cat([self.cls_token.to(dtype).expand(b, 1, cfg.width), x], 1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(dtype)
        if self.ln_pre is not None:
            x = self.ln_pre(x)

        s_valid = x.shape[1]
        kv_valid = None
        if self.pad_seq:
            s_pad = -(-s_valid // 128) * 128
            if s_pad != s_valid:
                x = F.pad(x, (0, 0, 0, s_pad - s_valid))
                kv_valid = s_valid
        rope = None
        if cfg.use_rope:   # with tp: the tables on each model shard's device
            rope = (self._rope(x.shape[1], x.device) if tp is None
                    else [self._rope(x.shape[1], dev) for dev in tp.devices])
        # each block's end fuses with the next block's ln1, the last one's
        # with ln_post where it normalises every token (the attention pool)
        post = self.ln_post if cfg.pool_type == "attn" else None
        first = self.blocks[0].ln1 if len(self.blocks) else post
        h = first(x) if first is not None else None
        for i, blk in enumerate(self.blocks):
            x, y = blk.sublayers(x, h, rope, kv_valid, tp)
            nxt = self.blocks[i + 1].ln1 if i + 1 < len(self.blocks) else post
            x, h = _add_norm(x, y, blk.ls2, nxt)

        tokens = x
        region_emb = None
        if cfg.pool_type == "attn":
            tokens_n = tokens if post is None else h
            if kv_valid is None:
                pooled = self.attn_pool(tokens_n)
            else:
                pos = torch.arange(tokens_n.shape[1], device=x.device)
                vbias = torch.where(pos < kv_valid, 0.0, -1e9).expand(
                    b, 1, tokens_n.shape[1])
                pooled = self.attn_pool(tokens_n, vbias)[:, 0, :]
            if region_masks is not None:
                rbias = self._region_bias(region_masks)
                pad = tokens_n.shape[1] - rbias.shape[-1]
                if pad > 0:      # padded sequence: pad tokens never attend
                    rbias = F.pad(rbias, (0, pad), value=-1e9)
                region_emb = self.attn_pool(tokens_n, rbias)
        else:
            pooled = (tokens[:, 0, :] if cfg.pool_type == "cls"
                      else tokens[:, :s_valid].mean(dim=1))
            if self.ln_post is not None:
                pooled = self.ln_post(pooled)
            if region_masks is not None:
                region_emb = self._masked_mean(tokens[:, :s_valid], region_masks)
        pooled = self.proj(pooled)
        if region_emb is not None:
            region_emb = self.proj(region_emb)
            if return_tokens:
                return pooled, region_emb, tokens[:, :s_valid]
            return pooled, region_emb
        if return_tokens:
            return pooled, tokens[:, :s_valid]
        return pooled

    def _region_bias(self, region_masks: torch.Tensor) -> torch.Tensor:
        """[B, R, P] weights -> an additive attention bias over the token
        sequence: 0 on the mask's support (m > 0), -1e9 elsewhere and on the
        CLS slot. An empty mask falls back to uniform, so pooling stays
        finite (callers drop empty regions)."""
        m = region_masks.float()
        empty = m.sum(dim=-1, keepdim=True) <= 0
        m = torch.where(empty, torch.ones_like(m), m)
        bias = torch.where(m > 0, 0.0, -1e9)
        if self.cfg.use_cls_token:
            bias = F.pad(bias, (1, 0), value=-1e9)
        return bias

    def _masked_mean(self, tokens: torch.Tensor, region_masks: torch.Tensor):
        """The cls and mean pools' regions: token means weighted by the
        mask's values, in fp32, cast back to the tokens' dtype."""
        if self.cfg.use_cls_token:
            tokens = tokens[:, 1:, :]
        w = region_masks.float()
        denom = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)
        return torch.matmul(w / denom, tokens.float()).to(tokens.dtype)
