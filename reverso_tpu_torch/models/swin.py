"""Swin Transformer backbone (GroundingDINO's image tower) in PyTorch.

Swin v1: windowed attention with a relative position bias, shifted
windows with their additive mask, and patch merging, after the JAX
package's `models.swin` (itself after transformers' `SwinBackbone`).
Plain PyTorch, as it was plain XLA: no kernel of its own. Module names
follow the flax tree, so `models.convert.params_from_flax` loads its
parameters by name.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm32, attend, new_param
from .vit import Linear


@dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224        # only used for defaults; model is size-agnostic
    patch_size: int = 4
    in_channels: int = 3
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    out_stages: tuple[int, ...] = (1, 2, 3)   # 0-indexed stages to emit
    dtype: str = "float32"

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)


@functools.lru_cache(maxsize=32)
def _rel_pos_index(window: int) -> np.ndarray:
    """[w^2, w^2] index into the (2w-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """[nW, w^2, w^2] additive mask for shifted windows (0 / -100)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


def _window_partition(x, window):
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_merge(win, window, h, w):
    b = win.shape[0] // (h // window * (w // window))
    x = win.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int):
        super().__init__()
        self.cfg, self.dim, self.heads = cfg, dim, heads
        self.query, self.key, self.value = Linear(dim, dim), Linear(dim, dim), Linear(dim, dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = new_param(
            ((2 * cfg.window_size - 1) ** 2, heads), "normal", 0.02)

    def forward(self, x, bias_mask):
        """x: [nW*B, w^2, C]; bias_mask: [nW, w^2, w^2] or None."""
        n, w2, _ = x.shape
        hd = self.dim // self.heads
        split = lambda t: t.reshape(n, w2, self.heads, hd).transpose(1, 2)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        idx = torch.from_numpy(_rel_pos_index(self.cfg.window_size).reshape(-1))
        bias = self.relative_position_bias_table[idx.to(x.device)]
        bias = bias.reshape(w2, w2, self.heads).permute(2, 0, 1)[None]
        if bias_mask is not None:
            n_w = bias_mask.shape[0]
            bias = (bias + bias_mask[:, None]).repeat(n // n_w, 1, 1, 1)
        o = attend(q, k, v, bias)
        return self.proj(o.transpose(1, 2).reshape(n, w2, self.dim))


class SwinBlock(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shift: int):
        super().__init__()
        self.cfg, self.dim, self.shift = cfg, dim, shift
        eps = cfg.layer_norm_eps
        self.ln_before = LayerNorm32(dim, eps)
        self.attn = WindowAttention(cfg, dim, heads)
        self.ln_after = LayerNorm32(dim, eps)
        self.fc1 = Linear(dim, int(dim * cfg.mlp_ratio))
        self.fc2 = Linear(int(dim * cfg.mlp_ratio), dim)

    def forward(self, x, h: int, w: int):
        win = self.cfg.window_size
        b = x.shape[0]
        shortcut = x
        y = self.ln_before(x).reshape(b, h, w, self.dim)
        # zero-pad partial windows (pad keys attend unmasked, as in HF)
        pad_h = (win - h % win) % win
        pad_w = (win - w % win) % win
        if pad_h or pad_w:
            y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        shift = self.shift if min(hp, wp) > win else 0
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_attn_mask(hp, wp, win, shift)).to(y.device)
        y = self.attn(_window_partition(y, win), mask)
        y = _window_merge(y, win, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = shortcut + y[:, :h, :w].reshape(b, h * w, self.dim)
        z = self.fc2(F.gelu(self.fc1(self.ln_after(x))))
        return x + z


class PatchMerging(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int):
        super().__init__()
        self.dim = dim
        self.norm = LayerNorm32(4 * dim, cfg.layer_norm_eps)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, h: int, w: int):
        b = x.shape[0]
        y = x.reshape(b, h, w, self.dim)
        if h % 2 or w % 2:
            y = F.pad(y, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                       y[:, 0::2, 1::2], y[:, 1::2, 1::2]], dim=-1)
        h2, w2 = y.shape[1], y.shape[2]
        y = self.reduction(self.norm(y.reshape(b, h2 * w2, 4 * self.dim)))
        return y, h2, w2


class SwinBackbone(nn.Module):
    """images [B, H, W, 3] -> {stage: [B, Hs, Ws, Cs]} feature maps
    (LayerNormed per output stage, as transformers' SwinBackbone)."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_eps
        self.patch_embed = Conv2d(cfg.in_channels, cfg.embed_dim, cfg.patch_size,
                                  stride=cfg.patch_size)
        self.embed_norm = LayerNorm32(cfg.embed_dim, eps)
        for s, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(s)
            for blk in range(depth):
                shift = 0 if blk % 2 == 0 else cfg.window_size // 2
                self.add_module(f"stage{s}_block{blk}",
                                SwinBlock(cfg, dim, cfg.num_heads[s], shift))
            if s in cfg.out_stages:
                self.add_module(f"out_norm{s}", LayerNorm32(dim, eps))
            if s < len(cfg.depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging(cfg, dim))

    def forward(self, images):
        c = self.cfg
        x = images.to(getattr(torch, c.dtype))
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)
        b = x.shape[0]
        ph, pw = (-x.shape[1]) % c.patch_size, (-x.shape[2]) % c.patch_size
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = self.patch_embed(x)
        h, w = x.shape[1], x.shape[2]
        x = self.embed_norm(x.reshape(b, h * w, c.embed_dim))
        outputs = {}
        for s, depth in enumerate(c.depths):
            dim = c.stage_dim(s)
            for blk in range(depth):
                x = getattr(self, f"stage{s}_block{blk}")(x, h, w)
            if s in c.out_stages:
                outputs[s] = getattr(self, f"out_norm{s}")(x).reshape(b, h, w, dim)
            if s < len(c.depths) - 1:
                x, h, w = getattr(self, f"downsample{s}")(x, h, w)
        return outputs
