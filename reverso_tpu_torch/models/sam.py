"""SAM (Segment Anything) in PyTorch: box-prompted mask generation.

After the JAX package's `models.sam` (itself after transformers'
`SamModel`): the ViT image encoder with windowed and global layers and
decomposed relative positions, the channel-LayerNorm neck, the box
prompt encoder and the two-way-transformer mask decoder. The global
layers at 64 x 64 tokens run `ops.attention.flash_attention` with the
rel-pos bias folded into the kernel (`csrc/flash_attn.cu`), so nothing
[S, S] reaches device memory; windowed layers are plain PyTorch, as they
were plain XLA. Module names follow the flax tree.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from .layers import Conv2d, ConvTranspose2d, LayerNorm32, new_param
from .vit import Linear


@dataclass(frozen=True)
class SamVisionCfg:
    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)
    output_channels: int = 256
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class SamDecoderCfg:
    hidden_size: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    num_layers: int = 2
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class SamConfig:
    vision: SamVisionCfg = field(default_factory=SamVisionCfg)
    decoder: SamDecoderCfg = field(default_factory=SamDecoderCfg)
    dtype: str = "float32"

    @property
    def prompt_hidden(self) -> int:
        return self.vision.output_channels

    @property
    def embed_size(self) -> int:
        return self.vision.grid


def tiny_sam_config() -> SamConfig:
    """Small config for CPU parity tests (the JAX package's tiny config)."""
    return SamConfig(
        vision=SamVisionCfg(image_size=64, patch_size=8, hidden_size=32,
                            num_layers=2, num_heads=2, window_size=4,
                            global_attn_indexes=(1,), output_channels=16),
        decoder=SamDecoderCfg(hidden_size=16, num_heads=2, mlp_dim=32,
                              iou_head_hidden_dim=16))


# sequences past this take the flash kernel with the rel-pos bias inside
# (SAM ViT-B's global layers: 64 x 64 = 4096 tokens); the same gate as the
# JAX package's, without the TPU's tile conditions
_FLASH_MIN_S = 2048


# ---------------------------------------------------------------------------
# Vision encoder
# ---------------------------------------------------------------------------

def _decomposed_rel_pos_parts(q, rel_h, rel_w, hw):
    """MViTv2 decomposed relative position bias, factored parts.

    q: [N, H*W, d]; rel_h: [2H-1, d]; rel_w: [2W-1, d]. Returns (bias_h
    [N, H*W, H], bias_w [N, H*W, W]); the full bias is
    bias_h[:, q, ky] + bias_w[:, q, kx]."""
    h, w = hw
    idx_h = torch.from_numpy((np.arange(h)[:, None] - np.arange(h)[None, :]) + (h - 1))
    idx_w = torch.from_numpy((np.arange(w)[:, None] - np.arange(w)[None, :]) + (w - 1))
    rh = rel_h[idx_h.reshape(-1).to(q.device)].reshape(h, h, -1)     # [H, H, d]
    rw = rel_w[idx_w.reshape(-1).to(q.device)].reshape(w, w, -1)     # [W, W, d]
    n = q.shape[0]
    qr = q.reshape(n, h, w, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", qr, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", qr, rw)
    return bias_h.reshape(n, h * w, h), bias_w.reshape(n, h * w, w)


class SamVisionAttention(nn.Module):
    def __init__(self, cfg: SamVisionCfg, input_size: int):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
        self.qkv = Linear(d, 3 * d)
        self.proj = Linear(d, d)
        self.rel_pos_h = new_param((2 * input_size - 1, hd), "zeros")
        self.rel_pos_w = new_param((2 * input_size - 1, hd), "zeros")

    def forward(self, x):  # [N, H, W, C]
        c = self.cfg
        n, h, w, _ = x.shape
        heads, hd = c.num_heads, c.hidden_size // c.num_heads
        qkv = self.qkv(x).reshape(n, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, n * heads, h * w, hd).unbind(0)
        rel_h, rel_w = self.rel_pos_h.to(x.dtype), self.rel_pos_w.to(x.dtype)
        bh, bw = _decomposed_rel_pos_parts(q, rel_h, rel_w, (h, w))
        if h == w and h * w > _FLASH_MIN_S:
            # global layers: the bias enters the kernel as its two parts
            shp = (n, heads, h * w)
            o = flash_attention(q.reshape(*shp, hd), k.reshape(*shp, hd),
                                v.reshape(*shp, hd), scale=hd ** -0.5,
                                rel_bias=(bh.reshape(*shp, h), bw.reshape(*shp, w), h))
            o = o.reshape(n * heads, h * w, hd)
        else:
            s = torch.matmul(q * (hd ** -0.5), k.transpose(-1, -2))
            bias = (bh.reshape(-1, h * w, h, 1) + bw.reshape(-1, h * w, 1, w))
            s = s + bias.reshape(-1, h * w, h * w)
            p = torch.softmax(s.float(), dim=-1).to(x.dtype)
            o = torch.matmul(p, v)
        o = o.reshape(n, heads, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.proj(o.reshape(n, h, w, c.hidden_size))


class SamVisionLayer(nn.Module):
    def __init__(self, cfg: SamVisionCfg, window: int):
        super().__init__()
        self.cfg, self.window = cfg, window   # window 0 = global
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm32(d, eps)
        self.attn = SamVisionAttention(cfg, window if window > 0 else cfg.grid)
        self.layer_norm2 = LayerNorm32(d, eps)
        self.mlp_lin1 = Linear(d, int(d * cfg.mlp_ratio))
        self.mlp_lin2 = Linear(int(d * cfg.mlp_ratio), d)

    def forward(self, x):  # [B, H, W, C]
        res = x
        y = self.layer_norm1(x)
        b, h, w, ch = y.shape
        if self.window > 0:
            win = self.window
            ph, pw = (win - h % win) % win, (win - w % win) % win
            if ph or pw:
                y = torch.nn.functional.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.reshape(b, hp // win, win, wp // win, win, ch)
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, ch)
            y = self.attn(y)
            y = y.reshape(b, hp // win, wp // win, win, win, ch)
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, ch)[:, :h, :w]
        else:
            y = self.attn(y)
        x = res + y
        return x + self.mlp_lin2(F.gelu(self.mlp_lin1(self.layer_norm2(x))))


class ChannelLayerNorm(nn.Module):
    """SamLayerNorm over the channel axis of [B, H, W, C], in fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))   # flax "scale"
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) / torch.sqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class SamVisionEncoder(nn.Module):
    def __init__(self, cfg: SamVisionCfg):
        super().__init__()
        self.cfg = cfg
        d, oc = cfg.hidden_size, cfg.output_channels
        self.patch_embed = Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size)
        self.pos_embed = new_param((1, cfg.grid, cfg.grid, d), "zeros")
        for i in range(cfg.num_layers):
            window = 0 if i in cfg.global_attn_indexes else cfg.window_size
            self.add_module(f"layer{i}", SamVisionLayer(cfg, window))
        self.neck_conv1 = Conv2d(d, oc, 1, bias=False)
        self.neck_ln1 = ChannelLayerNorm(oc)
        self.neck_conv2 = Conv2d(oc, oc, 3, padding=1, bias=False)
        self.neck_ln2 = ChannelLayerNorm(oc)

    def forward(self, images):  # [B, H, W, 3] -> [B, grid, grid, out_ch]
        x = images
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer{i}")(x)
        x = self.neck_ln1(self.neck_conv1(x))
        return self.neck_ln2(self.neck_conv2(x))


# ---------------------------------------------------------------------------
# Prompt encoder + positional fourier embedding
# ---------------------------------------------------------------------------

class SamPositionalEmbedding(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.positional_embedding = new_param((2, num_pos_feats), "normal", 1.0)

    def forward(self, coords):  # [..., 2] in [0, 1] -> [..., 2 * feats]
        c = 2 * coords.float() - 1
        c = 2 * math.pi * (c @ self.positional_embedding)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class SamPromptEncoder(nn.Module):
    """Box prompts -> sparse + dense embeddings (the only prompts the
    detector sends; the point slots keep their parameters)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        hid = cfg.prompt_hidden
        self.shared_embedding = SamPositionalEmbedding(hid // 2)
        for i in range(4):
            self.register_parameter(f"point_embed_{i}", new_param((1, hid), "normal", 1.0))
        self.not_a_point_embed = new_param((1, hid), "normal", 1.0)
        self.no_mask_embed = new_param((1, hid), "normal", 1.0)

    def forward(self, input_boxes):
        c = self.cfg
        hid = c.prompt_hidden
        batch, nb = input_boxes.shape[:2]
        corners = (input_boxes.reshape(batch, nb, 2, 2) + 0.5) / float(c.vision.image_size)
        emb = self.shared_embedding(corners)
        emb = torch.stack([emb[:, :, 0] + self.point_embed_2[0],
                           emb[:, :, 1] + self.point_embed_3[0]], dim=2)
        es = c.embed_size
        dense = self.no_mask_embed.reshape(1, 1, 1, hid).expand(batch, es, es, hid)
        return emb, dense


def image_wide_positional_embedding(table, cfg: SamConfig):
    """[1, grid, grid, C] image positional embedding from a [2, F] table."""
    size = cfg.embed_size
    g = (np.arange(size, dtype=np.float32) + 0.5) / size
    yx = np.stack(np.meshgrid(g, g, indexing="ij"), -1)     # [H, W, (y, x)]
    coords = torch.from_numpy(yx[..., ::-1].copy()).to(table.device)   # (x, y)
    c = 2 * math.pi * ((2 * coords - 1) @ table)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)[None]


# ---------------------------------------------------------------------------
# Mask decoder (two-way transformer)
# ---------------------------------------------------------------------------

class SamAttention(nn.Module):
    def __init__(self, cfg: SamDecoderCfg, downsample: int = 1):
        super().__init__()
        self.cfg = cfg
        inner = cfg.hidden_size // downsample
        self.inner = inner
        self.q_proj = Linear(cfg.hidden_size, inner)
        self.k_proj = Linear(cfg.hidden_size, inner)
        self.v_proj = Linear(cfg.hidden_size, inner)
        self.out_proj = Linear(inner, cfg.hidden_size)

    def forward(self, q, k, v):  # [B, P, N, C]
        heads = self.cfg.num_heads
        hd = self.inner // heads
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)

        def split(t):
            b, p, n_, _ = t.shape
            return t.reshape(b * p, n_, heads, hd).transpose(1, 2)

        qh, kh, vh = split(q), split(k), split(v)
        s = torch.matmul(qh * (hd ** -0.5), kh.transpose(-1, -2))
        p_ = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.matmul(p_, vh)
        b, pb = q.shape[0], q.shape[1]
        o = o.transpose(1, 2).reshape(b, pb, -1, self.inner)
        return self.out_proj(o)


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamDecoderCfg, skip_first_pe: bool = False):
        super().__init__()
        d, eps, ds = cfg.hidden_size, cfg.layer_norm_eps, cfg.attention_downsample_rate
        self.skip_first_pe = skip_first_pe
        self.self_attn = SamAttention(cfg, 1)
        self.layer_norm1 = LayerNorm32(d, eps)
        self.cross_attn_token_to_image = SamAttention(cfg, ds)
        self.layer_norm2 = LayerNorm32(d, eps)
        self.mlp_lin1 = Linear(d, cfg.mlp_dim)
        self.mlp_lin2 = Linear(cfg.mlp_dim, d)
        self.layer_norm3 = LayerNorm32(d, eps)
        self.cross_attn_image_to_token = SamAttention(cfg, ds)
        self.layer_norm4 = LayerNorm32(d, eps)

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries).to(keys.dtype)
        q, k = queries + qpe, keys + kpe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.layer_norm2(queries).to(keys.dtype)
        h = self.mlp_lin2(torch.relu(self.mlp_lin1(queries)))
        queries = self.layer_norm3(queries + h).to(keys.dtype)
        q, k = queries + qpe, keys + kpe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.layer_norm4(keys).to(queries.dtype)
        return queries, keys


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.decoder
        d = c.hidden_size
        n_mask = c.num_multimask_outputs + 1
        self.iou_token = new_param((1, d), "normal", 1.0)
        self.mask_tokens = new_param((n_mask, d), "normal", 1.0)
        for i in range(c.num_layers):
            self.add_module(f"block{i}", TwoWayBlock(c, skip_first_pe=(i == 0)))
        self.final_attn = SamAttention(c, c.attention_downsample_rate)
        self.final_ln = LayerNorm32(d, 1e-5)
        self.upscale_conv1 = ConvTranspose2d(d, d // 4, 2, stride=2)
        self.upscale_ln = ChannelLayerNorm(d // 4)
        self.upscale_conv2 = ConvTranspose2d(d // 4, d // 8, 2, stride=2)
        for i in range(n_mask):
            self.add_module(f"hyper_{i}_proj_in", Linear(d, d))
            self.add_module(f"hyper_{i}_mid_0", Linear(d, d))
            self.add_module(f"hyper_{i}_proj_out", Linear(d, d // 8))
        self.iou_proj_in = Linear(d, c.iou_head_hidden_dim)
        for i in range(c.iou_head_depth - 2):
            self.add_module(f"iou_mid_{i}", Linear(c.iou_head_hidden_dim,
                                                  c.iou_head_hidden_dim))
        self.iou_proj_out = Linear(c.iou_head_hidden_dim, n_mask)

    def forward(self, image_embeddings, image_pe, sparse_prompts, dense_prompts,
                multimask_output: bool = True):
        """image_embeddings [B, H, W, C]; image_pe [1, H, W, C];
        sparse_prompts [B, P, N, C]; dense_prompts [B, H, W, C].
        Returns (masks [B, P, M, 4H, 4W], iou [B, P, M])."""
        c = self.cfg.decoder
        b, h, w, ch = image_embeddings.shape
        pb = sparse_prompts.shape[1]
        n_mask = c.num_multimask_outputs + 1
        dt = image_embeddings.dtype
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        out_tokens = out_tokens[None, None].expand(b, pb, 1 + n_mask, c.hidden_size)
        tokens = torch.cat([out_tokens.to(dt), sparse_prompts.to(dt)], dim=2)

        img = image_embeddings + dense_prompts.to(dt)
        img = img.reshape(b, 1, h * w, ch).expand(b, pb, h * w, ch)
        pe = image_pe.reshape(1, 1, h * w, ch).expand(b, pb, h * w, ch).to(dt)

        queries, keys = tokens, img
        for i in range(c.num_layers):
            queries, keys = getattr(self, f"block{i}")(queries, keys, tokens, pe)
        q, k = queries + tokens, keys + pe
        queries = queries + self.final_attn(q, k, keys)
        queries = self.final_ln(queries).to(dt)
        iou_out = queries[:, :, 0]
        mask_out = queries[:, :, 1:1 + n_mask]

        up = keys.reshape(b * pb, h, w, ch)
        up = F.gelu(self.upscale_ln(self.upscale_conv1(up)))
        up = F.gelu(self.upscale_conv2(up))
        uh, uw = up.shape[1], up.shape[2]
        hyper = []
        for i in range(n_mask):
            x = torch.relu(getattr(self, f"hyper_{i}_proj_in")(mask_out[:, :, i]))
            x = torch.relu(getattr(self, f"hyper_{i}_mid_0")(x))
            hyper.append(getattr(self, f"hyper_{i}_proj_out")(x))
        hyper = torch.stack(hyper, dim=2)                          # [B, P, M, C/8]
        up_flat = up.reshape(b, pb, uh * uw, c.hidden_size // 8)
        masks = torch.matmul(hyper, up_flat.transpose(-1, -2))
        masks = masks.reshape(b, pb, n_mask, uh, uw)

        x = torch.relu(self.iou_proj_in(iou_out))
        for i in range(c.iou_head_depth - 2):
            x = torch.relu(getattr(self, f"iou_mid_{i}")(x))
        iou = self.iou_proj_out(x)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou[:, :, sl]


class Sam(nn.Module):
    """Full SAM: (images, boxes) -> (mask logits, iou scores).

    images [B, S, S, 3] (SAM pixel normalization), boxes [B, NB, 4] xyxy
    in input-pixel coordinates. Returns masks [B, NB, M, S/4, S/4] and
    iou [B, NB, M] (M = 3 if multimask else 1)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_encoder = SamVisionEncoder(cfg.vision)
        self.prompt_encoder = SamPromptEncoder(cfg)
        self.shared_image_embedding = new_param((2, cfg.prompt_hidden // 2),
                                                "normal", 1.0)
        self.mask_decoder = SamMaskDecoder(cfg)

    def forward(self, images, input_boxes, multimask_output: bool = False):
        img_emb = self.vision_encoder(images)
        sparse, dense = self.prompt_encoder(input_boxes)
        image_pe = image_wide_positional_embedding(
            self.shared_image_embedding, self.cfg).to(img_emb.dtype)
        return self.mask_decoder(img_emb, image_pe, sparse, dense, multimask_output)
