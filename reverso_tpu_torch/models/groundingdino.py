"""GroundingDINO: open-vocabulary detection in PyTorch.

After the JAX package's `models.groundingdino` (itself after transformers'
`GroundingDinoForObjectDetection`): a Swin image backbone and a BERT text
tower feed a DETR-style encoder/decoder whose hot op, multi-scale
deformable attention, is the CUDA kernel `csrc/ms_deform.cu`
(`ops.deformable.ms_deform_attn`). Module names follow the flax tree, so
`models.convert.params_from_flax` loads the JAX package's parameters and,
through `convert_grounding_dino`, transformers checkpoints.

Inference only, static shapes: fixed image size, `max_text_len`-padded
logits and `num_queries` decoder queries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..ops.deformable import ms_deform_attn
from .layers import Conv2d, GroupNorm32, LayerNorm32, attend, new_param
from .swin import SwinBackbone, SwinConfig
from .text import BertConfig, BertEncoder
from .vit import Linear

# BERT special tokens delimiting phrases: [CLS], [SEP], '.', '?'
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)


@dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    ffn_dim: int = 2048
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    num_queries: int = 900
    max_text_len: int = 256
    position_embedding_temperature: float = 20.0
    layer_norm_eps: float = 1e-5
    swin: SwinConfig = field(default_factory=lambda: SwinConfig(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
        window_size=7, out_stages=(1, 2, 3)))
    text: BertConfig = field(default_factory=BertConfig)
    dtype: str = "float32"


def tiny_test_config() -> GroundingDinoConfig:
    """Small config for CPU parity tests (the JAX package's tiny config)."""
    return GroundingDinoConfig(
        d_model=32, encoder_layers=2, decoder_layers=2, num_heads=4,
        ffn_dim=64, num_queries=20, max_text_len=32,
        swin=SwinConfig(embed_dim=16, depths=(1, 1), num_heads=(2, 4),
                        window_size=4, out_stages=(0, 1)),
        text=BertConfig(vocab_size=1200, hidden_size=32, num_layers=2,
                        num_heads=4, intermediate_size=64,
                        max_position_embeddings=64))


# ---------------------------------------------------------------------------
# Host-side text preprocessing (tokens are host data)
# ---------------------------------------------------------------------------

def generate_text_masks(input_ids: np.ndarray):
    """Block-diagonal per-phrase self-attention mask + phrase-relative
    position ids (the GroundingDINO text-preprocessing contract)."""
    bsz, n = input_ids.shape
    special = np.isin(input_ids, SPECIAL_TOKEN_IDS)
    attn = np.tile(np.eye(n, dtype=bool)[None], (bsz, 1, 1))
    pos = np.zeros((bsz, n), np.int64)
    for b in range(bsz):
        prev = 0
        for col in np.nonzero(special[b])[0]:
            if col == 0 or col == n - 1:
                pos[b, col] = 0
            else:
                attn[b, prev + 1:col + 1, prev + 1:col + 1] = True
                pos[b, prev + 1:col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos


# ---------------------------------------------------------------------------
# Position embeddings
# ---------------------------------------------------------------------------

def sine_position_2d(h: int, w: int, d_model: int, temperature: float) -> np.ndarray:
    """[H, W, d_model] sine position embedding (the all-ones-mask path of
    torch's GroundingDinoSinePositionEmbedding)."""
    half = d_model // 2
    y = (np.arange(h, dtype=np.float64) + 1)[:, None] / h * 2 * math.pi
    x = (np.arange(w, dtype=np.float64) + 1)[None, :] / w * 2 * math.pi
    y = np.broadcast_to(y, (h, w))
    x = np.broadcast_to(x, (h, w))
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], -1).reshape(h, w, -1)
    return np.concatenate([py, px], axis=-1).astype(np.float32)


def get_sine_pos_embed(pos, num_pos_feats: int, temperature: float = 10000.0,
                       exchange_xy: bool = True):
    """Sine embedding of coordinates [..., n] -> [..., n * feats], fp32."""
    scale = 2 * math.pi
    ar = torch.arange(num_pos_feats, device=pos.device)
    dim_t = temperature ** (2 * (ar // 2) / num_pos_feats).float()

    def sine(x):  # [..., 1] -> [..., feats]
        sx = x * scale / dim_t
        return torch.stack([torch.sin(sx[..., 0::2]), torch.cos(sx[..., 1::2])],
                           dim=-1).reshape(*x.shape[:-1], num_pos_feats)

    parts = [sine(pos[..., i:i + 1]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def select_top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k highest scores of each row, ties to the lower
    index (the order `jax.lax.top_k` gives)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

class MHA(nn.Module):
    """Plain multi-head attention (torch GroundingDinoMultiheadAttention)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.d_model, self.heads = d_model, heads
        self.query, self.key = Linear(d_model, d_model), Linear(d_model, d_model)
        self.value, self.out_proj = Linear(d_model, d_model), Linear(d_model, d_model)

    def forward(self, queries, keys, values, mask_bias=None):
        def split(t):
            b, s, _ = t.shape
            return t.reshape(b, s, self.heads, -1).transpose(1, 2)

        o = attend(split(self.query(queries)), split(self.key(keys)),
                   split(self.value(values)), mask_bias)
        b, _, sl, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, sl, self.d_model))


class DeformAttn(nn.Module):
    """Learnable multi-scale deformable attention module."""

    def __init__(self, cfg: GroundingDinoConfig, heads: int, points: int):
        super().__init__()
        self.cfg, self.heads, self.points = cfg, heads, points
        d, n_l = cfg.d_model, cfg.num_feature_levels
        self.value_proj = Linear(d, d)
        self.sampling_offsets = Linear(d, heads * n_l * points * 2)
        self.attention_weights = Linear(d, heads * n_l * points)
        self.output_proj = Linear(d, d)

    def forward(self, hidden, value_states, reference_points, shapes,
                position_embeddings=None):
        c = self.cfg
        if position_embeddings is not None:
            hidden = hidden + position_embeddings
        b, lq, _ = hidden.shape
        lv = value_states.shape[1]
        n_l, hh, pp = c.num_feature_levels, self.heads, self.points
        value = self.value_proj(value_states).reshape(b, lv, hh, c.d_model // hh)
        offsets = self.sampling_offsets(hidden).reshape(b, lq, hh, n_l, pp, 2)
        weights = self.attention_weights(hidden).reshape(b, lq, hh, n_l * pp)
        weights = torch.softmax(weights.float(), dim=-1).reshape(
            b, lq, hh, n_l, pp).to(hidden.dtype)
        if reference_points.shape[-1] == 2:
            norm = torch.tensor([[wl, hl] for hl, wl in shapes],
                                dtype=torch.float32, device=hidden.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / norm[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / pp * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(ms_deform_attn(value, shapes, loc, weights))


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MHA(d, cfg.num_heads // 2)
        self.layer_norm_before = LayerNorm32(d, eps)
        self.fc1 = Linear(d, cfg.ffn_dim // 2)
        self.fc2 = Linear(cfg.ffn_dim // 2, d)
        self.layer_norm_after = LayerNorm32(d, eps)

    def forward(self, text, text_pos, self_attn_bias):
        qk = text + text_pos
        text = self.layer_norm_before(text + self.self_attn(qk, qk, text, self_attn_bias))
        h = self.fc2(torch.relu(self.fc1(text)))
        return self.layer_norm_after(text + h)


class BiMultiHeadAttention(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        self.cfg = cfg
        d, embed = cfg.d_model, cfg.ffn_dim // 2
        self.vision_proj, self.text_proj = Linear(d, embed), Linear(d, embed)
        self.values_vision_proj, self.values_text_proj = Linear(d, embed), Linear(d, embed)
        self.out_vision_proj, self.out_text_proj = Linear(embed, d), Linear(embed, d)

    def forward(self, vision, text, text_pad_mask=None):
        c = self.cfg
        embed = c.ffn_dim // 2
        heads = c.num_heads // 2
        hd = embed // heads
        b, lv, _ = vision.shape
        lt = text.shape[1]
        split = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2)
        vq = split(self.vision_proj(vision) * (hd ** -0.5))
        tk = split(self.text_proj(text))
        vv = split(self.values_vision_proj(vision))
        tv = split(self.values_text_proj(text))
        attn = torch.matmul(vq, tk.transpose(-1, -2)).float()    # [B, H, V, T]
        attn = attn - attn.max()           # one max over the whole batch, as HF
        attn = attn.clamp(-50000, 50000)
        attn_t = attn.transpose(2, 3)
        attn_t = attn_t - attn_t.amax(dim=-1, keepdim=True)
        attn_t = attn_t.clamp(-50000, 50000)
        text_w = torch.softmax(attn_t, dim=-1)                    # text -> vision
        if text_pad_mask is not None:
            attn = attn.masked_fill(text_pad_mask[:, None, None, :], float("-inf"))
        vision_w = torch.softmax(attn, dim=-1)                    # vision -> text
        dv = torch.matmul(vision_w.to(vision.dtype), tv)
        dt = torch.matmul(text_w.to(vision.dtype), vv)
        dv = dv.transpose(1, 2).reshape(b, lv, embed)
        dt = dt.transpose(1, 2).reshape(b, lt, embed)
        return self.out_vision_proj(dv), self.out_text_proj(dt)


class FusionLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.layer_norm_vision = LayerNorm32(d, eps)
        self.layer_norm_text = LayerNorm32(d, eps)
        self.attn = BiMultiHeadAttention(cfg)
        self.vision_param = new_param((d,), "const", 1e-4)
        self.text_param = new_param((d,), "const", 1e-4)

    def forward(self, vision, text, text_pad_mask=None):
        v = self.layer_norm_vision(vision)
        t = self.layer_norm_text(text)
        dv, dt = self.attn(v, t, text_pad_mask)
        return (v + self.vision_param.to(v.dtype) * dv,
                t + self.text_param.to(t.dtype) * dt)


class DeformableLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = DeformAttn(cfg, cfg.num_heads, cfg.encoder_n_points)
        self.self_attn_layer_norm = LayerNorm32(d, eps)
        self.fc1 = Linear(d, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, d)
        self.final_layer_norm = LayerNorm32(d, eps)

    def forward(self, vision, pos, reference_points, shapes):
        h = self.self_attn(vision, vision, reference_points, shapes,
                           position_embeddings=pos)
        vision = self.self_attn_layer_norm(vision + h)
        return self.final_layer_norm(vision + self.fc2(torch.relu(self.fc1(vision))))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg)
        self.text_enhancer_layer = TextEnhancerLayer(cfg)
        self.deformable_layer = DeformableLayer(cfg)

    def forward(self, vision, text, vision_pos, text_pos, reference_points,
                shapes, text_self_attn_bias, text_pad_mask):
        vision, text = self.fusion_layer(vision, text, text_pad_mask)
        text = self.text_enhancer_layer(text, text_pos, text_self_attn_bias)
        vision = self.deformable_layer(vision, vision_pos, reference_points, shapes)
        return vision, text


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MHA(d, cfg.num_heads)
        self.self_attn_layer_norm = LayerNorm32(d, eps)
        self.encoder_attn_text = MHA(d, cfg.num_heads)
        self.encoder_attn_text_layer_norm = LayerNorm32(d, eps)
        self.encoder_attn = DeformAttn(cfg, cfg.num_heads, cfg.decoder_n_points)
        self.encoder_attn_layer_norm = LayerNorm32(d, eps)
        self.fc1 = Linear(d, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, d)
        self.final_layer_norm = LayerNorm32(d, eps)

    def forward(self, queries, query_pos, reference_points, vision, text,
                shapes, text_cross_bias):
        qk = queries + query_pos
        queries = self.self_attn_layer_norm(queries + self.self_attn(qk, qk, queries))
        h = self.encoder_attn_text(queries + query_pos, text, text, text_cross_bias)
        queries = self.encoder_attn_text_layer_norm(queries + h)
        h = self.encoder_attn(queries, vision, reference_points, shapes,
                              position_embeddings=query_pos)
        queries = self.encoder_attn_layer_norm(queries + h)
        return self.final_layer_norm(queries + self.fc2(torch.relu(self.fc1(queries))))


class MLPHead(nn.Module):
    def __init__(self, d_in: int, hidden: int, out: int, layers: int):
        super().__init__()
        self.n = layers
        for i in range(layers):
            self.add_module(f"layers_{i}", Linear(d_in if i == 0 else hidden,
                                                 out if i == layers - 1 else hidden))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def contrastive_logits(query_states, text_states, text_token_mask,
                       max_text_len: int):
    """query @ text^T with padding masked to -inf, padded to max_text_len."""
    out = torch.matmul(query_states.float(), text_states.float().transpose(1, 2))
    out = out.masked_fill(~text_token_mask[:, None, :], float("-inf"))
    pad = max_text_len - out.shape[-1]
    if pad > 0:
        out = torch.nn.functional.pad(out, (0, pad), value=float("-inf"))
    return out[..., :max_text_len]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class GroundingDino(nn.Module):
    """Detection forward: (images, tokens) -> (logits, boxes).

    images [B, H, W, 3] (ImageNet-normalized), input_ids [B, L] with the
    [B, L, L] text self-attention mask and position ids of
    `generate_text_masks`. Returns logits [B, Q, max_text_len] (pre-
    sigmoid) and boxes [B, Q, 4] (cx, cy, w, h in [0, 1]). After a
    forward, `topk_proposal_idx` holds the two-stage selection [B, Q]."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        self.cfg = cfg
        c, d = cfg, cfg.d_model
        self.text_backbone = BertEncoder(c.text)
        self.text_projection = Linear(c.text.hidden_size, d)
        self.backbone = SwinBackbone(c.swin)
        stage_dims = [c.swin.stage_dim(s) for s in sorted(c.swin.out_stages)]
        for i, dim in enumerate(stage_dims):
            self.add_module(f"input_proj_{i}_conv", Conv2d(dim, d, 1))
            self.add_module(f"input_proj_{i}_norm", GroupNorm32(d, 32, 1e-5))
        for i in range(len(stage_dims), c.num_feature_levels):
            cin = stage_dims[-1] if i == len(stage_dims) else d
            self.add_module(f"input_proj_{i}_conv",
                            Conv2d(cin, d, 3, stride=2, padding=1))
            self.add_module(f"input_proj_{i}_norm", GroupNorm32(d, 32, 1e-5))
        self.level_embed = new_param((c.num_feature_levels, d), "normal", 1.0)
        for i in range(c.encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(c))
        self.enc_output = Linear(d, d)
        self.enc_output_norm = LayerNorm32(d, c.layer_norm_eps)
        self.encoder_output_bbox_embed = MLPHead(d, d, 4, 3)
        self.query_position_embeddings = new_param((c.num_queries, d), "normal", 1.0)
        self.bbox_embed = MLPHead(d, d, 4, 3)
        self.decoder_norm = LayerNorm32(d, c.layer_norm_eps)
        self.reference_points_head = MLPHead(2 * d, d, d, 2)
        for i in range(c.decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(c))
        self.topk_proposal_idx = None

    def forward(self, images, input_ids, text_self_attn_mask, position_ids,
                text_token_mask=None):
        c = self.cfg
        dtype = getattr(torch, c.dtype)
        dev = images.device
        b = images.shape[0]
        if text_token_mask is None:
            text_token_mask = torch.ones_like(input_ids, dtype=torch.bool)
        text_token_mask = text_token_mask.bool()

        # ---- text tower ------------------------------------------------
        text_feat = self.text_backbone(input_ids, text_self_attn_mask, None,
                                       position_ids)
        text_feat = self.text_projection(text_feat.to(dtype))

        # ---- vision backbone + projections ----------------------------
        feats = self.backbone(images)
        stages = sorted(feats)
        maps = []
        for i, s in enumerate(stages):
            x = getattr(self, f"input_proj_{i}_conv")(feats[s].to(dtype))
            maps.append(getattr(self, f"input_proj_{i}_norm")(x))
        for i in range(len(stages), c.num_feature_levels):
            src = feats[stages[-1]].to(dtype) if i == len(stages) else maps[-1]
            x = getattr(self, f"input_proj_{i}_conv")(src)
            maps.append(getattr(self, f"input_proj_{i}_norm")(x))

        shapes = tuple((m.shape[1], m.shape[2]) for m in maps)
        srcs, poss = [], []
        for lvl, m in enumerate(maps):
            h, w = m.shape[1], m.shape[2]
            pos = torch.from_numpy(sine_position_2d(
                h, w, c.d_model, c.position_embedding_temperature)).to(dev)
            srcs.append(m.reshape(b, h * w, c.d_model))
            poss.append(pos.reshape(1, h * w, c.d_model)
                        + self.level_embed[lvl][None, None].float())
        vision = torch.cat(srcs, dim=1)
        vision_pos = torch.cat(poss, dim=1).to(dtype)

        # ---- encoder ----------------------------------------------------
        # reference grid per level (valid_ratios == 1: no padding masks)
        refs = []
        for hl, wl in shapes:
            ry = (torch.arange(hl, dtype=torch.float32, device=dev) + 0.5) / hl
            rx = (torch.arange(wl, dtype=torch.float32, device=dev) + 0.5) / wl
            gy, gx = torch.meshgrid(ry, rx, indexing="ij")
            refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        ref_grid = torch.cat(refs, dim=0)                           # [Lv, 2]
        enc_ref = ref_grid[None, :, None, :].expand(
            b, ref_grid.shape[0], c.num_feature_levels, 2)

        text_pos = get_sine_pos_embed(position_ids[..., None].float(),
                                      num_pos_feats=c.d_model,
                                      exchange_xy=False).to(dtype)
        # the -3.4e38 biases stay fp32 and add to fp32 scores
        text_bias = torch.where(text_self_attn_mask[:, None].bool(), 0.0,
                                -3.4e38).float()
        text_pad = ~text_token_mask

        for i in range(c.encoder_layers):
            vision, text_feat = getattr(self, f"encoder_layer{i}")(
                vision, text_feat, vision_pos, text_pos, enc_ref, shapes,
                text_bias, text_pad)

        # ---- two-stage query selection ---------------------------------
        proposals = []
        for lvl, (hl, wl) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(hl, dtype=torch.float32, device=dev),
                                    torch.arange(wl, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid = torch.stack([gx, gy], -1)                        # [H, W, 2]
            center = (grid + 0.5) / torch.tensor([wl, hl], dtype=torch.float32,
                                                 device=dev)
            wh = torch.full_like(center, 0.05 * (2.0 ** lvl))
            proposals.append(torch.cat([center, wh], -1).reshape(-1, 4))
        proposals = torch.cat(proposals, dim=0)[None]               # [1, Lv, 4]
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1, keepdim=True)
        proposal_logits = torch.where(valid, inverse_sigmoid(proposals),
                                      torch.tensor(float("inf"), device=dev))

        obj_query = torch.where(valid, vision, torch.zeros((), dtype=vision.dtype,
                                                           device=dev))
        obj_query = self.enc_output_norm(self.enc_output(obj_query))
        enc_logits = contrastive_logits(obj_query, text_feat, text_token_mask,
                                        c.max_text_len)
        enc_delta = self.encoder_output_bbox_embed(obj_query)
        enc_coord_logits = enc_delta.float() + proposal_logits

        topk_idx = select_top(enc_logits.amax(dim=-1), c.num_queries)   # [B, Q]
        self.topk_proposal_idx = topk_idx
        topk_coords = torch.gather(enc_coord_logits, 1,
                                   topk_idx[..., None].expand(-1, -1, 4))
        reference = torch.sigmoid(topk_coords)                      # [B, Q, 4]
        hidden = self.query_position_embeddings[None].to(dtype).expand(
            b, c.num_queries, c.d_model)

        # ---- decoder ----------------------------------------------------
        text_cross_bias = torch.where(text_token_mask[:, None, None, :], 0.0,
                                      -3.4e38).float()
        logits = boxes = None
        for i in range(c.decoder_layers):
            ref_input = reference[:, :, None, :].expand(
                b, c.num_queries, c.num_feature_levels, 4)
            qpos = get_sine_pos_embed(reference, num_pos_feats=c.d_model // 2)
            qpos = self.reference_points_head(qpos.to(dtype))
            hidden = getattr(self, f"decoder_layer{i}")(
                hidden, qpos, ref_input, vision, text_feat, shapes,
                text_cross_bias)
            hidden_ln = self.decoder_norm(hidden)
            # two delta chains, as HF: the output boxes of level i apply
            # bbox_embed to the layer-normed hidden against the previous
            # reference; the refinement chain feeding level i + 1 applies
            # it to the raw layer output
            delta_out = self.bbox_embed(hidden_ln).float()
            boxes = torch.sigmoid(delta_out + inverse_sigmoid(reference))
            logits = contrastive_logits(hidden_ln, text_feat, text_token_mask,
                                        c.max_text_len)
            delta_raw = self.bbox_embed(hidden).float()
            reference = torch.sigmoid(delta_raw + inverse_sigmoid(reference))
        return logits, boxes
