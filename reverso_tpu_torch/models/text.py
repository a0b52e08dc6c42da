"""BERT text encoder (GroundingDINO's text tower) in PyTorch.

After the JAX package's `models.text` (itself after transformers'
`BertModel` without the pooler): static [B, L] tokens with a [B, L] or
[B, L, L] attention mask and optional position ids. Plain PyTorch: BERT
sequences here are at most 256 tokens. Module names follow the flax tree.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Embed, LayerNorm32, attend, new_param
from .vit import Linear


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), Linear(d, d)

    def forward(self, x, mask_bias):
        c = self.cfg
        b, s, _ = x.shape
        split = lambda t: t.reshape(b, s, c.num_heads, -1).transpose(1, 2)
        o = attend(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                   mask_bias)
        return o.transpose(1, 2).reshape(b, s, c.hidden_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self = BertSelfAttention(cfg)   # the flax module is named "self"
        self.attn_output = Linear(d, d)
        self.attn_ln = LayerNorm32(d, eps)
        self.intermediate = Linear(d, cfg.intermediate_size)
        self.output = Linear(cfg.intermediate_size, d)
        self.out_ln = LayerNorm32(d, eps)

    def forward(self, x, mask_bias):
        x = self.attn_ln(x + self.attn_output(self.self(x, mask_bias)))
        return self.out_ln(x + self.output(F.gelu(self.intermediate(x))))


class BertEncoder(nn.Module):
    """BERT without pooler: token ids -> [B, L, H] features.

    attention_mask may be [B, L] (padding) or [B, L, L] (GroundingDINO's
    block-diagonal per-phrase mask); position_ids override the arange
    (GroundingDINO restarts positions at each phrase)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, d)
        self.position_embeddings = new_param(
            (cfg.max_position_embeddings, d), "normal", 0.02)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, d)
        self.emb_ln = LayerNorm32(d, cfg.layer_norm_eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layer{i}", BertLayer(cfg))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        c = self.cfg
        dtype = getattr(torch, c.dtype)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.word_embeddings(input_ids, dtype)
        if position_ids is None:
            emb = emb + self.position_embeddings[None, :input_ids.shape[1]].to(dtype)
        else:
            emb = emb + self.position_embeddings[position_ids].to(dtype)
        emb = emb + self.token_type_embeddings(token_type_ids, dtype)
        x = self.emb_ln(emb)
        ext = (attention_mask[:, None] if attention_mask.dim() == 3
               else attention_mask[:, None, None])
        mask_bias = torch.where(ext > 0, 0.0, -1e9).float()
        for i in range(c.num_layers):
            x = getattr(self, f"layer{i}")(x, mask_bias)
        return x
