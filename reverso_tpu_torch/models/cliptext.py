"""CLIP text encoder: text -> joint-embedding-space vectors.

The port of the JAX package's flax text tower. Exposing it enables
search-by-description ("red car at night") against the same
image-embedding database, since PE/CLIP train the two towers into one
space (`Reverso.search_by_text`, the `{"text": ...}` query operand).

Architecture = standard CLIP text transformer: token embedding + learned
positions, causal self-attention blocks, final LayerNorm, features taken
at the first EOT token, linear projection. The numerics are the JAX
tower's: fp32 parameters cast to the activation dtype at use, fp32
LayerNorms, scores cast to fp32, scaled by 1/sqrt(head dim) and then
given the -1e9 causal bias, an fp32 softmax. No TPU kernel computes this
tower (the JAX package left it to XLA), so it stays plain PyTorch
matmuls; in fp32 they are true fp32 products (TF32 stays off, PyTorch's
default), as the JAX tower asks for HIGHEST precision.

Module and parameter names follow the flax tree (`block{i}` becomes
`blocks.{i}`, Dense `kernel` a Linear `weight`), so
`models.convert.text_params_from_flax` maps one onto the other, and
`convert_clip_text` reads the transformers `CLIPTextModelWithProjection`
naming and the OpenAI/PE `transformer.resblocks` naming.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..ops.norm import l2_normalize
from .layers import Embed, LayerNorm32, attend, init_weights, new_param
from .pe import resolve_device
from .vit import Linear


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    context_length: int = 77
    embed_dim: int = 1024        # joint space dim (matches the vision proj)
    act: str = "quick_gelu"
    eot_token_id: int = 49407
    dtype: str = "float32"


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return lambda x: torch.nn.functional.gelu(x, approximate="none")


class TextBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.ln1 = LayerNorm32(w, 1e-5)
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Linear(w, w) for _ in range(4))
        self.ln2 = LayerNorm32(w, 1e-5)
        self.fc1 = Linear(w, int(w * cfg.mlp_ratio))
        self.fc2 = Linear(int(w * cfg.mlp_ratio), w)
        self.act = _act(cfg.act)

    def forward(self, x, causal_bias):
        c = self.cfg
        b, s, _ = x.shape
        hd = c.width // c.num_heads
        y = self.ln1(x)

        def split(t):
            return t.reshape(b, s, c.num_heads, hd).transpose(1, 2)

        o = attend(split(self.q_proj(y)), split(self.k_proj(y)),
                   split(self.v_proj(y)), causal_bias)
        x = x + self.out_proj(o.transpose(1, 2).reshape(b, s, c.width))
        y = self.fc2(self.act(self.fc1(self.ln2(x))))
        return x + y


class ClipTextEncoder(nn.Module):
    """token ids [B, L] -> joint-space embeddings [B, embed_dim]
    (pre-normalization; callers L2-normalize)."""

    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.width)
        self.pos_embed = new_param((cfg.context_length, cfg.width), "normal", 0.01)
        self.blocks = nn.ModuleList(TextBlock(cfg) for _ in range(cfg.depth))
        self.ln_final = LayerNorm32(cfg.width, 1e-5)
        self.proj = Linear(cfg.width, cfg.embed_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dtype = getattr(torch, c.dtype)
        b, l = input_ids.shape
        x = self.token_embedding(input_ids, dtype) + self.pos_embed[:l].to(dtype)
        causal = torch.triu(torch.full((l, l), -1e9, dtype=torch.float32,
                                       device=x.device), diagonal=1)
        for blk in self.blocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        # features at the FIRST eot token of each sequence (the JAX tower's
        # argmax over a 0/1 mask); position 0 where there is none
        pos = torch.arange(l, device=x.device).expand(b, l)
        first = torch.where(input_ids == c.eot_token_id, pos, l).amin(dim=1)
        eot = torch.where(first == l, 0, first)
        return self.proj(x[torch.arange(b, device=x.device), eot])


class TextEmbedder:
    """text -> L2-normalized joint-space embedding (fp32 numpy).

    `params` is the JAX package's flax tree (nested dict of arrays, e.g.
    from `convert_clip_text` or a msgpack file) or this module's state
    dict; `None` draws a seeded init from a `torch.Generator(seed)`. The
    tower runs on one explicit device: `None` means CUDA, and asking for
    CUDA where there is none raises."""

    def __init__(self, cfg: ClipTextConfig, params: Mapping[str, Any] | None,
                 tokenizer, *, device=None, seed: int = 0):
        from .convert import is_flax_tree, text_params_from_flax
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        module = ClipTextEncoder(cfg)
        if params is None:
            init_weights(module, torch.Generator().manual_seed(seed))
        else:
            if is_flax_tree(params):
                params = text_params_from_flax(params, cfg)
            module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v, np.float32))
                 if not isinstance(v, torch.Tensor) else v.float()
                 for k, v in params.items()})
        self.module = module.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_pretrained(cls, ckpt_path: str, vocab_path: str, merges_path: str,
                        cfg: ClipTextConfig | None = None, *, device=None):
        from ..detect.clipbpe import ClipBPETokenizer
        from ..detect.grounded import load_torch_state_dict
        if ckpt_path.endswith(".msgpack"):   # converted by fetch_weights.py
            from .checkpoint import load_meta, load_params
            meta = load_meta(ckpt_path) or {}
            cfg = cfg or (ClipTextConfig(**meta["config"])
                          if "config" in meta else ClipTextConfig())
            params = load_params(ckpt_path)
        else:
            cfg = cfg or ClipTextConfig()
            params = convert_clip_text(load_torch_state_dict(ckpt_path), cfg)
        tok = ClipBPETokenizer(vocab_path, merges_path,
                               context_length=cfg.context_length)
        return cls(cfg, params, tok, device=device)

    def embed(self, texts) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(self.tokenizer(texts), np.int64),
                              device=self.device)
        with torch.inference_mode():
            out = self.module(ids)
        return l2_normalize(out.float()).cpu().numpy()


def convert_clip_text(sd: Mapping[str, Any], cfg: ClipTextConfig) -> dict:
    """transformers CLIPTextModelWithProjection or OpenAI `transformer.*`
    naming -> the flax-layout tree of `ClipTextEncoder`."""
    from .convert import _linear, _ln, _np, _split_qkv

    keys = list(sd.keys())
    params: dict = {}
    if any(k.startswith("text_model.") for k in keys):   # HF naming
        t = "text_model"
        params["token_embedding"] = {
            "embedding": _np(sd[f"{t}.embeddings.token_embedding.weight"])}
        params["pos_embed"] = _np(
            sd[f"{t}.embeddings.position_embedding.weight"])
        for i in range(cfg.depth):
            lp = f"{t}.encoder.layers.{i}"
            params[f"block{i}"] = {
                "ln1": _ln(sd, f"{lp}.layer_norm1"),
                "ln2": _ln(sd, f"{lp}.layer_norm2"),
                "q_proj": _linear(sd, f"{lp}.self_attn.q_proj"),
                "k_proj": _linear(sd, f"{lp}.self_attn.k_proj"),
                "v_proj": _linear(sd, f"{lp}.self_attn.v_proj"),
                "out_proj": _linear(sd, f"{lp}.self_attn.out_proj"),
                "fc1": _linear(sd, f"{lp}.mlp.fc1"),
                "fc2": _linear(sd, f"{lp}.mlp.fc2"),
            }
        params["ln_final"] = _ln(sd, f"{t}.final_layer_norm")
        params["proj"] = {"kernel": _np(sd["text_projection.weight"]).T}
    else:                                                # OpenAI/PE naming
        params["token_embedding"] = {
            "embedding": _np(sd["token_embedding.weight"])}
        params["pos_embed"] = _np(sd["positional_embedding"])
        for i in range(cfg.depth):
            lp = f"transformer.resblocks.{i}"
            blk = {
                "ln1": _ln(sd, f"{lp}.ln_1"),
                "ln2": _ln(sd, f"{lp}.ln_2"),
                "out_proj": _linear(sd, f"{lp}.attn.out_proj"),
                "fc1": _linear(sd, f"{lp}.mlp.c_fc"),
                "fc2": _linear(sd, f"{lp}.mlp.c_proj"),
            }
            bias = sd.get(f"{lp}.attn.in_proj_bias")
            blk.update(_split_qkv(_np(sd[f"{lp}.attn.in_proj_weight"]),
                                  None if bias is None else _np(bias)))
            params[f"block{i}"] = blk
        params["ln_final"] = _ln(sd, "ln_final")
        params["proj"] = {"kernel": _np(sd["text_projection"])}
    return params
