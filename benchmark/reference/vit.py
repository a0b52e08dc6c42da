"""A plain vision transformer of the PE-Core / CLIP family, in fp32.

The forward is written from the published descriptions (PE-Core:
arXiv:2504.13181, 2D axial RoPE, LayerScale, attention pooling; CLIP:
arXiv:2103.00020, pre-LN, class-token pooling, quick-GELU) over a dict
of tensors named as the program's state dict names them, so that one
seeded dict feeds both sides. Every matrix product goes through `mm`,
which a control may replace to compute the same forward in a lower
precision (`lowp`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def plain_fp32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def seq_len(cfg: dict) -> int:
    grid = cfg["image_size"] // cfg["patch_size"]
    return grid * grid + (1 if cfg["use_cls_token"] else 0)


def param_shapes(cfg: dict) -> dict:
    """{name: (shape, kind)}; kind says how a seeded init draws it
    (`weights.py`): "fan_in:<n>", "bias", "norm_w", "norm_b", "gamma",
    "embed"."""
    w, p, e = cfg["width"], cfg["patch_size"], cfg["embed_dim"]
    hid = int(w * cfg["mlp_ratio"])
    if cfg.get("attn_pool_mlp") or cfg.get("attn_pool_heads", cfg["num_heads"]) != cfg["num_heads"]:
        raise ValueError("the attention pool runs over the tower's heads, with a LayerNorm "
                         "after it and no MLP: the only pool the program builds")
    out = {}

    def linear(name, n_in, n_out, bias=True):
        out[f"{name}.weight"] = ((n_out, n_in), f"fan_in:{n_in}")
        if bias:
            out[f"{name}.bias"] = ((n_out,), "bias")

    def norm(name):
        out[f"{name}.weight"] = ((w,), "norm_w")
        out[f"{name}.bias"] = ((w,), "norm_b")

    if cfg["use_cls_token"]:
        out["cls_token"] = ((1, 1, w), "embed")
    if cfg["use_abs_pos"]:
        out["pos_embed"] = ((1, seq_len(cfg), w), "embed")
    out["patch_embed.weight"] = ((w, 3, p, p), f"fan_in:{3 * p * p}")
    if cfg["patch_bias"]:
        out["patch_embed.bias"] = ((w,), "bias")
    if cfg["use_ln_pre"]:
        norm("ln_pre")
    for i in range(cfg["depth"]):
        b = f"blocks.{i}"
        norm(f"{b}.ln1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{b}.attn.{proj}", w, w)
        norm(f"{b}.ln2")
        linear(f"{b}.mlp.fc1", w, hid)
        linear(f"{b}.mlp.fc2", hid, w)
        if cfg["layer_scale_init"] is not None:
            out[f"{b}.ls1.gamma"] = ((w,), "gamma")
            out[f"{b}.ls2.gamma"] = ((w,), "gamma")
    if cfg["use_ln_post"]:
        norm("ln_post")
    if cfg["pool_type"] == "attn":
        out["attn_pool.probe"] = ((1, 1, w), "embed")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"attn_pool.{proj}", w, w)
        norm("attn_pool.ln")
    linear("proj", w, e, bias=False)
    return out


def rope_tables(grid: int, head_dim: int, cls_token: bool, base: float = 10000.0):
    """2D axial RoPE: the head dim in halves, the first rotating with the
    patch's column, the second with its row, each half in head_dim / 4
    rotate-half pairs at geometric frequencies; the class token is not
    rotated. (cos, sin) [S, head_dim] in float32."""
    d_axis = head_dim // 2
    n_freq = d_axis // 2
    freqs = base ** (-np.arange(n_freq, dtype=np.float64) * 2 / d_axis)
    pos = np.arange(grid * grid)
    ang_x = (pos % grid)[:, None] * freqs[None, :]
    ang_y = (pos // grid)[:, None] * freqs[None, :]
    ang = np.concatenate([ang_x, ang_x, ang_y, ang_y], axis=1)
    cos, sin = np.cos(ang), np.sin(ang)
    if cls_token:
        cos = np.concatenate([np.ones((1, head_dim)), cos])
        sin = np.concatenate([np.zeros((1, head_dim)), sin])
    return torch.from_numpy(cos.astype(np.float32)), torch.from_numpy(sin.astype(np.float32))


def _rotate(x, cos, sin):
    q = x.shape[-1] // 4
    a, b, c, d = x[..., :q], x[..., q:2 * q], x[..., 2 * q:3 * q], x[..., 3 * q:]
    return x * cos + torch.cat([-b, a, -d, c], dim=-1) * sin


def matmul(a, b):
    return a @ b


def lowp(fmt: torch.dtype):
    """An `mm` that rounds both operands to `fmt` (an fp8 or other narrow
    float type) at a per-tensor scale, then multiplies in fp32: the same
    forward one precision step down. Gradients pass the rounding
    unchanged (a straight-through estimate)."""
    top = torch.finfo(fmt).max

    def q(t):
        with torch.no_grad():
            s = t.abs().amax().clamp(min=1e-30) / top
            r = (t / s).to(fmt).to(torch.float32) * s
        return t + (r - t).detach() if t.requires_grad else r

    return lambda a, b: q(a) @ q(b)


class Tower:
    """The forward over `params` (fp32 tensors by name), `cfg` the
    configuration file's dict."""

    def __init__(self, cfg: dict, params: dict, mm=matmul):
        self.cfg, self.p, self.mm = cfg, params, mm
        self.heads = cfg["num_heads"]
        self.hd = cfg["width"] // self.heads
        self.rope = None
        if cfg["use_rope"]:
            grid = cfg["image_size"] // cfg["patch_size"]
            dev = next(iter(params.values())).device
            self.rope = tuple(t.to(dev) for t in rope_tables(grid, self.hd, cfg["use_cls_token"]))

    def linear(self, x, name, bias=True):
        y = self.mm(x, self.p[f"{name}.weight"].t())
        return y + self.p[f"{name}.bias"] if bias else y

    def norm(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            1e-5)

    def act(self, x):
        if self.cfg["act"] == "gelu":
            return F.gelu(x)
        return x * torch.sigmoid(1.702 * x)

    def split(self, t):
        b, s, _ = t.shape
        return t.reshape(b, s, self.heads, self.hd).transpose(1, 2)

    def attention(self, q, k, v):
        """Softmax attention over [B, H, S, hd] heads, scaled by hd^-1/2."""
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(self.hd)
        return self.mm(torch.softmax(s, dim=-1), v)

    def block(self, x, i):
        b = f"blocks.{i}"
        h = self.norm(x, f"{b}.ln1")
        q, k, v = (self.split(self.linear(h, f"{b}.attn.{n}")) for n in ("q_proj", "k_proj",
                                                                          "v_proj"))
        if self.rope is not None:
            q, k = _rotate(q, *self.rope), _rotate(k, *self.rope)
        o = self.attention(q, k, v).transpose(1, 2).reshape(x.shape)
        y = self.linear(o, f"{b}.attn.out_proj")
        if f"{b}.ls1.gamma" in self.p:
            y = y * self.p[f"{b}.ls1.gamma"]
        x = x + y
        y = self.linear(self.act(self.linear(self.norm(x, f"{b}.ln2"), f"{b}.mlp.fc1")),
                        f"{b}.mlp.fc2")
        if f"{b}.ls2.gamma" in self.p:
            y = y * self.p[f"{b}.ls2.gamma"]
        return x + y

    def embed(self, images, block=None):
        """images [B, H, W, 3] fp32 (preprocessed) -> the unnormalized
        output [B, embed_dim]. `block(fn, x, i)` may wrap each block's call
        (as `torch.utils.checkpoint` does)."""
        cfg, p = self.cfg, self.p
        x = images.permute(0, 3, 1, 2)
        ps = cfg["patch_size"]
        x = F.unfold(x, ps, stride=ps).transpose(1, 2)      # [B, P, 3 p p], (c, y, x) order
        x = self.mm(x, p["patch_embed.weight"].reshape(cfg["width"], -1).t())
        if "patch_embed.bias" in p:
            x = x + p["patch_embed.bias"]
        n = x.shape[0]
        if cfg["use_cls_token"]:
            x = torch.cat([p["cls_token"].expand(n, 1, -1), x], dim=1)
        if cfg["use_abs_pos"]:
            x = x + p["pos_embed"]
        if cfg["use_ln_pre"]:
            x = self.norm(x, "ln_pre")
        for i in range(cfg["depth"]):
            x = self.block(x, i) if block is None else block(self.block, x, i)
        if cfg["pool_type"] == "attn":
            t = self.norm(x, "ln_post") if cfg["use_ln_post"] else x
            q = self.split(self.linear(p["attn_pool.probe"].expand(n, 1, -1), "attn_pool.q_proj"))
            k = self.split(self.linear(t, "attn_pool.k_proj"))
            v = self.split(self.linear(t, "attn_pool.v_proj"))
            o = self.attention(q, k, v).transpose(1, 2).reshape(n, 1, -1)
            pooled = self.norm(self.linear(o, "attn_pool.out_proj"), "attn_pool.ln")[:, 0]
        else:
            pooled = x[:, 0] if cfg["pool_type"] == "cls" else x.mean(dim=1)
            if cfg["use_ln_post"]:
                pooled = self.norm(pooled, "ln_post")
        return self.linear(pooled, "proj", bias=False)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
