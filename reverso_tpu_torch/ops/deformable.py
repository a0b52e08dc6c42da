"""Multi-scale deformable attention: the CUDA kernel and its plain version.

GroundingDINO's core op. Layouts follow the transformers implementation
(and the JAX package's `ops.deformable`):

  value              [B, Lv, H, D]     (flattened multi-scale features)
  spatial_shapes     ((H0, W0), (H1, W1), ...)
  sampling_locations [B, Lq, H, L, P, 2]   normalized (x, y) in [0, 1]
  attention_weights  [B, Lq, H, L, P]      softmaxed over L*P
  returns            [B, Lq, H * D]        in the value dtype

Sampling is bilinear with `grid_sample(padding_mode="zeros",
align_corners=False)` semantics. Coordinates and the weighted sum are
fp32 whatever the value dtype: bf16 normalized coordinates would move
sampling points by ~0.5 px at a 100-wide level.

`ms_deform_attn` launches `csrc/ms_deform.cu` on a CUDA tensor (a warp per
(b, q, h), vector corner loads) and runs `ms_deform_attn_ref` on a CPU
tensor.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels


def _bilinear_ref(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Zero-padded bilinear sampling. img [N, Hl, Wl, D] (fp32); px, py
    [N, S] pixel coordinates (norm * size - 0.5). Returns [N, S, D]."""
    n, hl, wl, d = img.shape
    px = px.clamp(-1.0, float(wl))
    py = py.clamp(-1.0, float(hl))
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0)[..., None], (py - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(n, hl * wl, d)

    def corner(yy, xx):
        ok = (yy >= 0) & (yy < hl) & (xx >= 0) & (xx < wl)
        idx = (yy.clamp(0, hl - 1) * wl + xx.clamp(0, wl - 1))
        got = flat.gather(1, idx[..., None].expand(-1, -1, d))
        return got * ok[..., None]

    top = corner(y0, x0) * (1 - fx) + corner(y0, x0 + 1) * fx
    bot = corner(y0 + 1, x0) * (1 - fx) + corner(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def ms_deform_attn_ref(value: torch.Tensor,
                       spatial_shapes: Sequence[tuple[int, int]],
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version: per level, four corner gathers per sample in fp32."""
    b, lv, h, d = value.shape
    _, lq, _, n_levels, n_points, _ = sampling_locations.shape
    if n_levels != len(spatial_shapes):
        raise ValueError(f"{n_levels} levels of locations, "
                         f"{len(spatial_shapes)} spatial shapes")
    out = value.new_zeros((b, lq, h, d), dtype=torch.float32)
    start = 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v = value[:, start:start + hl * wl].float()
        v = v.permute(0, 2, 1, 3).reshape(b * h, hl, wl, d)
        loc = sampling_locations[:, :, :, lvl].float()          # [B, Lq, H, P, 2]
        loc = loc.permute(0, 2, 1, 3, 4).reshape(b * h, lq * n_points, 2)
        sampled = _bilinear_ref(v, loc[..., 0] * wl - 0.5, loc[..., 1] * hl - 0.5)
        sampled = sampled.reshape(b, h, lq, n_points, d)
        wgt = attention_weights[:, :, :, lvl].float()           # [B, Lq, H, P]
        wgt = wgt.permute(0, 2, 1, 3)[..., None]                # [B, H, Lq, P, 1]
        out = out + (sampled * wgt).sum(3).permute(0, 2, 1, 3)
        start += hl * wl
    return out.reshape(b, lq, h * d).to(value.dtype)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Multi-scale deformable attention (shapes in the module docstring).

    CPU tensors run `ms_deform_attn_ref`; CUDA tensors launch the kernel."""
    if value.device.type == "cpu":
        return ms_deform_attn_ref(value, spatial_shapes, sampling_locations,
                                  attention_weights)
    b, lv, h, d = value.shape
    _, lq, _, n_levels, n_points, _ = sampling_locations.shape
    shapes = [(int(hl), int(wl)) for hl, wl in spatial_shapes]
    if n_levels != len(shapes) or sum(hl * wl for hl, wl in shapes) != lv:
        raise ValueError(f"spatial shapes {shapes} do not cover {lv} value rows "
                         f"in {n_levels} levels")
    if sampling_locations.shape != (b, lq, h, n_levels, n_points, 2) \
            or attention_weights.shape != (b, lq, h, n_levels, n_points):
        raise ValueError(f"location/weight shapes {tuple(sampling_locations.shape)} "
                         f"/ {tuple(attention_weights.shape)} disagree with value "
                         f"{tuple(value.shape)}")
    if value.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"ms_deform_attn: unsupported value dtype {value.dtype}")
    value = value.contiguous()
    loc = sampling_locations.to(torch.float32).contiguous()
    attw = attention_weights.to(torch.float32).contiguous()
    starts, start = [], 0
    for hl, wl in shapes:
        starts.append(start)
        start += hl * wl
    levels = torch.tensor([[hl, wl, s0] for (hl, wl), s0 in zip(shapes, starts)],
                          dtype=torch.int32)
    if value.device.type == "cuda":
        levels = levels.to(value.device, non_blocking=True)
    kernels.require_cuda("ms_deform_attn", value, loc, attw, levels)
    out = torch.empty((b, lq, h * d), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):   # launch on the tensors' card
        status = kernels.lib().rv_ms_deform(
            value.data_ptr(), levels.data_ptr(), loc.data_ptr(), attw.data_ptr(),
            out.data_ptr(), b, lv, lq, h, d, n_levels, n_points,
            kernels.DTYPE_CODES[value.dtype], kernels.stream_ptr(value.device))
    kernels.check("ms_deform_attn", status)
    kernels.launches["ms_deform"] += 1
    kernels.shape_launches[("ms_deform", (b, lq, tuple(shapes), h, d, n_points,
                                          str(value.dtype)))] += 1
    return out
