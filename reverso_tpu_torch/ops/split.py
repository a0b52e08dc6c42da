"""fp32 operands as three bf16 parts: the split pass and the split products.

The TPU kernels multiply fp32 operands at Precision.HIGHEST: each value
becomes three bf16 parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
hi - mid), and a product is the six bf16 products of the parts that
matter, summed in fp32 (`split_matmul`). The port's fp32 kernels compute
the same on the tensor cores: the attention core's split mode
(`csrc/flash_tc.cuh`) splits its operands in shared memory; the MLP's
split GEMMs (`csrc/fused_mlp.cu`) read the parts from device memory,
written by the split pass.

`split_parts` is that pass: rows of a [rows, cols] tensor into a bf16
[parts, out_rows, pitch] tensor, the pitch a multiple of 8 (TMA's 16-byte
row strides), the pad columns and rows zero; three parts of fp32 values,
or one (the value rounded to bf16). On a CUDA tensor it launches
`rv_split_parts`; on a CPU tensor it runs `split_parts_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels

# the row pitch unit in elements: 16 bytes of bf16 (TMA's row strides)
PITCH = 8

# the split mode's six products, smallest first: (A part, B part) with 0 hi,
# 1 mid, 2 lo (the table in csrc/hopper.cuh::split_part)
SPLIT_TERMS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split3(x: torch.Tensor) -> tuple:
    """fp32 x as three bf16-valued fp32 parts, hi = bf16(x), mid = bf16(x -
    hi), lo = bf16(x - hi - mid): hi + mid + lo == x exactly wherever the
    parts are normal (the subtractions are exact in fp32)."""
    x = x.float()
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 from the six bf16 products of their three-way splits,
    summed smallest first (the TPU's Precision.HIGHEST on bf16 units)."""
    ap, bp = split3(a), split3(b)
    out = None
    for i, j in SPLIT_TERMS:
        t = torch.matmul(ap[i], bp[j])
        out = t if out is None else out + t
    return out


def round_pitch(n: int) -> int:
    return -(-n // PITCH) * PITCH


def split_parts_ref(x: torch.Tensor, parts: int,
                    out_rows: Optional[int] = None) -> torch.Tensor:
    """Plain version of the split pass: [rows, cols] -> bf16 [parts,
    out_rows, pitch], hi, mid and lo of the fp32 values (parts = 3) or the
    values rounded to bf16 (parts = 1), zeros past the rows and columns."""
    rows, cols = x.shape
    out_rows = rows if out_rows is None else out_rows
    out = torch.zeros((parts, out_rows, round_pitch(cols)), dtype=torch.bfloat16,
                      device=x.device)
    vals = split3(x) if parts == 3 else (x.float(),)
    for p, v in enumerate(vals):
        out[p, :rows, :cols] = v.to(torch.bfloat16)
    return out


def split_parts(x: torch.Tensor, parts: int, out_rows: Optional[int] = None) -> torch.Tensor:
    """The split pass over a [rows, cols] fp32 (parts 3 or 1) or bf16
    (parts 1) tensor; CPU tensors run the plain version."""
    if x.dim() != 2 or parts not in (1, 3):
        raise ValueError(f"split_parts: a [rows, cols] tensor and 1 or 3 parts, got "
                         f"{tuple(x.shape)}, {parts}")
    if x.dtype not in kernels.DTYPE_CODES or (parts == 3 and x.dtype != torch.float32):
        raise ValueError(f"split_parts: {parts} parts of {x.dtype}")
    rows, cols = x.shape
    out_rows = rows if out_rows is None else out_rows
    if out_rows < rows:
        raise ValueError(f"split_parts: out_rows {out_rows} < rows {rows}")
    if x.device.type == "cpu":
        return split_parts_ref(x, parts, out_rows)
    x = x.contiguous()
    kernels.require_cuda("split_parts", x)
    out = torch.empty((parts, out_rows, round_pitch(cols)), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):   # launch on the tensor's card
        status = kernels.lib().rv_split_parts(
            x.data_ptr(), out.data_ptr(), rows, cols, out_rows, out.shape[2], parts,
            kernels.DTYPE_CODES[x.dtype], kernels.stream_ptr(x.device))
    kernels.check("split_parts", status)
    kernels.launches["split_parts"] += 1
    return out
