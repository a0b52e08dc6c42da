"""Two-stage int8 top-k: per-row int8 candidates, then an exact rescore.

The database's scan copy is int8 with one f32 scale per row; each query
is quantized to one int8 digit with its own scale. Stage 1 scores every
row as (f32(s32 dot) * q_scale) * row_scale, two roundings in that order,
and keeps the top `k_fetch = min(max(k * overfetch, k), 128)` candidates
by (-score, idx), rows at or past `n_valid` never scoring and empty slots
holding (-inf, -1). Stage 2 rescores the candidates exactly in fp32
against the full-precision rows and orders them by (-score, idx).

  quantize:  v_i8[r] = round(v[r] / s_r),  s_r = max(max|v[r]| / 127, 1e-12)
  queries:   q_i8 = round(q / c),  c = max(max|q|, 1e-12) / 127

Both quantizers divide (the JAX package's `quantize_rows` and query
scaling do), unlike `ops/quant.py`'s multiply by the inverse with its
1e-30 floor, so the two modules share no quantizer.

On a CUDA tensor stage 1 launches `csrc/topk_stream.cu`'s wgmma scan in
its per-row-scale int8 mode (K12: s8 wgmma with exact s32 sums, the two
scalings in registers, blocks of up to 64 queries); on a CPU tensor it
runs `topk_int8_rows_ref`. The rescore
is plain PyTorch, as it was XLA in the JAX package. No engine path routes
here, as none does in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .quant import fdiv, int_dot
from .topk import WG_INT8_ROWS, _finish, tma_rows, wg_splits

K_FETCH_CAP = 128     # the candidate list's cap (the kernel's k cap)
Q_RESIDENT = 1024     # queries per stage-1 launch


def quantize_rows(v):
    """fp32 [N, d] -> (int8 [N, d], scales f32 [N]), symmetric per row."""
    v32 = torch.as_tensor(v).float()
    scales = torch.clamp(fdiv(v32.abs().amax(dim=1), 127.0), min=1e-12)
    q = torch.clamp(torch.round(v32 / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def quantize_queries(queries: torch.Tensor):
    """[Q, d] -> (int8 [Q, d], scales f32 [Q]): the scale floors the
    abs-max at 1e-12 before dividing by 127."""
    qf = queries.float()
    scales = fdiv(torch.clamp(qf.abs().amax(dim=1), min=1e-12), 127.0)
    q8 = torch.clamp(torch.round(qf / scales[:, None]), -127, 127).to(torch.int8)
    return q8, scales


def topk_int8_rows_ref(db_i8: torch.Tensor, scales: torch.Tensor, q_i8: torch.Tensor,
                       q_scales: torch.Tensor, k: int, n_valid: Optional[int] = None):
    """Plain version of the stage-1 kernel: exact s32 dots, the two scale
    roundings, (-score, idx) order. Returns (scores [Q, k] f32, idx int32)."""
    s = int_dot(q_i8, db_i8).float() * q_scales.float()[:, None]
    s = s * scales.float()[None, :]
    if n_valid is not None and n_valid < s.shape[1]:
        s[:, max(int(n_valid), 0):] = float("-inf")
    return _finish(s, k)


def topk_int8_rows(db_i8: torch.Tensor, scales: torch.Tensor, q_i8: torch.Tensor,
                   q_scales: torch.Tensor, k: int, n_valid: Optional[int] = None):
    """Stage 1: the top-k candidates of int8 rows with per-row scales.

    db_i8 [N, d] int8, scales [N] f32, q_i8 [Q, d] int8, q_scales [Q] f32,
    k <= K_FETCH_CAP. CPU tensors run the plain version; CUDA tensors
    launch the kernel (K12)."""
    n, d = db_i8.shape
    if db_i8.dtype != torch.int8 or q_i8.dtype != torch.int8:
        raise ValueError("topk_int8_rows: rows and queries must be int8")
    if q_i8.ndim != 2 or q_i8.shape[1] != d or scales.shape != (n,) \
            or q_scales.shape != (q_i8.shape[0],):
        raise ValueError(f"topk_int8_rows: shapes disagree: rows {tuple(db_i8.shape)}, "
                         f"scales {tuple(scales.shape)}, queries {tuple(q_i8.shape)}, "
                         f"query scales {tuple(q_scales.shape)}")
    if not 1 <= k <= K_FETCH_CAP:
        raise ValueError(f"topk_int8_rows supports 1 <= k <= {K_FETCH_CAP}, got {k}")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if db_i8.device.type == "cpu":
        return topk_int8_rows_ref(db_i8, scales, q_i8, q_scales, k, n_valid)
    scales = scales.float().contiguous()
    q_scales = q_scales.float().contiguous()
    kernels.require_cuda("topk_int8_rows", db_i8, q_i8, scales, q_scales)
    db_i8 = db_i8.contiguous()
    q_i8 = tma_rows(q_i8)   # [Q, d rounded up to 16]
    qn, dev = q_i8.shape[0], db_i8.device
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_s, out_i
    n_splits = wg_splits(dev, qn, k, n_valid, WG_INT8_ROWS)
    part_s = torch.empty((n_splits, qn, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, qn, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):   # launch on the tensors' card
        status = kernels.lib().rv_topk_int8_rows(
            db_i8.data_ptr(), q_i8.data_ptr(), q_scales.data_ptr(), scales.data_ptr(),
            d, qn, n_valid, k, n_splits, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), kernels.stream_ptr(dev))
    kernels.check("topk_int8_rows", status)
    kernels.launches["topk_int8_rows"] += 1
    kernels.shape_launches[("topk_int8_rows", (qn, n_valid, d, k, False))] += 1
    return out_s, out_i


def rescore(db_full: torch.Tensor, queries: torch.Tensor, cand_idx: torch.Tensor,
            k: int):
    """Exact fp32 rescore of candidates, ordered by (-score, idx); -1 ids
    (and slots past the candidates) stay (-inf, -1)."""
    safe = cand_idx.clamp(0, db_full.shape[0] - 1).long()
    rows = db_full[safe].float()                                  # [Q, K', d]
    # a per-row product and sum: the same rounding whatever the batch size
    s = (rows * queries.float()[:, None, :]).sum(dim=-1)
    s = torch.where(cand_idx >= 0, s, torch.full_like(s, float("-inf")))
    by_id = torch.argsort(cand_idx, dim=1, stable=True)
    order = by_id.gather(1, torch.argsort(-s.gather(1, by_id), dim=1, stable=True))[:, :k]
    out_s = s.gather(1, order)
    out_i = torch.where(torch.isneginf(out_s), -1, cand_idx.gather(1, order))
    return out_s, out_i.to(torch.int32)


def cosine_topk_int8(db_i8: torch.Tensor, scales: torch.Tensor, db_full: torch.Tensor,
                     queries: torch.Tensor, k: int, *, overfetch: int = 4,
                     n_valid: Optional[int] = None):
    """Two-stage int8 top-k. db_i8/scales from `quantize_rows`; db_full is
    the exact-dtype matrix (bf16/fp32) used only to rescore candidates.
    Same output contract as `cosine_topk`, with exact fp32 final scores."""
    if queries.ndim == 1:
        queries = queries[None]
    k_fetch = min(max(k * overfetch, k), K_FETCH_CAP)
    qf = queries.float()
    q_i8, q_scales = quantize_queries(qf)
    outs = []
    if qf.shape[0] == 0:
        w = min(k, k_fetch)
        return (qf.new_empty((0, w)), torch.empty((0, w), dtype=torch.int32,
                                                  device=qf.device))
    for lo in range(0, qf.shape[0], Q_RESIDENT):
        hi = min(qf.shape[0], lo + Q_RESIDENT)
        _, cand = topk_int8_rows(db_i8, scales, q_i8[lo:hi], q_scales[lo:hi],
                                 k_fetch, n_valid)
        outs.append(rescore(db_full, qf[lo:hi], cand, k))
    if len(outs) == 1:
        return outs[0]
    return (torch.cat([s for s, _ in outs]), torch.cat([i for _, i in outs]))
