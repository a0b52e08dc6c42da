"""Exact cosine top-k search: the streaming CUDA kernel and its plain version.

The database is a device-resident [N, d] matrix of L2-normalized vectors
(bf16 or fp32 storage, fp32 accumulation). Results are ordered by
(-score, index): ties go to the lower row, rows at or past `n_valid` never
score, and slots beyond the valid rows come back as (score -inf, idx -1).
On a CUDA tensor `cosine_topk` launches `csrc/topk_stream.cu`, whose two
passes never materialize the [Q, N] score matrix; on a CPU tensor it runs
`cosine_topk_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..utils.logging import get_logger

log = get_logger("ops.topk")

# k cap of the CUDA kernel (TOPK_KMAX in csrc/topk_stream.cu)
K_CAP = 128
_QUERY_TILE = 64   # TOPK_QT in csrc/topk_stream.cu
_ROW_TILE = 64     # TOPK_RT


def _select_topk(scores: torch.Tensor, k: int):
    """Exact (-score, idx)-ordered top-k of each row of [Q, N] fp32 scores.
    `torch.topk` picks any of several equal scores at the k-th place; the
    boundary ties are re-picked as the lowest indices."""
    vals, _ = torch.topk(scores, k, dim=1)
    kth = vals[:, -1:]
    eq = scores == kth
    need = k - (scores > kth).sum(dim=1, keepdim=True)
    sel = (scores > kth) | (eq & (torch.cumsum(eq.to(torch.int32), dim=1) <= need))
    cols = torch.nonzero(sel)[:, 1].reshape(scores.shape[0], k)  # ascending
    s = scores.gather(1, cols)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    return s.gather(1, order), cols.gather(1, order)


def cosine_topk_ref(db: torch.Tensor, queries: torch.Tensor, k: int,
                    n_valid: Optional[int] = None):
    """Exact top-k by full score materialization.

    db: [N, d] L2-normalized. queries: [Q, d] L2-normalized.
    Returns (scores [Q, k] f32, idx [Q, k] int32), ordered by (-score, idx).
    """
    n = db.shape[0]
    scores = torch.matmul(queries.to(db.dtype).float(), db.float().t())
    if n_valid is not None and n_valid < n:
        scores[:, max(int(n_valid), 0):] = float("-inf")
    q = scores.shape[0]
    k_eff = min(k, n)
    if k_eff > 0:
        top_s, top_i = _select_topk(scores, k_eff)
        top_i = torch.where(torch.isneginf(top_s), -1, top_i)
    else:
        top_s = scores.new_empty((q, 0))
        top_i = torch.empty((q, 0), dtype=torch.int64, device=scores.device)
    if k_eff < k:
        top_s = torch.cat([top_s, top_s.new_full((q, k - k_eff), float("-inf"))], 1)
        top_i = torch.cat([top_i, top_i.new_full((q, k - k_eff), -1)], 1)
    return top_s.float(), top_i.to(torch.int32)


def _topk_cuda(db: torch.Tensor, queries: torch.Tensor, k: int, n_valid: int):
    n, d = db.shape
    q = queries.shape[0]
    if db.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"cosine_topk: unsupported dtype {db.dtype}")
    kernels.require_cuda("cosine_topk", db, queries)
    dev = db.device
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return out_s, out_i
    # about two waves of CTAs over the SMs, split along the rows
    n_q_tiles = -(-q // _QUERY_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_row_tiles = max(1, -(-n_valid // _ROW_TILE))
    n_splits = max(1, min(-(-2 * sms // n_q_tiles), n_row_tiles))
    part_s = torch.empty((n_splits, q, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(db.device):   # launch on the tensors' card
        status = kernels.lib().rv_topk_stream(
            db.data_ptr(), queries.data_ptr(), d, q, n_valid, k, n_splits,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), kernels.DTYPE_CODES[db.dtype],
            kernels.stream_ptr(dev))
    kernels.check("cosine_topk", status)
    kernels.launches["topk_stream"] += 1
    return out_s, out_i


def cosine_topk(db: torch.Tensor, queries: torch.Tensor, k: int,
                n_valid: Optional[int] = None):
    """Fused exact cosine top-k; same contract as `cosine_topk_ref`.

    Queries are cast to the database dtype. Above the kernel's k cap
    (K_CAP) a CUDA search takes the plain version — a shape rule, logged
    and counted in `kernels.plain_dispatches`."""
    n, d = db.shape
    queries = queries.to(db.dtype)
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} do not match db "
                         f"{tuple(db.shape)}")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if db.device.type == "cpu":
        return cosine_topk_ref(db, queries, k, n_valid=n_valid)
    if k > K_CAP:
        log.info(f"k={k} above the top-k kernel cap {K_CAP}: plain scan")
        kernels.plain_dispatches["topk_above_cap"] += 1
        return cosine_topk_ref(db, queries, k, n_valid=n_valid)
    return _topk_cuda(db, queries.contiguous(), k, n_valid)


def apply_score_threshold(scores: torch.Tensor, idx: torch.Tensor,
                          threshold: float):
    """Invalidate hits below threshold (keep score >= threshold).

    Returns (scores, idx, valid_mask); invalid idx slots become -1.
    """
    mask = scores >= threshold
    return scores, torch.where(mask, idx, torch.full_like(idx, -1)), mask
