"""MaxSim scoring for multivector spaces (qdrant multivectors /
ColBERT-style late interaction).

Each stored point holds a variable-length [T_i, d] matrix of
sub-vectors; a query (itself [Tq, d], or a single [d] vector) scores a
point as

    score(Q, P) = sum_t  max_m  <Q_t, P_m>      (MaxSim)

The JAX package left this to XLA, so here it is plain PyTorch: a
[Q·Tq, M] product over the flat sub-vector matrix (fp32 queries against
the rows widened to fp32 one chunk at a time, so a bf16 matrix never
exists in fp32 whole; fp32 sums, never TF32), a segment max onto point
ids through `scatter_reduce("amax")` over the sorted segment ids (exact
in any order), then the (-score, idx) top-k. The raggedness lives
entirely in the integer segment ids.

Exactness contract matches the dense scans: ties to the lower row id, -1
in absent slots; zero (padding) query rows add exactly 0; points with NO
sub-vectors never match.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.sharding import on_device, row_ranges
from .topk import _CHUNK_ROWS, _finish, as_row_mask, merge_topk


def seg_ids_of(indptr) -> np.ndarray:
    """[M] int32 point id per sub-vector from the cumulative ends —
    precompute (and device_put) once per index; rebuilding it per
    search costs a host repeat + upload on every call."""
    indptr = np.asarray(indptr, np.int64)
    return np.repeat(np.arange(len(indptr), dtype=np.int32),
                     np.diff(np.concatenate([[0], indptr]))
                     ).astype(np.int32)


def _query_batch(queries, d: int) -> np.ndarray:
    """Normalize the accepted query forms ([d], [Tq, d], or a list of
    such) into one zero-padded [Q, Tq, d] f32 batch (shared by the
    single-device and sharded entry points; zero pad rows score
    exactly 0 in the MaxSim sum)."""
    if not isinstance(queries, (list, tuple)):
        queries = [queries]
    qs = []
    for item in queries:
        a = np.asarray(item, np.float32)
        if a.ndim == 1:
            a = a[None]
        if a.ndim != 2 or (d and a.shape[1] != d):
            raise ValueError(f"query must be [Tq, {d}], got {a.shape}")
        qs.append(a)
    tq = max((len(a) for a in qs), default=1) or 1
    batch = np.zeros((len(qs), tq, d), np.float32)
    for r, a in enumerate(qs):
        batch[r, : len(a)] = a
    return batch


def maxsim_topk(subs: torch.Tensor, indptr, queries, k: int, *,
                row_mask: Optional[np.ndarray] = None, seg_ids=None,
                chunk: int = _CHUNK_ROWS):
    """Exact MaxSim top-k over a flat sub-vector matrix.

    subs:    [M, d] fp32/bf16 sub-vectors, grouped by point in row order
    indptr:  [N] cumulative sub-vector ends (row r owns
             [indptr[r-1], indptr[r]))
    queries: [d], [Tq, d], or a list of such (one result row each;
             ragged Tq is zero-padded to the batch max)
    seg_ids: optional precomputed `seg_ids_of(indptr)` (host or device)
    Returns (scores [Q, k] f32, ids [Q, k] int32) on the matrix's device.
    """
    dev = subs.device
    indptr = np.asarray(indptr, np.int64)
    if len(indptr) == 0 or len(subs) == 0:
        # one empty result row per query (the batch is not built: with no
        # sub-vectors there is no width to hold the queries to)
        nq = len(queries) if isinstance(queries, (list, tuple)) else 1
        return (torch.full((nq, k), float("-inf"), device=dev),
                torch.full((nq, k), -1, dtype=torch.int32, device=dev))
    qb = torch.from_numpy(_query_batch(queries, subs.shape[1])).to(dev)
    return _maxsim_batch(subs, indptr, qb, k, row_mask=row_mask, seg_ids=seg_ids, chunk=chunk)


def _maxsim_batch(subs: torch.Tensor, indptr: np.ndarray, qb: torch.Tensor, k: int, *,
                  row_mask=None, seg_ids=None, chunk: int = _CHUNK_ROWS):
    """`maxsim_topk` of a [Q, Tq, d] fp32 query batch on the matrix's
    device (at least one point with sub-vectors)."""
    dev = subs.device
    n_rows = len(indptr)
    if seg_ids is None:
        seg_ids = seg_ids_of(indptr)
    seg = torch.as_tensor(seg_ids, device=dev).long()
    q, tq, d = qb.shape
    flat = qb.reshape(q * tq, d)
    # per (query row, point) max over the point's sub-vectors; a pad
    # segment n_rows would swallow alignment records
    best = torch.full((q * tq, n_rows), float("-inf"), device=dev)
    for lo in range(0, len(subs), chunk):
        s = flat @ subs[lo:lo + chunk].float().t()                   # [Q*Tq, C]
        best.scatter_reduce_(1, seg[lo:lo + chunk].expand(q * tq, -1), s, "amax")
    per_t = best.reshape(q, tq, n_rows)
    # points with no sub-vectors add 0 here and are masked out below;
    # zero-padded query rows add exactly 0
    per_t = torch.where(torch.isneginf(per_t), 0.0, per_t) \
        * (qb.abs().sum(-1) > 0)[..., None]
    scores = per_t.sum(dim=1)                                       # [Q, N]
    valid = torch.from_numpy(np.diff(np.concatenate([[0], indptr])) > 0).to(dev)
    mask = as_row_mask(row_mask, n_rows, dev)
    if mask is not None:
        valid &= mask.bool()
    return _finish(scores.masked_fill_(~valid[None], float("-inf")), k)


def shard_multivec_layout(indptr, n_shards: int) -> list:
    """Points in contiguous ranges, kept whole: shard s owns points [lo,
    hi) of `row_ranges(N, n_shards)` (ceil(N / n_shards) a shard; the last
    ones may own fewer, or none) and their sub-vectors [a, b). Returns
    [(lo, hi, a, b, local indptr)] with the local ends relative to a."""
    indptr = np.asarray(indptr, np.int64)
    out = []
    for lo, hi in row_ranges(len(indptr), n_shards):
        a = int(indptr[lo - 1]) if lo > 0 else 0
        b = int(indptr[hi - 1]) if hi > lo else a
        out.append((lo, hi, a, b, indptr[lo:hi] - a))
    return out


def sharded_maxsim_topk(parts: list, layout: list, queries, k: int, mesh, *,
                        row_mask=None, seg_ids: Optional[list] = None):
    """Exact MaxSim top-k over a point-sharded multivector space: shard s
    holds the sub-vectors `parts[s]` (on its device) of the points of
    `layout[s]` (`shard_multivec_layout`); each shard with points runs the
    local MaxSim scan on its device, ids shift by the shard's first
    point, and one (-score, global id) merge on the mesh's first device
    gives the single-device result. `row_mask` is over global point ids."""
    d = parts[0].shape[1]
    batch = torch.from_numpy(_query_batch(queries, d))
    n_rows = layout[-1][1] if layout else 0
    mask = as_row_mask(row_mask, n_rows, batch.device) if row_mask is not None else None
    cands = []
    for s, (part, (lo, hi, a, b, ptr)) in enumerate(zip(parts, layout)):
        dev = part.device
        with on_device(dev):
            if b == a:     # no point of this shard has sub-vectors
                continue
            sc, i = _maxsim_batch(part, ptr, batch.to(dev), k,
                                  row_mask=None if mask is None else mask[lo:hi],
                                  seg_ids=None if seg_ids is None else seg_ids[s])
            cands.append((sc, torch.where(i >= 0, i + lo, -1)))
    if not cands:
        return (torch.full((len(batch), k), float("-inf"), device=mesh.first),
                torch.full((len(batch), k), -1, dtype=torch.int32, device=mesh.first))
    return merge_topk(cands, k, mesh.first)


def maxsim_score_rows(sub_rows, query) -> np.ndarray:
    """Host-side exact MaxSim of `query` ([d] or [Tq, d]) against a
    list of per-point [T, d] matrices (None/empty -> -inf). Used for
    candidate rescoring in the universal query."""
    q = np.asarray(query, np.float32)
    if q.ndim == 1:
        q = q[None]
    out = np.full(len(sub_rows), -np.inf, np.float32)
    for r, m in enumerate(sub_rows):
        if m is None or len(m) == 0:
            continue
        s = q @ np.asarray(m, np.float32).T          # [Tq, T]
        out[r] = float(s.max(axis=1).sum())
    return out
