"""Manhattan (L1) distance top-k scans.

Completes the store's distances (cosine / dot / euclid / manhattan). Cosine
and dot run on the top-k kernel and euclid maps onto it through the norm
augmentation (`store/index.py`), but L1 has no inner-product factorization:
`sum |q - x|` is elementwise by nature. The JAX package left this scan to
XLA, so here it is plain PyTorch: a chunked scan whose [Q, chunk] score
block is `torch.cdist(p=1)` (no [Q, chunk, d] broadcast exists), merged
into a running top-k (`ops.topk.scan_topk`), so the full [Q, N] matrix
never exists.

Scores are NEGATED distances in fp32 (higher-is-better ordering
everywhere, like the euclid path), the rows upcast per chunk (bf16 storage
rounds the rows, the trade every dense scan here makes); ties break to the
lower row id; -1 marks absent slots.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .topk import as_queries, as_shards, merge_topk, scan_topk, shard_candidates

# elements of the [chunk, d] row block per scan step
_CHUNK_ELEMS = 4 * 1024 * 1024


def manhattan_topk(db: torch.Tensor, queries: torch.Tensor, k: int,
                   n_valid: Optional[int] = None, row_mask=None, *,
                   chunk: Optional[int] = None):
    """Exact Manhattan top-k: scores are -sum_i |q_i - x_i| in fp32.

    db: [N, d] in any float dtype; queries: [Q, d]. Returns (scores [Q, k]
    f32, idx [Q, k] int32) in (-score, idx) order; `row_mask` ([N] bool)
    excludes rows exactly; `n_valid` masks trailing rows."""
    n, d = db.shape
    q32 = queries.to(db.device, torch.float32)
    if chunk is None:
        chunk = max(128, _CHUNK_ELEMS // max(d, 1) // 128 * 128)
    return scan_topk(lambda lo, hi: -torch.cdist(q32, db[lo:hi].float(), p=1.0),
                     n, q32.shape[0], k, db.device, n_valid=n_valid,
                     row_mask=row_mask, chunk=chunk)


def manhattan_topk_host(vectors: np.ndarray, queries: np.ndarray, k: int,
                        *, row_mask=None, chunk: int = 16384):
    """Host (numpy) exact Manhattan top-k — the HostIndex counterpart
    for no-accelerator deployments. Same result contract. Carries a
    running top-k across row chunks (the [Q, N] score matrix never
    materializes — at 1M rows x 256 queries it would be a gigabyte;
    memory stays O(Q * (k + chunk)))."""
    v = np.asarray(vectors, np.float32)
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None]
    n = len(v)
    nq = len(q)
    keep = None
    if row_mask is not None:
        keep = np.asarray(row_mask, bool)[:n]
    k_eff = min(k, n)
    run_s = np.full((nq, k_eff), -np.inf, np.float32)
    run_i = np.full((nq, k_eff), -1, np.int64)
    for lo in range(0, n, chunk):
        block = v[lo:lo + chunk]
        s = -np.abs(q[:, None, :] - block[None]).sum(
            -1, dtype=np.float32)
        cols = np.arange(lo, lo + len(block))
        if keep is not None:
            s[:, ~keep[lo:lo + len(block)]] = -np.inf
        # merge: carry (lower ids) precedes the chunk; lexsort on
        # (-score, id) keeps the exact tie order
        all_s = np.concatenate([run_s, s], axis=1)
        all_i = np.concatenate(
            [run_i, cols[None].repeat(nq, 0)], axis=1)
        # absent carry slots (id -1) must sort last: their score is
        # -inf, and lexsort's id key only breaks FINITE ties
        order = np.lexsort(
            (np.where(all_i < 0, np.iinfo(np.int64).max, all_i),
             -all_s), axis=1)[:, :k_eff]
        run_s = np.take_along_axis(all_s, order, axis=1)
        run_i = np.take_along_axis(all_i, order, axis=1)
    out_s = np.full((nq, k), -np.inf, np.float32)
    out_i = np.full((nq, k), -1, np.int32)
    if n:
        out_s[:, :k_eff] = run_s
        out_i[:, :k_eff] = run_i.astype(np.int32)
        out_i[np.isneginf(out_s)] = -1
    return out_s, out_i


def sharded_manhattan_topk(db, queries, k: int, mesh, axis: str = "data",
                           n_valid=None, row_mask=None):
    """Manhattan top-k over rows row-sharded across `axis` (a `Shards`,
    or the whole matrix, sharded here): the chunked L1 scan on each shard
    with its own valid count, then one (-score, global id) merge on the
    mesh's first device; the single-device scan's result."""
    cands = shard_candidates(
        as_shards(db, mesh, axis), as_queries(queries), k,
        lambda part, q, lv, m: manhattan_topk(part, q, k, n_valid=lv, row_mask=m),
        n_valid=n_valid, row_mask=row_mask)
    return merge_topk(cands, k, mesh.first)
