"""Recommendation search: query by positive / negative example points.

qdrant's points API exposes `recommend` (positive and negative example
points, two strategies) and the discovery searches; the JAX package
rebuilt them for its store and left them to XLA, so here they are plain
PyTorch on the index's device, with numpy twins for the host index:

  * ``sum_scores`` / ``average`` — compose ONE query vector on the host
    (`sum_scores_query`, `average_query`) for the ordinary top-k scan.

  * ``best_score`` — score every database row against EVERY example and
    rank by qdrant's best-score combine: a row scoring ``bp`` against its
    best positive and ``bn`` against its best negative gets
    ``bp if bp > bn else -(bn * bn)``.

  * ``discover`` — a target plus (positive, negative) context PAIRS: each
    pair votes +1 when the row scores higher against its positive than its
    negative, else -1; rows rank by votes, then target similarity, as one
    exact fp32 key ``votes * 4 + sim``.

  * ``context`` — pairs only: rows rank by ``sum_i min(0, s_pos_i -
    s_neg_i)``.

  * `matrix_topk` — pairwise nearest neighbours within a sample (the
    distance-matrix API's scoring core), self-pairs and pad rows masked.

The example scores are fp32 products at full fp32 (the reference's
Precision.HIGHEST; never TF32) of the examples rounded to the database
dtype against the rows, chunk by chunk (`_combined_scan`): an int8
database is dequantized (`rows * scale`) one chunk at a time, so its full
fp32 copy never exists, and a bf16 one is widened one chunk at a time.
Only the per-row combined scalar survives each chunk.

Result contract matches the rest of the repo: ordered by ``(-score,
idx)``, ties to the lower row id, ``-1`` marks absent slots.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .topk import (_CHUNK_ROWS, _finish, as_queries, as_row_mask, as_shards, merge_topk,
                   shard_candidates)


def sum_scores_query(positives, negatives=None) -> np.ndarray:
    """Compose qdrant's sum_scores recommend strategy into ONE query.

    score(row) = sum_p <row, p> - sum_n <row, n> = <row, sum(p) - sum(n)>
    by linearity of the dot product, so the strategy is exact through
    any dot/cosine index in a single fused-kernel search and the
    returned scores ARE the summed similarities. The composed vector is
    deliberately NOT normalized (that would rescale the scores).
    Returns a [d] float32 vector."""
    pos = np.asarray(positives, np.float32)
    if pos.ndim == 1:
        pos = pos[None]
    if pos.shape[0] == 0:
        raise ValueError("recommend needs at least one positive example")
    q = pos.sum(axis=0)
    if negatives is not None:
        neg = np.asarray(negatives, np.float32)
        if neg.ndim == 1:
            neg = neg[None]
        if neg.shape[0]:
            q = q - neg.sum(axis=0)
    return q.astype(np.float32)


def average_query(positives, negatives=None) -> np.ndarray:
    """Compose one L2-normalized query from example vectors (host-side).

    qdrant's average_vector strategy: ``avg(pos) + (avg(pos) - avg(neg))``
    — the positive centroid pushed away from the negative one. Examples
    are L2-normalized first so one long vector cannot dominate the
    average. Returns a [d] float32 unit vector.
    """
    pos = np.asarray(positives, np.float32)
    if pos.ndim == 1:
        pos = pos[None]
    if pos.shape[0] == 0:
        raise ValueError("recommend needs at least one positive example")

    def _unit_mean(x):
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        return x.mean(axis=0)

    q = _unit_mean(pos)
    if negatives is not None:
        neg = np.asarray(negatives, np.float32)
        if neg.ndim == 1:
            neg = neg[None]
        if neg.shape[0]:
            q = q + (q - _unit_mean(neg))
    return q / max(float(np.linalg.norm(q)), 1e-30)


def _combine(s: torch.Tensor, n_pos: int) -> torch.Tensor:
    """[E, C] example scores -> [C] best-score combine (positives first)."""
    bp = s[:n_pos].amax(dim=0)
    if s.shape[0] == n_pos:
        return bp
    bn = s[n_pos:].amax(dim=0)
    return torch.where(bp > bn, bp, -(bn * bn))


def _discover_combine(s: torch.Tensor, n_pairs: int) -> torch.Tensor:
    """[1 + 2P, C] scores (target; pair positives; pair negatives) ->
    [C] discover keys: pair votes lexicographically over target sim."""
    if n_pairs == 0:
        return s[0]
    sp = s[1:1 + n_pairs]
    sn = s[1 + n_pairs:1 + 2 * n_pairs]
    votes = torch.where(sp > sn, 1.0, -1.0).sum(dim=0)
    return votes * 4.0 + s[0]


def _context_combine(s: torch.Tensor, n_pairs: int) -> torch.Tensor:
    """[2P, C] pair scores -> [C] context loss (<= 0, 0 = in-zone)."""
    sp, sn = s[:n_pairs], s[n_pairs:2 * n_pairs]
    return torch.clamp(sp - sn, max=0.0).sum(dim=0)


def _combined_scan(db: torch.Tensor, examples: torch.Tensor, combine,
                   db_scale=None, *, chunk: int = _CHUNK_ROWS) -> torch.Tensor:
    """[N] combined scores: ``combine([E, C] example dots) -> [C]`` over
    the whole db, one chunk of rows at a time. Examples are rounded to the
    db dtype (fp32 against an int8 db, whose chunks are dequantized with
    `db_scale`); each chunk's products are fp32."""
    n = db.shape[0]
    int8 = db.dtype == torch.int8
    ex = examples.to(db.device, torch.float32)
    if not int8:
        ex = ex.to(db.dtype).float()
    scale = (torch.as_tensor(db_scale, dtype=torch.float32, device=db.device)
             if int8 else None)
    out = torch.empty(n, device=db.device)
    for lo in range(0, n, chunk):
        block = db[lo:lo + chunk].float()
        if int8:
            block = block * scale
        out[lo:lo + len(block)] = combine(ex @ block.t())
    return out


def _finalize_topk(combined: torch.Tensor, k: int, n_valid, row_mask):
    """[N] combined scores -> ((1, k) f32 scores, (1, k) int32 idx) with
    the repo-wide (-score, idx) tie order and -1/-inf padding."""
    n = combined.shape[0]
    s = combined[None].clone()
    if n_valid is not None and n_valid < n:
        s[:, max(int(n_valid), 0):] = float("-inf")
    mask = as_row_mask(row_mask, n, combined.device)
    if mask is not None:
        s.masked_fill_(~mask.bool()[None], float("-inf"))
    return _finish(s, k)


def best_score_topk(db: torch.Tensor, examples: torch.Tensor, n_pos: int,
                    k: int, db_scale=None, n_valid=None, row_mask=None):
    """Exact best-score top-k over db [N, d].

    ``examples``: [E, d], positives in rows [:n_pos], negatives after.
    ``db_scale`` marks an int8 database (scanned in dequantizing chunks).
    Returns (scores [1, k] f32, idx [1, k] int32)."""
    combined = _combined_scan(db, examples, lambda s: _combine(s, n_pos), db_scale)
    return _finalize_topk(combined, k, n_valid, row_mask)


def discover_topk(db: torch.Tensor, examples: torch.Tensor, n_pairs: int,
                  k: int, db_scale=None, n_valid=None, row_mask=None):
    """qdrant-discovery top-k: ``examples`` rows are [target; pair
    positives (P); pair negatives (P)]. Rows rank by pair-vote total,
    target similarity breaking ties within a vote level; with ``n_pairs ==
    0`` a plain target search. Scores are the ``votes * 4 + sim`` keys."""
    combined = _combined_scan(db, examples,
                              lambda s: _discover_combine(s, n_pairs), db_scale)
    return _finalize_topk(combined, k, n_valid, row_mask)


def context_topk(db: torch.Tensor, examples: torch.Tensor, n_pairs: int,
                 k: int, db_scale=None, n_valid=None, row_mask=None):
    """qdrant context search: rows rank by ``sum_i min(0, s_pos_i -
    s_neg_i)``. ``examples``: [2P, d], positives first."""
    combined = _combined_scan(db, examples,
                              lambda s: _context_combine(s, n_pairs), db_scale)
    return _finalize_topk(combined, k, n_valid, row_mask)


def matrix_topk(vectors: torch.Tensor, limit: int, n_valid: Optional[int] = None):
    """Pairwise nearest neighbours WITHIN a sample: ``vectors`` [S, d] fp32
    (``n_valid`` marks the real prefix; pad rows are masked out of both
    axes). One [S, S] fp32 product, self-pairs masked. Returns (scores
    [S, limit] f32, cols [S, limit] int32): each row's most similar OTHER
    rows in (-score, idx) order, -1 in absent slots; ``cols`` index into
    the sample."""
    v = vectors.float()
    s = v.shape[0]
    n_valid = s if n_valid is None else int(n_valid)
    g = v @ v.t()
    col = torch.arange(s, device=v.device)
    g.fill_diagonal_(float("-inf"))
    g.masked_fill_((col >= n_valid)[None, :] | (col >= n_valid)[:, None], float("-inf"))
    return _finish(g, limit)


def _finalize_topk_host(combined: np.ndarray, k: int, row_mask):
    """Numpy twin of `_finalize_topk` (same contract, full lexsort)."""
    if row_mask is not None:
        combined = np.where(np.asarray(row_mask, bool), combined, -np.inf)
    order = np.lexsort((np.arange(len(combined)), -combined))[:k]
    scores = combined[order].astype(np.float32)
    idx = order.astype(np.int32)
    idx = np.where(np.isneginf(scores), -1, idx)
    pad = k - len(order)
    if pad > 0:
        scores = np.concatenate([scores, np.full(pad, -np.inf, np.float32)])
        idx = np.concatenate([idx, np.full(pad, -1, np.int32)])
    return scores[None], idx[None]


def best_score_topk_host(matrix: np.ndarray, positives, negatives,
                         k: int, row_mask=None):
    """Numpy best-score top-k for the host index (no accelerator).

    Same contract; f32 dots like the native scan."""
    ex = [np.asarray(positives, np.float32)]
    n_pos = len(ex[0])
    if negatives is not None and len(np.atleast_2d(negatives)):
        ex.append(np.atleast_2d(np.asarray(negatives, np.float32)))
    s = np.concatenate([np.atleast_2d(e) for e in ex]) @ matrix.T  # [E, N]
    bp = s[:n_pos].max(axis=0)
    if s.shape[0] > n_pos:
        bn = s[n_pos:].max(axis=0)
        combined = np.where(bp > bn, bp, -(bn * bn))
    else:
        combined = bp
    return _finalize_topk_host(combined, k, row_mask)


def discover_topk_host(matrix: np.ndarray, target, pairs_pos, pairs_neg,
                       k: int, row_mask=None):
    """Numpy discover top-k (votes * 4 + target sim; see discover_topk)."""
    t = np.asarray(target, np.float32).reshape(-1)
    sim = (matrix @ t).astype(np.float32)
    pos = np.atleast_2d(np.asarray(pairs_pos, np.float32)) if pairs_pos is not None else np.zeros((0, len(t)), np.float32)
    if len(pos):
        neg = np.atleast_2d(np.asarray(pairs_neg, np.float32))
        sp = pos @ matrix.T
        sn = neg @ matrix.T
        votes = np.where(sp > sn, np.float32(1), np.float32(-1)).sum(axis=0)
        combined = votes * 4.0 + sim
    else:
        combined = sim
    return _finalize_topk_host(combined, k, row_mask)


def context_topk_host(matrix: np.ndarray, pairs_pos, pairs_neg,
                      k: int, row_mask=None):
    """Numpy context top-k (sum of min(0, s_pos - s_neg) per pair)."""
    sp = np.atleast_2d(np.asarray(pairs_pos, np.float32)) @ matrix.T
    sn = np.atleast_2d(np.asarray(pairs_neg, np.float32)) @ matrix.T
    combined = np.minimum(sp - sn, 0.0).sum(axis=0)
    return _finalize_topk_host(combined, k, row_mask)


def _sharded_merge(fn, db, examples, k: int, mesh, axis: str, n_valid, row_mask):
    """`fn(shard, examples, n_valid_p, mask_p)` (one of the combined
    top-k searches) on each shard of `db` (a `Shards`, or the whole
    matrix, sharded over `axis` here), merged by (-score, global id) on
    the mesh's first device: the single-device result."""
    cands = shard_candidates(as_shards(db, mesh, axis), as_queries(examples), k, fn,
                             n_valid=n_valid, row_mask=row_mask)
    return merge_topk(cands, k, mesh.first)


def sharded_best_score_topk(db, examples, n_pos: int, k: int, mesh, axis: str = "data",
                            n_valid=None, db_scale=None, row_mask=None):
    """best_score_topk over a database row-sharded across `axis`."""
    return _sharded_merge(
        lambda dbs, ex, lv, ms: best_score_topk(dbs, ex, n_pos, k, db_scale=db_scale,
                                                n_valid=lv, row_mask=ms),
        db, examples, k, mesh, axis, n_valid, row_mask)


def sharded_discover_topk(db, examples, n_pairs: int, k: int, mesh, axis: str = "data",
                          n_valid=None, db_scale=None, row_mask=None):
    """discover_topk over a database row-sharded across `axis`."""
    return _sharded_merge(
        lambda dbs, ex, lv, ms: discover_topk(dbs, ex, n_pairs, k, db_scale=db_scale,
                                              n_valid=lv, row_mask=ms),
        db, examples, k, mesh, axis, n_valid, row_mask)


def sharded_context_topk(db, examples, n_pairs: int, k: int, mesh, axis: str = "data",
                         n_valid=None, db_scale=None, row_mask=None):
    """context_topk over a database row-sharded across `axis`."""
    return _sharded_merge(
        lambda dbs, ex, lv, ms: context_topk(dbs, ex, n_pairs, k, db_scale=db_scale,
                                             n_valid=lv, row_mask=ms),
        db, examples, k, mesh, axis, n_valid, row_mask)
