"""A plain exact cosine scan, in fp32 over bf16-rounded rows and queries
(the store's bfloat16), judging a program's top-k answers."""
from __future__ import annotations

import numpy as np
import torch


def gaps(row_chunks, n: int, queries: np.ndarray, scores: np.ndarray, ids: np.ndarray,
         k: int, device) -> tuple:
    """(score_gap, rank_gap) of the program's answers `scores`, `ids`
    [Q, k] to `queries` [Q, d] over the rows that `row_chunks` yields as
    (lo, fp32 [m, d]). score_gap: max |returned score - the reference's
    score of that row|; rank_gap: max over returned rows of (the
    reference's k-th best score - its score of the row), at least 0;
    both infinite where a row is out of range or returned twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device).bfloat16().float()
    got = torch.from_numpy(np.asarray(ids, np.int64)).to(device)
    nq = q.shape[0]
    best = torch.full((nq, k), float("-inf"), device=device)
    theirs = torch.full((nq, k), float("nan"), device=device)
    for lo, x in row_chunks:
        s = q @ x.bfloat16().float().t()
        best = torch.cat([best, s.topk(min(k, s.shape[1]), dim=1).values], 1).topk(k, dim=1).values
        inside = (got >= lo) & (got < lo + len(x))
        picked = s.gather(1, (got - lo).clamp(0, len(x) - 1))
        theirs = torch.where(inside, picked, theirs)
    theirs, best = theirs.double().cpu().numpy(), best.double().cpu().numpy()
    dup = np.array([len(set(row)) < len(row) for row in np.asarray(ids)])
    bad = np.isnan(theirs).any(axis=1) | dup | (np.asarray(ids) >= n).any(axis=1)
    if bad.any():
        return float("inf"), float("inf")
    score_gap = float(np.max(np.abs(np.asarray(scores, np.float64) - theirs)))
    rank_gap = float(max(0.0, np.max(best[:, -1:] - theirs)))
    return score_gap, rank_gap
