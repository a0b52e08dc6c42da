"""Product-quantized candidate scan (qdrant ProductQuantization role).

Product quantization splits every vector into m subvectors and replaces
each with the id of its nearest codebook centroid (256 per subspace, one
byte), then scans the code matrix for candidates that a full-precision
rescore reorders (the engine's rescore adapter). At m = d/8 a PQ row
costs the same d/8 bytes as a binary row, approximated by 256-entry
learned codebooks instead of 1-bit signs.

The JAX package left these ops to XLA, so here they are plain PyTorch on
the index's device:

  * `train_pq` draws its sample and initial centroids with the JAX
    package's numpy calls (`pq_sample`: the same rows, bit for bit), then
    runs one batched Lloyd iteration over all m subspaces at a time: a
    batched fp32 product and argmin (ties to the lower centroid), and the
    update as a one-hot product per slab of 1024 sample rows (a sum in a
    fixed order, so a run repeats itself bit for bit; a float
    `index_add_` on the card sums in no fixed order); empty clusters keep
    their centroid;
  * `pq_encode` assigns each subvector to its nearest centroid the same
    way, chunk by chunk;
  * `pq_topk` scores `bf16(q) . bf16(decode(codes))` with fp32 sums: each
    code chunk is decoded by a gather from the bf16 codebooks into a
    [C, d] bf16 block (the TPU's one-hot-through-MXU lookup reproduces
    the same bf16 centroid values), and one fp32 product of the
    bf16-exact values scores it; chunks merge into a running top-k.

Products run at full fp32 (the JAX package's Precision on the CPU; never
TF32). Result contract matches every other scan: (-score, idx) order,
ties to the lower row id, -1 in absent slots.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .topk import as_queries, as_shards, merge_topk, scan_topk, shard_candidates

_K = 256                      # centroids per subspace = one uint8 code
_CHUNK_ROWS = 65536           # code rows per scan step
_ASSIGN_BYTES = 1 << 28       # bound on the [m, C, 256] fp32 distances of a step


def _check_cb(codebooks) -> tuple:
    m, k, dsub = codebooks.shape
    if k != _K:
        raise ValueError(f"codebooks must have {_K} centroids per "
                         f"subspace, got {k}")
    return m, dsub


def pq_sample(vectors, m: int, *, sample: int = 65536, seed: int = 0):
    """The training sample [m, S, d/m] and the initial centroids
    [m, 256, d/m] (numpy fp32) that `train_pq` starts from: the JAX
    package's `np.random.default_rng(seed)` draws, in its order."""
    v = np.asarray(vectors, np.float32)
    n, d = v.shape
    if m <= 0 or d % m != 0:
        raise ValueError(f"pq m={m} must divide d={d}")
    if n == 0:
        raise ValueError("cannot train PQ codebooks on an empty matrix")
    dsub = d // m
    rng = np.random.default_rng(seed)
    s = min(n, max(int(sample), _K))
    slab = min(s, 1024)
    s = max(slab, (s // slab) * slab)
    rows = np.arange(n) if s == n else rng.choice(n, size=s, replace=False)
    data = v[np.sort(rows)].reshape(s, m, dsub).transpose(1, 0, 2)
    # init: one shared draw of sample rows (duplicate centroids from a
    # small corpus keep their init and simply go unused)
    init_rows = rng.choice(s, size=_K, replace=s < _K)
    return np.ascontiguousarray(data), np.ascontiguousarray(data[:, init_rows, :])


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """x [m, C, dsub], cent [m, 256, dsub] (fp32) -> [m, C] nearest
    centroid ids, ties to the lower id."""
    cn = (cent * cent).sum(-1)                                    # [m, K]
    return torch.argmin(cn[:, None, :] - 2.0 * torch.bmm(x, cent.transpose(1, 2)), dim=2)


def _kmeans_step(data: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration over all subspaces: data [m, S, dsub], cent
    [m, 256, dsub] -> new centroids; the sums are one-hot products per
    slab of 1024 rows, added in slab order."""
    mm, s, dsub = data.shape
    slab = min(s, 1024)
    sums = torch.zeros((mm, _K, dsub), device=data.device)
    counts = torch.zeros((mm, _K), device=data.device)
    for lo in range(0, s, slab):
        x = data[:, lo:lo + slab]
        oh = torch.nn.functional.one_hot(_assign(x, cent), _K).float()   # [m, slab, K]
        sums += torch.bmm(oh.transpose(1, 2), x)
        counts += oh.sum(dim=1)
    return torch.where(counts[..., None] > 0,
                       sums / torch.clamp(counts[..., None], min=1.0), cent)


def train_pq(vectors, m: int, *, iters: int = 25, sample: int = 65536,
             seed: int = 0, device=None) -> np.ndarray:
    """k-means codebooks [m, 256, d/m] fp32 (host) for a PQ index over
    `vectors` [n, d], trained on `device` from `pq_sample`'s sample and
    init for `iters` batched Lloyd iterations (at least one)."""
    from ..models.pe import resolve_device

    dev = resolve_device(device)
    data, init = pq_sample(vectors, m, sample=sample, seed=seed)
    data = torch.from_numpy(data).to(dev)
    cent = torch.from_numpy(init).to(dev)
    for _ in range(max(1, int(iters))):
        cent = _kmeans_step(data, cent)
    return cent.cpu().numpy()


def pq_encode(vectors, codebooks, *, device=None) -> np.ndarray:
    """[n, d] fp32 -> [n, m] uint8 codes (host) under `codebooks`
    [m, 256, d/m], computed on `device` chunk by chunk."""
    from ..models.pe import resolve_device

    cb_np = np.array(codebooks, np.float32)
    m, dsub = _check_cb(cb_np)
    v = np.asarray(vectors, np.float32)
    n, d = v.shape
    if d != m * dsub:
        raise ValueError(f"d={d} does not match codebooks ({m}x{dsub})")
    out = np.empty((n, m), np.uint8)
    if n == 0:
        return out
    dev = resolve_device(device)
    cb = torch.from_numpy(cb_np).to(dev)
    chunk = max(128, _ASSIGN_BYTES // (m * _K * 4))
    for lo in range(0, n, chunk):
        x = torch.from_numpy(np.array(v[lo:lo + chunk])).to(dev)
        x = x.reshape(len(x), m, dsub).transpose(0, 1)             # [m, C, dsub]
        out[lo:lo + x.shape[1]] = _assign(x, cb).t().to(torch.uint8).cpu().numpy()
    return out


def pq_decode(codes, codebooks) -> np.ndarray:
    """[n, m] uint8 codes -> [n, d] f32 reconstruction (host numpy —
    the fp64-reference half of the parity tests and the centroid side
    of recall analyses)."""
    cb = np.asarray(codebooks, np.float32)
    m, dsub = _check_cb(cb)
    c = np.asarray(codes)
    return cb[np.arange(m)[None, :], c.astype(np.int64)] \
        .reshape(len(c), m * dsub)


def pq_topk(codes: torch.Tensor, codebooks: torch.Tensor, queries: torch.Tensor,
            k: int, n_valid: Optional[int] = None, row_mask=None, *,
            chunk: int = _CHUNK_ROWS):
    """Candidate top-k over a PQ code matrix.

    codes: [N, m] uint8; codebooks: [m, 256, d/m] (any float dtype, used
    in bf16); queries: [Q, d] full precision. Returns (scores [Q, k] f32,
    idx [Q, k] int32) under the asymmetric proxy `bf16(q) .
    bf16(decode(codes))` with fp32 sums. `row_mask` ([N] bool) excludes
    rows exactly; `n_valid` masks trailing rows."""
    n, m = codes.shape
    cb16 = codebooks.to(codes.device, torch.bfloat16)
    d = m * cb16.shape[2]
    qb = queries.to(codes.device).to(torch.bfloat16).float()
    sub = torch.arange(m, device=codes.device)

    def scores(lo, hi):
        xhat = cb16[sub[None, :], codes[lo:hi].long()].reshape(hi - lo, d)   # [C, d] bf16
        return qb @ xhat.float().t()

    return scan_topk(scores, n, qb.shape[0], k, codes.device, n_valid=n_valid,
                     row_mask=row_mask, chunk=chunk)


def sharded_pq_topk(codes, codebooks, queries, k: int, d: int, mesh, axis: str = "data",
                    n_valid=None, row_mask=None):
    """PQ candidate top-k over a code matrix row-sharded across `axis` (a
    `Shards`, or the whole [N, m] codes, sharded here), the codebooks
    copied once to each shard's device: `pq_topk` on each shard with its
    own valid count, then one (-score, global id) merge on the mesh's
    first device; the single-device scan's result. `d` (the JAX
    package's argument) follows from the codebooks."""
    del d
    cbs = {}

    def scan(part, q, lv, m):
        if part.device not in cbs:
            cbs[part.device] = torch.as_tensor(codebooks).to(part.device)
        return pq_topk(part, cbs[part.device], q, k, n_valid=lv, row_mask=m)

    cands = shard_candidates(as_shards(codes, mesh, axis), as_queries(queries), k, scan,
                             n_valid=n_valid, row_mask=row_mask)
    return merge_topk(cands, k, mesh.first)
