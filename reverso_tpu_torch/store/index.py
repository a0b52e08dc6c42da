"""Indexes over a store's embedding matrix.

On the device (CUDA unless the caller passes `device="cpu"`): the exact
index (`DeviceIndex`: bf16, fp32 or int8 rows; cosine and dot on the top-k
kernel, euclid on the same kernel through the `[x, ||x||^2]`
augmentation, manhattan on the chunked L1 scan; the example-combine
searches best_score / discover / context), the sign-packed binary and the
product-quantized candidate indexes (`BinaryIndex`, `PQIndex`, rescored by
the engine), and the MaxSim index of a multivector space
(`MultiVecIndex`). On the host: `HostIndex`, the native C++ scan
(`native.py`), which returns numpy arrays.

With a `mesh=` of more than one device (`parallel/sharding.py`), the
device indexes row-shard their matrix over the mesh's `axis` in
contiguous ranges (MaxSim keeps each point whole in one shard), each
shard on its device, and every search runs each shard's scan there
(the same kernels) and merges the shards' candidates by (-score, global
id) on the mesh's first device: the single-device result. A mesh of
one device takes the single-device route on that device."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..native import cpu_topk
from ..ops.binary import binary_topk, pack_signs, sharded_binary_topk
from ..ops.l1 import manhattan_topk, manhattan_topk_host, sharded_manhattan_topk
from ..ops.multivec import (maxsim_topk, seg_ids_of, shard_multivec_layout,
                            sharded_maxsim_topk)
from ..ops.pq import pq_encode, pq_topk, sharded_pq_topk, train_pq
from ..ops.recommend import (best_score_topk, best_score_topk_host, context_topk,
                             context_topk_host, discover_topk, discover_topk_host,
                             sharded_best_score_topk, sharded_context_topk,
                             sharded_discover_topk)
from ..ops.topk import as_row_mask, dot_topk, int8_clip_bound, sharded_cosine_topk
from ..parallel.sharding import Shards, empty_shards, shard_rows
from ..utils.profiling import span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
_CHUNK = 65536   # host rows per upload step


@dataclass
class SearchResult:
    """Device search output joined with host payloads."""
    scores: np.ndarray          # [Q, k] f32
    indices: np.ndarray         # [Q, k] int32, -1 = below threshold / absent
    payloads: list              # [Q][k] payload dict or None


def host_chunks(vectors: np.ndarray, device):
    """(lo, fp32 rows [lo:lo + _CHUNK] on `device`) for the rows of a host
    matrix (a read-only store map is fine: each chunk is copied)."""
    for lo in range(0, len(vectors), _CHUNK):
        yield lo, torch.from_numpy(np.array(vectors[lo:lo + _CHUNK], np.float32)).to(device)


def to_host(x) -> np.ndarray:
    """A search result array (device tensor or host array) -> numpy."""
    with span("index.to_host", waits=True):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _empty(qn: int, k: int, device):
    return (torch.full((qn, k), float("-inf"), device=device),
            torch.full((qn, k), -1, dtype=torch.int32, device=device))


def placement(mesh, device):
    """(mesh or None, device) of an index: a mesh of more than one device
    shards it, with results on the mesh's first device; a mesh of one
    device places it on that device (the JAX package's `mesh.devices.size
    > 1` rule); no mesh, on `device` (default CUDA)."""
    from ..models.pe import resolve_device

    if mesh is None:
        return None, resolve_device(device)
    return (mesh if mesh.size > 1 else None), mesh.first


def zero_rows(n: int, width: int, dtype, device, mesh=None, axis: str = "data"):
    """Zeroed [n, width] rows on `device`, or row-sharded over the mesh."""
    if mesh is not None:
        return empty_shards(n, width, dtype, mesh, axis)
    return torch.zeros((n, width), dtype=dtype, device=device)


def write_rows(dst, lo: int, x: torch.Tensor) -> None:
    """dst[lo:lo + len(x), :x.shape[1]] = x for a tensor or `Shards` (each
    shard takes the part of x in its range, copied to its device)."""
    if not isinstance(dst, Shards):
        dst[lo:lo + len(x), :x.shape[1]] = x
        return
    for part, start in zip(dst.parts, dst.starts):
        a, b = max(lo, start), min(lo + len(x), start + len(part))
        if a < b:
            part[a - start:b - start, :x.shape[1]] = x[a - lo:b - lo].to(part.device)


def nbytes_of(matrix) -> int:
    return matrix.nbytes if isinstance(matrix, Shards) else matrix.numel() * matrix.element_size()


def _queries(queries, device) -> torch.Tensor:
    """[Q, d] or [d] host array or tensor -> [Q, d] fp32 on `device`."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.array(queries, np.float32))
    q = queries.to(device, torch.float32)
    return q[None, :] if q.ndim == 1 else q


class HostIndex:
    """Exact top-k on the HOST through the native C++ scan
    (native/reverso_native.cpp via `native.cpu_topk`; numpy without a
    compiler), for deployments without a card: `SearchConfig.index =
    "host"`. Cosine and dot scan the rows as stored, euclid the same
    `[x, ||x||^2]` augmentation as DeviceIndex (f32, exact ranking), and
    manhattan the chunked numpy L1 (`manhattan_topk_host`). Same
    (-score, idx) result contract as DeviceIndex.search, in numpy
    arrays."""

    def __init__(self, vectors: np.ndarray, *, distance: str = "cosine"):
        self.distance = distance
        if distance == "manhattan":
            # no dot factorization exists for L1 — plain f32 rows,
            # scanned by the chunked numpy L1 (ops/l1.py)
            self.matrix = np.ascontiguousarray(vectors, np.float32)
            self.n_valid = len(vectors)
            self.dim = self.matrix.shape[1] if self.matrix.ndim == 2 else 0
            return
        if distance == "euclid":
            # same [x, ||x||^2] augmentation as DeviceIndex — the
            # native dot scan then ranks by -distance exactly (f32)
            v = np.asarray(vectors, np.float32)
            vectors = np.concatenate(
                [v, (v * v).sum(axis=1, keepdims=True)], axis=1)
        self.matrix = np.ascontiguousarray(vectors, np.float32)
        self.n_valid = len(vectors)
        self.dim = self.matrix.shape[1] if self.matrix.ndim == 2 else 0

    def search(self, queries, k: int, *, row_mask=None, **_):
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if self.distance == "manhattan":
            return manhattan_topk_host(self.matrix, q, k,
                                       row_mask=row_mask)
        if self.distance != "euclid":
            return self._search_dot(q, k, row_mask=row_mask)
        qa = np.concatenate(
            [2.0 * q, -np.ones((len(q), 1), np.float32)], axis=1)
        s, i = self._search_dot(qa, k, row_mask=row_mask)
        dist2 = np.maximum((q * q).sum(axis=1, keepdims=True) - s, 0.0)
        return (np.where(i >= 0, -np.sqrt(dist2), -np.inf)
                .astype(np.float32), i)

    def _search_dot(self, q, k: int, *, row_mask=None):
        matrix, remap = self.matrix, None
        if row_mask is not None:
            # subset scan: row order is preserved, so the native scan's
            # (-score, idx) tie order maps back through `remap` unchanged
            remap = np.nonzero(np.asarray(row_mask, bool)[:self.n_valid])[0]
            matrix = np.ascontiguousarray(self.matrix[remap])
        if len(matrix) == 0:
            return (np.full((q.shape[0], k), -np.inf, np.float32),
                    np.full((q.shape[0], k), -1, np.int32))
        scores, idx = cpu_topk(matrix, q, k)
        idx = idx.astype(np.int32)
        if remap is not None:
            idx = np.where(idx >= 0, remap.astype(np.int32)[np.clip(idx, 0, None)], -1)
        return scores, idx

    def _no_euclid(self):
        if self.distance in ("euclid", "manhattan"):
            raise ValueError(
                "best_score/discover/context need a cosine or dot "
                f"index (this store's distance is {self.distance})")

    def best_score(self, positives, negatives=None, k: int = 10, *,
                   row_mask=None):
        """qdrant best_score recommend combine over the host matrix."""
        self._no_euclid()
        if row_mask is not None:
            row_mask = np.asarray(row_mask, bool)[:self.n_valid]
        return best_score_topk_host(self.matrix, positives, negatives, k,
                                    row_mask=row_mask)

    def discover(self, target, pairs_pos=None, pairs_neg=None,
                 k: int = 10, *, row_mask=None):
        """qdrant discovery search over the host matrix."""
        self._no_euclid()
        if row_mask is not None:
            row_mask = np.asarray(row_mask, bool)[:self.n_valid]
        return discover_topk_host(self.matrix, target, pairs_pos, pairs_neg,
                                  k, row_mask=row_mask)

    def context(self, pairs_pos, pairs_neg, k: int = 10, *, row_mask=None):
        """qdrant context search over the host matrix."""
        self._no_euclid()
        if row_mask is not None:
            row_mask = np.asarray(row_mask, bool)[:self.n_valid]
        return context_topk_host(self.matrix, pairs_pos, pairs_neg, k,
                                 row_mask=row_mask)


class MultiVecIndex:
    """Device-resident MaxSim index over one MULTIVECTOR space (qdrant
    multivectors: each point holds a ragged [T, d] matrix of sub-vectors;
    `ops/multivec.py` has the scoring model).

    The flat sub-vector matrix lives on the device (bf16 by default; int8
    would make MaxSim inexact and is stored as bf16), the raggedness as a
    device-resident segment-id vector. `search` takes [d] / [Tq, d]
    queries or lists of them and chunks the query batch so the [Q·Tq, M]
    score block stays under `_BLOCK_BYTES`; it returns host arrays, as
    the JAX package's does. With a multi-device `mesh`, points shard in
    contiguous ranges over `axis`, each kept whole
    (`ops.multivec.shard_multivec_layout`), and every search runs the
    per-shard scan + merge (`sharded_maxsim_topk`)."""

    # bound on the [Q·Tq, M] f32 intermediate per launch
    _BLOCK_BYTES = 512 * 1024 * 1024

    def __init__(self, sub_vectors: np.ndarray, indptr: np.ndarray, *,
                 dtype: str = "bfloat16", mesh=None, axis: str = "data", device=None):
        subs = np.asarray(sub_vectors, np.float32)
        self.indptr = np.asarray(indptr, np.int64)
        self.n_valid = len(self.indptr)
        self.dim = subs.shape[1] if subs.ndim == 2 and subs.size else 0
        self.mesh, self.device = placement(mesh, device)
        if not len(subs):
            self.mesh = None
        self.axis = axis
        self._dtype = torch.bfloat16 if dtype == "int8" else _DTYPES[dtype]
        if self.mesh is not None:
            devs = self.mesh.shard_devices((axis,))
            self._layout = shard_multivec_layout(self.indptr, len(devs))
            self.matrix = [torch.from_numpy(subs[a:b]).to(dev, self._dtype)
                           for (_, _, a, b, _), dev in zip(self._layout, devs)]
            self._seg_ids = [torch.from_numpy(seg_ids_of(ptr)).to(dev)
                             for (*_, ptr), dev in zip(self._layout, devs)]
            return
        self.matrix = torch.zeros((len(subs), max(self.dim, 1)), dtype=self._dtype,
                                  device=self.device)
        for lo, x in host_chunks(subs, self.device):
            self.matrix[lo:lo + len(x)] = x.to(self._dtype)
        # device-resident segment ids, built once (not per search)
        self._seg_ids = (torch.from_numpy(seg_ids_of(self.indptr)).to(self.device)
                         if len(subs) else None)

    @property
    def nbytes(self) -> int:
        parts = self.matrix if self.mesh is not None else [self.matrix]
        return sum(nbytes_of(t) for t in parts)

    def search(self, queries, k: int, *, row_mask=None, **_):
        if isinstance(queries, (list, tuple)):
            qlist = list(queries)
        else:
            q = np.asarray(queries, np.float32)
            qlist = [q] if q.ndim <= 2 else list(q)
        if not qlist:
            return (np.zeros((0, k), np.float32),
                    np.zeros((0, k), np.int32))
        tq = max(1 if np.asarray(a).ndim == 1 else len(np.asarray(a))
                 for a in qlist)
        if self.mesh is not None:
            m = max(max(len(t) for t in self.matrix), 1)
            per_q = max(1, self._BLOCK_BYTES // (4 * tq * m))
            outs = [sharded_maxsim_topk(self.matrix, self._layout, qlist[lo:lo + per_q], k,
                                        self.mesh, row_mask=row_mask, seg_ids=self._seg_ids)
                    for lo in range(0, len(qlist), per_q)]
            return (np.concatenate([s.cpu().numpy() for s, _ in outs]),
                    np.concatenate([i.cpu().numpy() for _, i in outs]))
        m = max(len(self.matrix), 1)
        per_q = max(1, self._BLOCK_BYTES // (4 * tq * m))
        outs = [maxsim_topk(self.matrix, self.indptr, qlist[lo:lo + per_q], k,
                            row_mask=row_mask, seg_ids=self._seg_ids)
                for lo in range(0, len(qlist), per_q)]
        return (np.concatenate([s.cpu().numpy() for s, _ in outs]),
                np.concatenate([i.cpu().numpy() for _, i in outs]))


class DeviceIndex:
    """Immutable snapshot of an embedding matrix, resident on one device.

    Exact top-k under the store's distance. "cosine" and "dot" are a dot
    over the rows as stored (cosine stores hold unit rows). "euclid" rides
    the same kernel through an augmentation: the matrix holds
    `[x, ||x||^2]` (`dim` = d + 1 columns), and queries are searched as
    `[2q, -1]`, whose ranking key
    `2<q, x> - ||x||^2` is monotone in -||q - x||^2; the k hits map back
    to `-sqrt(max(||q||^2 - key, 0))`. "manhattan" scans the rows with
    the chunked L1 (`ops/l1.py`); scores are exact -L1 distances. `dtype`
    "bfloat16"/"float32" stores the rows as they are (queries cast to the
    matrix dtype); "int8" stores them globally-symmetric quantized with
    the scale from the real rows (`int8_quantile` 0 = abs-max, else that
    abs-value quantile: outliers clip), and searches are exact with
    respect to the stored int8 rows. Euclid and manhattan store int8 as
    bf16 (a global scale would be dominated by the norm column, or make
    the rows another L1 space). `n_valid` is the number of real rows:
    slots beyond them come back as (score -inf, idx -1). Every row is
    zero-padded past `dim` to a multiple of 16 bytes (1032 bf16 or 1028
    fp32 columns for euclid at d = 1024), and queries with it: a row of
    another pitch is no TMA pitch, and the kernel's producer copies such
    rows at a twentieth of the rate (PERF.md section 6); zero columns add
    nothing to a dot or an L1 sum. The kernels take any row count, so the
    row count is not padded. Rebuild (one host->device copy) after
    appending to the backing store. With a multi-device `mesh` the rows
    shard over `axis` (`placement`; a `Shards` in `matrix`) and every
    search is the sharded scan + merge on the mesh's first device.
    """

    def __init__(self, vectors: np.ndarray, *, mesh=None, axis: str = "data",
                 dtype: str = "bfloat16", distance: str = "cosine",
                 device=None, int8_quantile: float = 0.0):
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype={dtype!r}: the exact index holds bfloat16, float32 or "
                f"int8 rows")
        if distance in ("euclid", "manhattan") and dtype == "int8":
            dtype = "bfloat16"
        vectors = np.asarray(vectors)
        n, d = vectors.shape
        euclid = distance == "euclid"
        self.distance = distance
        self.n_valid = n
        self._cols = d
        self.dim = d + 1 if euclid else d
        self.mesh, self.device = placement(mesh, device)
        self.axis = axis
        self._dtype = _DTYPES[dtype]
        self.scale = None
        per = 16 // self._dtype.itemsize
        self._width = -(-self.dim // per) * per
        self.matrix = zero_rows(n, self._width, self._dtype, self.device, self.mesh, axis)
        if self._dtype == torch.int8:
            # round(x * (127 / amax)) in fp32 (the JAX package's host math)
            amax = int8_clip_bound(vectors[:max(n, 1)], int8_quantile)
            self.scale = float(amax / np.float32(127.0))
            inv = torch.tensor(np.float32(127.0) / amax, device=self.device)
        for lo, x in host_chunks(vectors, self.device):
            if euclid:
                x = torch.cat([x, (x * x).sum(dim=1, keepdim=True)], dim=1)
            write_rows(self.matrix, lo,
                       torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
                       if self._dtype == torch.int8 else x.to(self._dtype))

    @property
    def nbytes(self) -> int:
        return nbytes_of(self.matrix)

    def search(self, queries, k: int, *, row_mask=None, **_):
        """Exact top-k under the index distance. queries: [Q, d] or [d]
        (host array or tensor). `row_mask` ([n_valid] bool, host or device)
        restricts the scan to the matching rows (payload filters, deleted
        vectors): exact over the subset, same (-score, idx) order.

        Returns device tensors (scores [Q, k] f32, idx [Q, k] int32) in
        (-score, idx) order; idx -1 marks slots beyond the scoring rows.
        int8 searches above the kernel's k cap or past d = 1040 take the
        chunked plain scan (a counted shape rule on the card)."""
        with span("index.search"):
            with span("index.search.queries"):
                q = _queries(queries, self.device)
            if self.n_valid == 0:
                return _empty(q.shape[0], k, self.device)
            with span("index.search.mask"):
                mask = as_row_mask(row_mask, self.n_valid, self.device)
            with span("index.search.pad"):
                if self.distance == "euclid":
                    qa = self._widen(2.0 * q)
                    qa[:, q.shape[1]] = -1.0
                else:
                    qa = self._widen(q)
            with span("index.search.scan"):
                if self.distance == "manhattan":
                    if self.mesh is not None:
                        return sharded_manhattan_topk(self.matrix, qa, k, self.mesh,
                                                      n_valid=self.n_valid, row_mask=mask)
                    return manhattan_topk(self.matrix, qa, k, n_valid=self.n_valid,
                                          row_mask=mask)
                s, i = self._search_dot(qa, k, mask)
            if self.distance != "euclid":
                return s, i
            dist2 = torch.clamp((q * q).sum(dim=1, keepdim=True) - s, min=0.0)
            return torch.where(i >= 0, -torch.sqrt(dist2), float("-inf")), i

    def _widen(self, q: torch.Tensor) -> torch.Tensor:
        """[Q, d] vectors (queries, examples) -> [Q, the matrix's width],
        zero past d."""
        if q.ndim != 2 or q.shape[1] != self._cols:
            raise ValueError(f"vectors {tuple(q.shape)} do not match the index's "
                             f"d = {self._cols}")
        return torch.nn.functional.pad(q, (0, self._width - q.shape[1]))

    def _search_dot(self, q: torch.Tensor, k: int, mask):
        if self.mesh is not None:
            return sharded_cosine_topk(self.matrix, q, k, self.mesh, self.axis,
                                       n_valid=self.n_valid, db_scale=self.scale,
                                       row_mask=mask)
        return dot_topk(self.matrix, q, k, n_valid=self.n_valid, row_mask=mask,
                        db_scale=self.scale)

    def _combined_search(self, parts, n_static: int, k: int, row_mask, fn, sharded_fn):
        """Shared launch path of the example-combine searches (best_score /
        discover / context): stack the example rows on the device, apply
        the row mask, run `fn(matrix, examples, n_static, k, ...)`, or
        `sharded_fn` over the shards on a mesh."""
        if self.distance in ("euclid", "manhattan"):
            # euclid's matrix is the [x, ||x||^2] augmentation (example
            # rows are plain [d] vectors), and the combine formulas are
            # defined on similarity scores, not distances
            raise ValueError(
                "best_score/discover/context need a cosine or dot "
                f"index (this store's distance is {self.distance})")
        ex = self._widen(torch.from_numpy(np.concatenate(parts)).to(self.device))
        if self.n_valid == 0:
            return _empty(1, k, self.device)
        mask = as_row_mask(row_mask, self.n_valid, self.device)
        if self.mesh is not None:
            return sharded_fn(self.matrix, ex, n_static, k, self.mesh, self.axis,
                              n_valid=self.n_valid, db_scale=self.scale, row_mask=mask)
        return fn(self.matrix, ex, n_static, k, db_scale=self.scale, n_valid=self.n_valid,
                  row_mask=mask)

    def best_score(self, positives, negatives=None, k: int = 10, *,
                   row_mask=None):
        """qdrant best_score recommend: rank rows by their best positive
        example score unless some negative example scores higher, in
        which case they sink to -(best_neg^2). Exact over the whole
        matrix (int8 dequantizes chunk by chunk); same (-score, idx)
        contract as `search`, scores and ids [1, k]. `row_mask` filters
        rows like `search`."""
        pos = np.atleast_2d(np.asarray(positives, np.float32))
        n_pos = len(pos)
        if n_pos == 0:
            raise ValueError("best_score needs at least one positive example")
        parts = [pos]
        if negatives is not None:
            neg = np.atleast_2d(np.asarray(negatives, np.float32))
            if len(neg):
                parts.append(neg)
        return self._combined_search(parts, n_pos, k, row_mask, best_score_topk,
                                     sharded_best_score_topk)

    def discover(self, target, pairs_pos=None, pairs_neg=None,
                 k: int = 10, *, row_mask=None):
        """qdrant discovery search: rank by context-pair votes, target
        similarity breaking ties (ops.recommend.discover_topk). With no
        pairs this degrades to a plain target search. Same contracts as
        `best_score`."""
        t = np.asarray(target, np.float32).reshape(1, -1)
        pos = (np.atleast_2d(np.asarray(pairs_pos, np.float32))
               if pairs_pos is not None else np.zeros((0, t.shape[1]), np.float32))
        neg = (np.atleast_2d(np.asarray(pairs_neg, np.float32))
               if pairs_neg is not None else np.zeros((0, t.shape[1]), np.float32))
        if len(pos) != len(neg):
            raise ValueError(
                f"discover pairs must match: {len(pos)} positives vs "
                f"{len(neg)} negatives")
        return self._combined_search([t, pos, neg], len(pos), k, row_mask, discover_topk,
                                     sharded_discover_topk)

    def context(self, pairs_pos, pairs_neg, k: int = 10, *, row_mask=None):
        """qdrant context search: rank by sum of min(0, s_pos - s_neg)
        over the pairs (ops.recommend.context_topk)."""
        pos = np.atleast_2d(np.asarray(pairs_pos, np.float32))
        neg = np.atleast_2d(np.asarray(pairs_neg, np.float32))
        if len(pos) != len(neg) or len(pos) == 0:
            raise ValueError(
                f"context needs matching non-empty pairs: {len(pos)} "
                f"positives vs {len(neg)} negatives")
        return self._combined_search([pos, neg], len(pos), k, row_mask, context_topk,
                                     sharded_context_topk)


class BinaryIndex:
    """Sign-packed candidate index: the device half of qdrant's binary
    quantization (1 bit per dimension, 16x the bf16 capacity).

    `search` returns CANDIDATES under the binary proxy score
    `sum q_i * sign(x_i - mean_i)`; callers that need true scores rescore
    the top oversampling*k ids against the full-precision rows (the
    engine's rescore adapter does). Bits are packed against the per-dim
    mean (`center`, a float64 mean cast to fp32, as the JAX package
    computes it), not zero: q.x = q.mean + q.(x - mean), and the first term
    is constant per query. Planes are ceil(d/8) bytes wide (the JAX
    package rounds them up to 128-byte lane tiles; at d = 1024 the bytes
    are identical). A multi-device `mesh` shards the packed rows over
    `axis` (`sharded_binary_topk`)."""

    def __init__(self, vectors: np.ndarray, *, mesh=None, axis: str = "data", device=None):
        v = np.asarray(vectors)
        self.n_valid = len(v)
        self.dim = v.shape[1] if v.ndim == 2 and v.size else 0
        self.mesh, self.device = placement(mesh, device)
        self.axis = axis
        self.center = (v.mean(axis=0, dtype=np.float64).astype(np.float32)
                       if self.n_valid else np.zeros((max(self.dim, 1),), np.float32))
        w = max((self.dim + 7) // 8, 1)
        self.matrix = zero_rows(self.n_valid, w, torch.uint8, self.device, self.mesh, axis)
        center = torch.from_numpy(self.center).to(self.device)
        for lo, x in host_chunks(v, self.device):
            write_rows(self.matrix, lo, pack_signs(x - center, plane_width=w))

    @property
    def nbytes(self) -> int:
        return nbytes_of(self.matrix)

    @classmethod
    def from_chunks(cls, chunk_fn, n: int, d: int, *, mesh=None, axis: str = "data",
                    chunk: int = 1 << 19, center=None, device=None) -> "BinaryIndex":
        """Build from a corpus that never exists as one array:
        `chunk_fn(lo, rows)` returns a [rows, d] float block on the
        index's device (a seeded generator, a staged disk read). Two
        passes: the per-dimension mean (fp32 sums a chunk, accumulated in
        float64; skipped when `center` is given), then each chunk centered,
        sign-packed and written into its rows of the uint8 matrix (or of
        its shards); each block is dropped before the next is made. The
        bits equal the host constructor's at the same center."""
        self = cls.__new__(cls)
        self.n_valid, self.dim = int(n), int(d)
        self.mesh, self.device = placement(mesh, device)
        self.axis = axis
        if center is None:
            sums = np.zeros(d, np.float64)
            for lo in range(0, n, chunk):
                sums += chunk_fn(lo, min(chunk, n - lo)).float().sum(dim=0).double().cpu().numpy()
            center = (sums / max(n, 1)).astype(np.float32)
        self.center = np.asarray(center, np.float32)
        w = max((d + 7) // 8, 1)
        self.matrix = zero_rows(n, w, torch.uint8, self.device, self.mesh, axis)
        cdev = torch.from_numpy(self.center).to(self.device)
        for lo in range(0, n, chunk):
            x = chunk_fn(lo, min(chunk, n - lo)).to(self.device)
            write_rows(self.matrix, lo, pack_signs(x.float() - cdev, plane_width=w))
            del x
        return self

    def search(self, queries, k: int, *, row_mask=None, **_):
        """Candidate top-k under the binary proxy score; device tensors
        (scores [Q, k] f32, idx [Q, k] int32) in (-score, idx) order."""
        q = _queries(queries, self.device)
        if self.n_valid == 0:
            return _empty(q.shape[0], k, self.device)
        mask = as_row_mask(row_mask, self.n_valid, self.device)
        if self.mesh is not None:
            return sharded_binary_topk(self.matrix, q, k, self.dim, self.mesh, self.axis,
                                       n_valid=self.n_valid, row_mask=mask)
        return binary_topk(self.matrix, q, k, self.dim, n_valid=self.n_valid, row_mask=mask)


class PQIndex:
    """Product-quantized candidate index, the device half of qdrant's
    ProductQuantization (m bytes per row on the device; `ops/pq.py`).

    `search` returns CANDIDATES under the PQ proxy score `bf16(q) .
    bf16(decode(codes))`; callers that need true scores rescore the top
    oversampling*k ids against the full-precision rows (the engine's
    rescore adapter does). Default m = d/8: the same d/8 bytes per row as
    BinaryIndex. Pass cached `codebooks`/`codes` (`save_cache`/
    `load_cache`, the JAX package's `.npz` keys, so caches are shared) to
    skip training; codes covering only a prefix of the rows extend by
    encoding the tail against the cached codebooks."""

    def __init__(self, vectors: np.ndarray, *, m: int = 0, mesh=None, axis: str = "data",
                 iters: int = 25, sample: int = 65536, seed: int = 0,
                 codebooks=None, codes=None, device=None):
        v = np.asarray(vectors, np.float32)
        self.n_valid = len(v)
        self.dim = v.shape[1] if v.ndim == 2 and v.size else 0
        self.mesh, self.device = placement(mesh, device)
        self.axis = axis
        if m <= 0:
            m = default_pq_m(self.dim)
        if self.dim and self.dim % m != 0:
            raise ValueError(f"pq m={m} must divide d={self.dim}")
        self.m = int(m)
        dsub = max(self.dim // self.m, 1) if self.dim else 1
        if self.n_valid == 0:
            self.codebooks = np.zeros((self.m, 256, dsub), np.float32)
            host_codes = np.zeros((0, self.m), np.uint8)
        else:
            self.codebooks = (np.array(codebooks, np.float32)
                              if codebooks is not None else
                              train_pq(v, self.m, iters=iters, sample=sample,
                                       seed=seed, device=self.device))
            if self.codebooks.shape != (self.m, 256, dsub):
                raise ValueError(
                    f"codebooks shape {self.codebooks.shape} does not "
                    f"match (m={self.m}, 256, dsub={dsub})")
            done = 0
            if codes is not None:
                codes = np.asarray(codes, np.uint8)
                if codes.ndim != 2 or codes.shape[1] != self.m \
                        or len(codes) > self.n_valid:
                    raise ValueError(
                        f"cached codes {codes.shape} do not cover a "
                        f"prefix of [{self.n_valid}, {self.m}]")
                done = len(codes)
            tail = pq_encode(v[done:], self.codebooks, device=self.device)
            host_codes = np.concatenate([codes, tail]) if done else tail
        self._host_codes = host_codes
        self.matrix = (shard_rows(host_codes, self.mesh, axis) if self.mesh is not None
                       else torch.from_numpy(host_codes).to(self.device))
        self._cb_dev = torch.from_numpy(self.codebooks).to(self.device)

    @property
    def nbytes(self) -> int:
        return nbytes_of(self.matrix) + nbytes_of(self._cb_dev)

    def save_cache(self, path: str) -> None:
        """Persist codebooks + codes (the slow-to-recompute halves)."""
        np.savez(path, codebooks=self.codebooks,
                 codes=self._host_codes, m=self.m, n=self.n_valid)

    @classmethod
    def load_cache(cls, vectors: np.ndarray, path: str, *,
                   m: int = 0, mesh=None, axis: str = "data", device=None):
        """Rebuild from a save_cache file (either package's); codes
        covering a PREFIX of `vectors` extend by encoding the tail
        (appends never retrain). Returns None when the cache does not fit
        (caller retrains)."""
        try:
            with np.load(path) as z:
                cb, codes = z["codebooks"], z["codes"]
        except (OSError, KeyError, ValueError):
            return None
        if m > 0 and cb.shape[0] != m:
            return None
        if len(codes) > len(vectors):
            return None
        try:
            return cls(vectors, m=cb.shape[0], mesh=mesh, axis=axis, codebooks=cb,
                       codes=codes, device=device)
        except ValueError:
            return None

    def search(self, queries, k: int, *, row_mask=None, **_):
        """Candidate top-k under the PQ proxy score; device tensors
        (scores [Q, k] f32, idx [Q, k] int32) in (-score, idx) order."""
        q = _queries(queries, self.device)
        if self.n_valid == 0:
            return _empty(q.shape[0], k, self.device)
        if self.mesh is not None:
            return sharded_pq_topk(self.matrix, self._cb_dev, q, k, self.dim, self.mesh,
                                   self.axis, n_valid=self.n_valid, row_mask=row_mask)
        return pq_topk(self.matrix, self._cb_dev, q, k, n_valid=self.n_valid,
                       row_mask=row_mask)


def default_pq_m(d: int) -> int:
    """Largest subspace count with dsub >= 8 that divides d — d/8 when
    8 | d (one byte per 8 dims: binary's memory cost, codebook recall)."""
    if d <= 0:
        return 1
    for dsub in range(8, d + 1):
        if d % dsub == 0:
            return max(d // dsub, 1)
    return 1
