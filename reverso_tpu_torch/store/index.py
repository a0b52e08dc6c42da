"""Device-resident indexes over a store's embedding matrix: the exact
index (bf16, fp32 or int8 rows) and the sign-packed binary candidate
index."""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.binary import binary_topk, pack_signs
from ..ops.topk import (INT8_D_MAX, K_CAP, as_row_mask, cosine_topk,
                        cosine_topk_int8_exact, cosine_topk_int8_xla,
                        int8_clip_bound, log)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
_CHUNK = 65536   # host rows per upload step


def host_chunks(vectors: np.ndarray, device):
    """(lo, fp32 rows [lo:lo + _CHUNK] on `device`) for the rows of a host
    matrix (a read-only store map is fine: each chunk is copied)."""
    for lo in range(0, len(vectors), _CHUNK):
        yield lo, torch.from_numpy(np.array(vectors[lo:lo + _CHUNK], np.float32)).to(device)


def _empty(qn: int, k: int, device):
    return (torch.full((qn, k), float("-inf"), device=device),
            torch.full((qn, k), -1, dtype=torch.int32, device=device))


def _check_layout(distance: str, mesh) -> None:
    if distance not in ("cosine", "dot"):
        raise NotImplementedError(
            f"distance={distance!r}: only cosine/dot indexes are ported "
            f"(euclid/manhattan come with the XLA-only ops, ROADMAP queue 1 "
            f"item 16)")
    if mesh is not None:
        raise NotImplementedError(
            "sharded indexes are not ported yet (multi-GPU, ROADMAP queue 1 "
            "item 21)")


class DeviceIndex:
    """Immutable snapshot of an embedding matrix, resident on one device.

    Exact top-k under "cosine" or "dot" (a dot over the rows as stored;
    cosine stores hold unit rows). `dtype` "bfloat16"/"float32" stores the
    rows as they are (queries cast to the matrix dtype); "int8" stores them
    globally-symmetric quantized with the scale from the real rows
    (`int8_quantile` 0 = abs-max, else that abs-value quantile: outliers
    clip), and searches are exact with respect to the stored int8 rows.
    `n_valid` is the number of real rows: slots beyond them come back as
    (score -inf, idx -1). The CUDA kernels take any row count, so rows are
    not padded. Rebuild (one host->device copy) after appending to the
    backing store.
    """

    def __init__(self, vectors: np.ndarray, *, mesh=None,
                 dtype: str = "bfloat16", distance: str = "cosine",
                 device=None, int8_quantile: float = 0.0):
        _check_layout(distance, mesh)
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype={dtype!r}: the exact index holds bfloat16, float32 or "
                f"int8 rows")
        from ..models.pe import resolve_device

        vectors = np.asarray(vectors)
        n, d = vectors.shape
        self.distance = distance
        self.n_valid = n
        self.dim = d
        self.device = resolve_device(device)
        self._dtype = _DTYPES[dtype]
        self.scale = None
        self.matrix = torch.empty((n, d), dtype=self._dtype, device=self.device)
        if self._dtype == torch.int8:
            # round(x * (127 / amax)) in fp32 (the JAX package's host math)
            amax = int8_clip_bound(vectors[:max(n, 1)], int8_quantile)
            self.scale = float(amax / np.float32(127.0))
            inv = torch.tensor(np.float32(127.0) / amax, device=self.device)
        for lo, x in host_chunks(vectors, self.device):
            self.matrix[lo:lo + len(x)] = (
                torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
                if self._dtype == torch.int8 else x.to(self._dtype))

    @property
    def nbytes(self) -> int:
        return self.matrix.numel() * self.matrix.element_size()

    def search(self, queries, k: int, *, row_mask=None, **_):
        """Exact top-k. queries: [Q, d] or [d] (host array or tensor).
        `row_mask` ([n_valid] bool, host or device) restricts the scan to
        the matching rows (payload filters, deleted vectors): exact over
        the subset, same (-score, idx) order.

        Returns device tensors (scores [Q, k] f32, idx [Q, k] int32) in
        (-score, idx) order; idx -1 marks slots beyond the scoring rows.
        int8 searches above the kernel's k cap or past d = 1040 take the
        chunked plain scan (a counted shape rule on the card)."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.array(queries, np.float32))
        q = queries.to(self.device, torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.n_valid == 0:
            return _empty(q.shape[0], k, self.device)
        mask = as_row_mask(row_mask, self.n_valid, self.device)
        if self._dtype != torch.int8:
            return cosine_topk(self.matrix, q, k, n_valid=self.n_valid, row_mask=mask)
        if k > K_CAP or self.dim > INT8_D_MAX:
            if self.device.type == "cuda":
                log.info(f"int8 k={k} d={self.dim} past the kernel's bounds: chunked scan")
                kernels.plain_dispatches["int8_above_cap_or_wide"] += 1
            return cosine_topk_int8_xla(self.matrix, self.scale, q, k,
                                        n_valid=self.n_valid, row_mask=mask)
        return cosine_topk_int8_exact(self.matrix, self.scale, q, k,
                                      n_valid=self.n_valid, row_mask=mask)


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
    are identical)."""

    def __init__(self, vectors: np.ndarray, *, mesh=None, device=None):
        _check_layout("cosine", mesh)
        from ..models.pe import resolve_device

        v = np.asarray(vectors)
        self.n_valid = len(v)
        self.dim = v.shape[1] if v.ndim == 2 and v.size else 0
        self.device = resolve_device(device)
        self.center = (v.mean(axis=0, dtype=np.float64).astype(np.float32)
                       if self.n_valid else np.zeros((max(self.dim, 1),), np.float32))
        w = max((self.dim + 7) // 8, 1)
        self.matrix = torch.zeros((self.n_valid, w), dtype=torch.uint8, device=self.device)
        center = torch.from_numpy(self.center).to(self.device)
        for lo, x in host_chunks(v, self.device):
            self.matrix[lo:lo + len(x)] = pack_signs(x - center, plane_width=w)

    @classmethod
    def from_chunks(cls, *args, **kwargs):
        raise NotImplementedError(
            "BinaryIndex.from_chunks (device build from a virtual corpus) is not "
            "ported yet (a later capacity slice, ROADMAP queue 1 item 14)")

    def search(self, queries, k: int, *, row_mask=None, **_):
        """Candidate top-k under the binary proxy score; device tensors
        (scores [Q, k] f32, idx [Q, k] int32) in (-score, idx) order."""
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.array(queries, np.float32))
        q = queries.to(self.device, torch.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.n_valid == 0:
            return _empty(q.shape[0], k, self.device)
        return binary_topk(self.matrix, q, k, self.dim, n_valid=self.n_valid,
                           row_mask=as_row_mask(row_mask, self.n_valid, self.device))
