"""Device-resident exact index over a store's embedding matrix."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import cosine_topk

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class DeviceIndex:
    """Immutable snapshot of an embedding matrix, resident on one device.

    Exact top-k under "cosine" or "dot" (a dot over the rows as stored;
    cosine stores hold unit rows). Queries are cast to the matrix dtype.
    `n_valid` is the number of real rows: slots beyond them come back as
    (score -inf, idx -1). The CUDA kernel takes any row count, so rows are
    not padded. Rebuild (one host->device copy) after appending to the
    backing store.
    """

    def __init__(self, vectors: np.ndarray, *, mesh=None,
                 dtype: str = "bfloat16", distance: str = "cosine",
                 device=None):
        if distance not in ("cosine", "dot"):
            raise NotImplementedError(
                f"distance={distance!r}: only cosine/dot indexes are ported")
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"dtype={dtype!r}: only bfloat16/float32 indexes are ported")
        if mesh is not None:
            raise NotImplementedError("sharded indexes are not ported yet")
        from ..models.pe import resolve_device

        vectors = np.require(vectors, np.float32, ["C", "W"])
        n, d = vectors.shape
        self.distance = distance
        self.n_valid = n
        self.dim = d
        self.device = resolve_device(device)
        self._dtype = _DTYPES[dtype]
        self.matrix = torch.from_numpy(vectors).to(self.device, self._dtype)

    @property
    def nbytes(self) -> int:
        return self.matrix.numel() * self.matrix.element_size()

    def search(self, queries, k: int, *, row_mask=None):
        """Exact top-k. queries: [Q, d] or [d] (host array or tensor).

        Returns device tensors (scores [Q, k] f32, idx [Q, k] int32) in
        (-score, idx) order; idx -1 marks slots beyond the valid rows."""
        if row_mask is not None:
            raise NotImplementedError("filtered (row_mask) search is not ported yet")
        if not isinstance(queries, torch.Tensor):
            queries = torch.from_numpy(np.require(queries, np.float32, ["C", "W"]))
        q = queries.to(self.device, self._dtype)
        if q.ndim == 1:
            q = q[None, :]
        if self.n_valid == 0:
            qn = q.shape[0]
            return (torch.full((qn, k), float("-inf"), device=self.device),
                    torch.full((qn, k), -1, dtype=torch.int32, device=self.device))
        return cosine_topk(self.matrix, q, k, n_valid=self.n_valid)
