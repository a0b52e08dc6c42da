"""IVF (inverted-file) approximate search: a k-means coarse quantizer.

  * spherical k-means trains on the index's device (Lloyd iterations:
    assignment is one matmul + argmax, the centroid update a one-hot
    matmul, so the sums do not depend on scheduling);
  * database rows are stored sorted by cluster in a COMPACT layout: cluster
    c is rows offsets[c] .. offsets[c] + counts[c], so probing a cluster
    reads one contiguous range and nothing past it;
  * a query batch scores the centroids, probes its `nprobe` best clusters
    and keeps the k best candidates in (-score, probe rank, position within
    the cluster) order — the JAX package's order, so ids agree with it;
    candidates map back to original row ids;
  * exact within probed clusters: nprobe == n_clusters reproduces the
    exact scan;
  * optional spilled assignments (`spill=f`): the f fraction of rows with
    the smallest top-1/top-2 centroid margin get a second copy in their
    runner-up cluster; search fetches 2k candidates and dedups by id,
    keep-first;
  * optional capacity balancing (`balance=f`): clusters over
    ceil(f * n / clusters) rows are split into child centroids trained on
    their own members, then evenly, so the cap is hard.

Training, assignment, the entry plan and the cache files follow the JAX
package's `store/ivf.py` draw for draw (numpy generators seeded the same),
so a cache written by either package loads in the other. On a CUDA index
the probed scan launches `csrc/ivf_scan.cu` (`ops/ivf_scan.py`).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.ivf_scan import ivf_probe_scan
from ..ops.topk import _select_topk, as_row_mask, int8_query_digits, INT8_D_MAX

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _scores(rows: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[n, C] fp32 dots of rows and centroids (both in the training dtype;
    bf16 products are exact in fp32)."""
    return rows.float() @ cent.float().t()


def _kmeans_fit(data: torch.Tensor, init_idx, *, n_clusters: int, iters: int):
    """Spherical k-means (cosine): centroids stay L2-normalized, in the
    data's dtype. Returns (centroids [C, d], assignments [n])."""
    cent = data[torch.as_tensor(np.asarray(init_idx), device=data.device)]
    d32 = data.float()
    for _ in range(iters):
        assign = _scores(data, cent).argmax(dim=1)
        onehot = torch.nn.functional.one_hot(assign, n_clusters).float()
        sums = onehot.t() @ d32
        norms = torch.linalg.norm(sums, dim=1, keepdim=True)
        new = torch.where(norms > 1e-6, sums / torch.clamp(norms, min=1e-6),
                          cent.float())
        cent = new.to(data.dtype)
    return cent, _scores(data, cent).argmax(dim=1)


def _assign_all(rows_at, n: int, cent, want_spill: bool, chunk: int = 262144):
    """Assign every row to its nearest centroid, chunked. `rows_at(lo, hi)`
    returns rows [lo:hi] on the centroids' device in their dtype. With
    `want_spill`, also records each row's runner-up cluster and top-1/top-2
    margin (ties to the lower cluster, as `lax.top_k`)."""
    assign = np.empty(n, np.int32)
    second = np.empty(n, np.int32) if want_spill else None
    margin = np.empty(n, np.float32) if want_spill else None
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = _scores(rows_at(lo, hi), cent)
        if want_spill:
            top2_s, top2_i = (t.cpu().numpy() for t in _select_topk(s, 2))
            assign[lo:hi] = top2_i[:, 0]
            second[lo:hi] = top2_i[:, 1]
            margin[lo:hi] = top2_s[:, 0] - top2_s[:, 1]
        else:
            assign[lo:hi] = s.argmax(dim=1).cpu().numpy()
    return assign, second, margin


def _split_oversized(take, n: int, assign, cent, cap: int, seed: int,
                     *, iters: int = 5, sub_sample: int = 16384,
                     max_rounds: int = 4, chunk: int = 262144,
                     max_children: int = 16):
    """Spatially split clusters over `cap` rows via recursive k-means.

    `take(idx)` returns the given rows on the device in the centroid
    dtype. Child 0 reuses the parent's centroid slot; children 1.. append.
    Deterministic given `seed`: every draw comes from
    default_rng((seed, round, cluster)), and the training sample is
    wrap-padded to a power of two (np.resize) as the JAX package pads it.
    Clusters still over the cap are then sliced evenly into children that
    share the parent's exact centroid. Returns (assign, cent) with cent a
    host f32 array."""
    cent = cent.float().cpu().numpy().copy()
    assign = assign.copy()
    for rnd in range(max_rounds):
        counts = np.bincount(assign, minlength=len(cent))
        over = np.nonzero(counts > cap)[0]
        if len(over) == 0:
            break
        appended = []
        total = len(cent)
        for c in over:
            rows = np.nonzero(assign == c)[0]
            k_real = min(int(np.ceil(len(rows) / cap)), max_children)
            k_child = 1 << int(np.ceil(np.log2(max(k_real, 2))))
            rng = np.random.default_rng((seed, rnd, int(c)))
            samp = (rng.choice(rows, sub_sample, replace=False)
                    if len(rows) > sub_sample else rows)
            bucket = 1 << int(np.ceil(np.log2(max(len(samp), k_child))))
            samp = np.resize(samp, bucket)         # wrap-pad, as the JAX build
            sample_d = take(samp)
            init = rng.choice(bucket, k_child, replace=False)
            child, _ = _kmeans_fit(sample_d, init, n_clusters=k_child, iters=iters)
            ids = np.concatenate([[c], total + np.arange(k_child - 1)]).astype(np.int32)
            total += k_child - 1
            cent[c] = child[0].float().cpu().numpy()
            appended.append(child[1:].float().cpu().numpy())
            for lo in range(0, len(rows), chunk):
                sub = rows[lo:lo + chunk]
                am = _scores(take(sub), child).argmax(dim=1).cpu().numpy()
                assign[sub] = ids[am]
        cent = np.concatenate([cent] + appended)

    counts = np.bincount(assign, minlength=len(cent))
    over = np.nonzero(counts > cap)[0]
    if len(over):
        appended = []
        total = len(cent)
        for c in over:
            rows = np.nonzero(assign == c)[0]
            k_res = int(np.ceil(len(rows) / cap))
            ids = np.concatenate([[c], total + np.arange(k_res - 1)]).astype(np.int32)
            total += k_res - 1
            appended.append(np.repeat(cent[c][None], k_res - 1, axis=0))
            assign[rows] = ids[np.arange(len(rows)) * k_res // len(rows)]
        cent = np.concatenate([cent] + appended)
    return assign, cent


def _plan_entries(n: int, n_clusters: int, assign, second, margin,
                  spill: float, cap: Optional[int] = None):
    """Entry table from assignments: spilled copies (the `spill` fraction
    of rows closest to their runner-up centroid get a second copy there,
    admitted per runner-up cluster up to the balance cap, most-boundary
    rows first), then the cluster-sorted order + per-cluster counts."""
    entry_id = np.arange(n, dtype=np.int64)
    entry_cl = assign
    n_spill = 0
    if spill > 0.0 and second is not None:
        extra = np.nonzero(margin <= np.quantile(margin, spill))[0]
        if cap is not None and len(extra):
            room = cap - np.bincount(assign, minlength=n_clusters)
            by_margin = extra[np.lexsort((extra, margin[extra]))]
            tgt = second[by_margin]
            by_tgt = np.argsort(tgt, kind="stable")
            tgt_s = tgt[by_tgt]
            first = np.searchsorted(tgt_s, np.arange(n_clusters))
            rank = np.arange(len(tgt_s)) - first[tgt_s]
            keep_s = rank < np.maximum(room[tgt_s], 0)
            keep = np.zeros(len(by_margin), bool)
            keep[by_tgt] = keep_s
            extra = np.sort(by_margin[keep])   # row-id entry order
        n_spill = len(extra)
        entry_id = np.concatenate([entry_id, extra])
        entry_cl = np.concatenate([assign, second[extra]])
    order = entry_id[np.argsort(entry_cl, kind="stable")]
    counts = np.bincount(entry_cl, minlength=n_clusters)
    return order, counts, n_spill


def _dedup_keep_first(scores: torch.Tensor, ids: torch.Tensor):
    """Mask later duplicates of an id (spilled rows can surface twice from
    two probed clusters). Candidates arrive in (-score, position) order, so
    keep-first preserves the exact tie order. [Q, c] with c <= 2k."""
    c = ids.shape[1]
    eq = ids[:, None, :] == ids[:, :, None]                       # [Q, c, c]
    earlier = torch.tril(torch.ones((c, c), dtype=torch.bool, device=ids.device), -1)
    dup = (eq & earlier[None]).any(dim=2)
    return (torch.where(dup, float("-inf"), scores), torch.where(dup, -1, ids))


class IVFIndex:
    """Approximate cosine/dot top-k over cluster-sorted rows (bf16, fp32
    or int8 storage; k-means training and centroid scoring in bf16 for the
    bf16 and int8 cells, fp32 for fp32)."""

    def __init__(self, vectors: np.ndarray, *, n_clusters: int = 256,
                 train_iters: int = 10, train_sample: int = 131072,
                 dtype: str = "bfloat16", seed: int = 0, spill: float = 0.0,
                 balance: float = 0.0, mesh=None, device=None,
                 _precomputed=None):
        from ..models.pe import resolve_device

        if mesh is not None:
            raise NotImplementedError(
                "sharded IVF is not ported yet (multi-GPU, ROADMAP queue 1 item 21)")
        n, d = vectors.shape
        if n == 0:
            raise ValueError("empty index")
        if not 0.0 <= spill <= 1.0:
            raise ValueError(f"spill must be in [0, 1], got {spill}")
        if balance and balance < 1.0:
            raise ValueError(f"balance must be 0 or >= 1.0, got {balance}")
        if dtype not in ("bfloat16", "float32", "int8"):
            raise NotImplementedError(f"IVF dtype={dtype!r}: bfloat16, float32 or int8")
        self.device = resolve_device(device)
        self._int8 = dtype == "int8"
        self._dtype = torch.bfloat16 if self._int8 else _DTYPES[dtype]
        if self._int8 and d > INT8_D_MAX:
            raise ValueError(
                f"int8 IVF requires d <= {INT8_D_MAX} for exact f32 partials (got d={d})")
        self.db_scale = None
        n_clusters = min(n_clusters, n)
        rng = np.random.default_rng(seed)
        vec32 = np.asarray(vectors)
        dev, dt = self.device, self._dtype

        def rows(idx_or_lo, hi=None):
            part = vec32[idx_or_lo:hi] if hi is not None else vec32[idx_or_lo]
            return torch.from_numpy(np.array(part, np.float32)).to(dev, dt)

        if _precomputed is not None:
            cent_np, order, counts, n_spill = _precomputed
            cent = torch.from_numpy(np.asarray(cent_np, np.float32)).to(dev, dt)
            order = np.asarray(order, np.int64)
            counts = np.asarray(counts)
        else:
            sample_idx = (rng.choice(n, min(train_sample, n), replace=False)
                          if n > train_sample else np.arange(n))
            init = rng.choice(len(sample_idx), n_clusters, replace=False)
            cent, _ = _kmeans_fit(rows(sample_idx), init, n_clusters=n_clusters,
                                  iters=train_iters)
            want_spill = spill > 0.0 and n_clusters > 1
            assign, second, margin = _assign_all(rows, n, cent, want_spill)
            cap = None
            if balance > 0.0 and n_clusters > 1:
                # cap from the trained granularity; splitting may then grow
                # n_clusters (children of oversized clusters)
                cap = int(np.ceil(balance * n / n_clusters))
                assign, cent_np = _split_oversized(rows, n, assign, cent, cap, seed)
                n_clusters = len(cent_np)
                cent = torch.from_numpy(cent_np).to(dev, dt)
            order, counts, n_spill = _plan_entries(
                n, n_clusters, assign, second, margin, spill, cap)

        counts = np.asarray(counts, np.int64)
        offsets = np.cumsum(counts) - counts
        self.n = n
        self.dim = d
        self.n_clusters = n_clusters
        self.n_entries = len(order)          # n + spilled copies
        self.n_spill = int(n_spill)
        self.cmax = int(counts.max())
        self.centroids = cent
        self.row_ids = torch.from_numpy(order.astype(np.int32)).to(dev)
        self.offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)
        self.counts = torch.from_numpy(counts.astype(np.int32)).to(dev)
        self.matrix = self._sorted_matrix(vec32, order)

    def _sorted_matrix(self, vec32: np.ndarray, order: np.ndarray) -> torch.Tensor:
        """The cluster-sorted rows on the device: storage dtype, or int8
        quantized by fp32 `round(x * (127 / amax))` with one global scale
        (amax over every row), the JAX package's host math."""
        m, d = len(order), self.dim
        dev = self.device
        out = torch.empty((m, d), dtype=torch.int8 if self._int8 else self._dtype,
                          device=dev)
        inv = None
        if self._int8:
            amax = np.float32(0.0)
            for lo in range(0, len(vec32), 65536):
                amax = max(amax, np.float32(np.abs(np.asarray(
                    vec32[lo:lo + 65536], np.float32)).max(initial=0.0)))
            amax = np.float32(max(amax, np.float32(1e-30)))
            self.db_scale = float(amax / np.float32(127.0))
            inv = torch.tensor(np.float32(127.0) / amax, device=dev)
        for lo in range(0, m, 65536):
            idx = order[lo:lo + 65536]
            x = torch.from_numpy(np.array(vec32[idx], np.float32)).to(dev)
            out[lo:lo + len(idx)] = (
                torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
                if self._int8 else x.to(self._dtype))
        return out

    @classmethod
    def from_device(cls, *args, **kwargs):
        raise NotImplementedError(
            "IVFIndex.from_device is not ported yet (a later capacity slice, "
            "ROADMAP queue 1 item 15)")

    @classmethod
    def from_chunks(cls, *args, **kwargs):
        raise NotImplementedError(
            "IVFIndex.from_chunks (device build from a virtual corpus) is not "
            "ported yet (a later capacity slice, ROADMAP queue 1 item 15)")

    # -- persistence (skip k-means on reload) ---------------------------

    def save_cache(self, path: str) -> None:
        """Persist the training result (centroids + cluster order + counts),
        in the JAX package's format, so a restart rebuilds this index
        without retraining k-means or re-assigning the rows."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"         # savez appends .npz if absent
        np.savez_compressed(
            tmp,
            centroids=self.centroids.float().cpu().numpy(),
            order=self.row_ids.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            meta=np.asarray([self.n, self.dim, self.n_clusters, self.n_spill]))
        os.replace(tmp, path)

    @classmethod
    def load_cache(cls, vectors: np.ndarray, path: str, *,
                   dtype: str = "bfloat16", mesh=None, device=None):
        """Rebuild an IVFIndex from `save_cache` output (either package's) +
        the original vectors. Returns None on any mismatch (row count/dim
        changed) so callers fall back to a fresh build."""
        try:
            with np.load(path) as z:
                meta = z["meta"]
                if int(meta[0]) != vectors.shape[0] or \
                        int(meta[1]) != vectors.shape[1]:
                    return None
                n_spill = int(meta[3]) if len(meta) > 3 else 0
                pre = (z["centroids"], z["order"], z["counts"], n_spill)
                n_clusters = int(meta[2])
        except (OSError, KeyError, ValueError):
            return None
        return cls(vectors, n_clusters=n_clusters, dtype=dtype, mesh=mesh,
                   device=device, _precomputed=pre)

    @classmethod
    def extend_cache(cls, vectors: np.ndarray, path: str, *,
                     dtype: str = "bfloat16", mesh=None, device=None,
                     max_grow: float = 0.5):
        """Extend a cached index with newly APPENDED rows: assign rows
        [n_old:] to the cached centroids (no retrain) and merge them into
        the entry table behind the old entries of each cluster. Returns
        None if the cache is not a strict prefix, dims mismatch, or growth
        exceeds `max_grow` of the trained corpus. Spill (if the cache used
        it) applies to the new rows at the same fraction, thresholded on
        their own margin quantile."""
        from ..models.pe import resolve_device

        n, d = vectors.shape
        try:
            with np.load(path) as z:
                meta = z["meta"]
                n_old = int(meta[0])
                if int(meta[1]) != d or not 0 < n_old < n:
                    return None
                if (n - n_old) / n_old > max_grow:
                    return None
                cent = np.asarray(z["centroids"], np.float32)
                order = np.asarray(z["order"], np.int64)
                counts_old = np.asarray(z["counts"], np.int64)
                n_clusters = int(meta[2])
                n_spill_old = int(meta[3]) if len(meta) > 3 else 0
        except (OSError, KeyError, ValueError):
            return None

        dev = resolve_device(device)
        dt = torch.bfloat16 if dtype == "int8" else _DTYPES[dtype]
        cent_d = torch.from_numpy(cent).to(dev, dt)
        new32 = np.asarray(vectors[n_old:])
        n_new = n - n_old
        spill_frac = n_spill_old / n_old
        want_spill = spill_frac > 0 and n_clusters > 1
        assign, second, margin = _assign_all(
            lambda lo, hi: torch.from_numpy(np.array(new32[lo:hi], np.float32)).to(dev, dt),
            n_new, cent_d, want_spill)

        new_ids = np.arange(n_old, n, dtype=np.int64)
        new_cl = assign
        n_spill_new = 0
        if want_spill:
            extra = np.nonzero(margin <= np.quantile(margin, spill_frac))[0]
            n_spill_new = len(extra)
            new_cl = np.concatenate([assign, second[extra]])
            new_ids = np.concatenate([new_ids, np.arange(n_old, n)[extra]])

        old_cl = np.repeat(np.arange(n_clusters), counts_old)
        ids_all = np.concatenate([order, new_ids])
        cl_all = np.concatenate([old_cl, new_cl])
        order_all = ids_all[np.argsort(cl_all, kind="stable")]
        counts_all = np.bincount(cl_all, minlength=n_clusters)
        pre = (cent, order_all, counts_all, n_spill_old + n_spill_new)
        return cls(vectors, n_clusters=n_clusters, dtype=dtype, mesh=mesh,
                   device=device, _precomputed=pre)

    def _sorted_mask(self, row_mask) -> torch.Tensor:
        """[n] original-id mask (a host array or a tensor on any device;
        entries past it are False) -> uint8 over sorted rows on the index's
        device (spilled copies inherit their row's bit)."""
        return as_row_mask(row_mask, self.n, self.device)[self.row_ids.long()]

    def search(self, queries, k: int, *, nprobe: int = 8, impl: str = "auto",
               row_mask=None):
        """Returns device tensors (scores [Q, k] f32, original row ids
        [Q, k] int32).

        `impl` names a TPU choice of the JAX package (its Pallas kernel or
        XLA loop); here every value takes the same path: on a CUDA index the
        probed-scan kernel (K11), masked or not, and on a CPU index its
        plain version. `row_mask` ([n] bool over ORIGINAL row ids) restricts
        results to matching rows; probe selection is unchanged."""
        del impl
        nprobe = min(nprobe, self.n_clusters)
        q32 = torch.as_tensor(np.asarray(queries, np.float32) if not isinstance(
            queries, torch.Tensor) else queries).to(self.device, torch.float32)
        if q32.ndim == 1:
            q32 = q32[None]
        q = q32.to(self._dtype)                 # centroid-probe copy
        _, top_c = _select_topk(_scores(q, self.centroids), nprobe)
        base = self.offsets[top_c]
        cnt = self.counts[top_c]
        qdig = row_scale = None
        if self._int8:
            q_hi, q_lo, c2 = int8_query_digits(q32)
            qdig = torch.stack([q_hi, q_lo])
            row_scale = c2 * torch.tensor(self.db_scale, dtype=torch.float32,
                                          device=self.device)
        dedup = self.n_spill > 0
        k_eff = min(k, nprobe * self.cmax)
        k_fetch = min(2 * k, nprobe * self.cmax) if dedup else k_eff
        mask = self._sorted_mask(row_mask) if row_mask is not None else None
        s, pos = ivf_probe_scan(self.matrix, q, qdig, row_scale, base, cnt,
                                k=k_fetch, cmax=self.cmax, int8=self._int8,
                                mask_sorted=mask)
        s = s[:, :k_fetch]
        pos = pos[:, :k_fetch].long()
        ids = torch.where(pos >= 0, self.row_ids[pos.clamp(min=0)], -1)
        ids = torch.where(torch.isneginf(s), -1, ids)
        if dedup:
            s, ids = _dedup_keep_first(s, ids)
            s, sel = _select_topk(s, k_eff)
            ids = ids.gather(1, sel)
        qn = s.shape[0]
        if k_eff < k:
            s = torch.cat([s, s.new_full((qn, k - k_eff), float("-inf"))], 1)
            ids = torch.cat([ids, ids.new_full((qn, k - k_eff), -1)], 1)
        return s, ids.to(torch.int32)
