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

Three builds share that math: from host rows (the constructor), from
rows already on the device (`from_device`: the sample gather, the
assignment, the sort gather and the int8 quantization run there; only the
O(N) entry tables cross to the host) and from a corpus that never exists
as one array (`from_chunks`: `chunk_fn(lo, rows)` makes any window on the
device; three streamed passes: sample, assignment with the int8 abs-max,
then each window's entries quantized and scattered into the sorted
matrix). With a multi-device `mesh`, the sorted matrix is row-sharded over
the mesh's `axis` in contiguous ranges (`parallel/sharding.py`); every
shard probes the same clusters, scans (K11 on the card) the part of each
probed cluster it holds, and the shards' candidates merge on the mesh's
first device by (-score, probe rank, position): the single-device order.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.ivf_scan import ivf_probe_scan
from ..ops.topk import _select_topk, as_row_mask, int8_query_digits, merge_order, INT8_D_MAX
from ..parallel.sharding import Shards, on_device
from .index import nbytes_of, placement, write_rows, zero_rows

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
    bf16 and int8 cells, fp32 for fp32). `matrix` is the sorted rows on
    `device`, or their `Shards` over a multi-device `mesh`."""

    def __init__(self, vectors: np.ndarray, *, n_clusters: int = 256,
                 train_iters: int = 10, train_sample: int = 131072,
                 dtype: str = "bfloat16", seed: int = 0, spill: float = 0.0,
                 balance: float = 0.0, mesh=None, axis: str = "data", device=None,
                 _precomputed=None):
        vec32 = np.asarray(vectors)
        n, d = vec32.shape
        self._setup(n, d, dtype, spill, balance, mesh, axis, device)
        dev, dt = self.device, self._dtype

        def rows(idx_or_lo, hi=None):
            part = vec32[idx_or_lo:hi] if hi is not None else vec32[idx_or_lo]
            return torch.from_numpy(np.array(part, np.float32)).to(dev, dt)

        order = self._train(n, rows, rows, rows, n_clusters=n_clusters,
                            train_iters=train_iters, train_sample=train_sample,
                            seed=seed, spill=spill, balance=balance,
                            precomputed=_precomputed)
        inv = None
        if self._int8:
            amax = np.float32(0.0)
            for lo in range(0, n, 65536):
                amax = max(amax, np.float32(np.abs(np.asarray(
                    vec32[lo:lo + 65536], np.float32)).max(initial=0.0)))
            inv = self._set_scale(amax)
        self._fill(lambda idx: torch.from_numpy(np.array(vec32[idx], np.float32)).to(dev),
                   order, inv)

    @property
    def nbytes(self) -> int:
        """Bytes of the sorted rows on the card (all shards)."""
        return nbytes_of(self.matrix)

    # -- the shared build steps ---------------------------------------------

    def _setup(self, n: int, d: int, dtype: str, spill: float, balance: float,
               mesh, axis: str, device) -> None:
        if n == 0:
            raise ValueError("empty index")
        if not 0.0 <= spill <= 1.0:
            raise ValueError(f"spill must be in [0, 1], got {spill}")
        if balance and balance < 1.0:
            raise ValueError(f"balance must be 0 or >= 1.0, got {balance}")
        if dtype not in ("bfloat16", "float32", "int8"):
            raise NotImplementedError(f"IVF dtype={dtype!r}: bfloat16, float32 or int8")
        self.mesh, self.device = placement(mesh, device)
        self.axis = axis
        self._int8 = dtype == "int8"
        self._dtype = torch.bfloat16 if self._int8 else _DTYPES[dtype]
        if self._int8 and d > INT8_D_MAX:
            raise ValueError(
                f"int8 IVF requires d <= {INT8_D_MAX} for exact f32 partials (got d={d})")
        self.db_scale = None
        self.n = n
        self.dim = d

    def _train(self, n: int, rows, take, sample_of, *, n_clusters: int, train_iters: int,
               train_sample: int, seed: int, spill: float, balance: float, precomputed,
               assign_chunk: int = 262144) -> np.ndarray:
        """k-means on the seeded sample, every row's assignment (with spill
        margins), the balance split and the entry plan, or a cache's
        tables (`precomputed`); sets the index's tables and returns the
        entry order (source row of each sorted row). `rows(lo, hi)` /
        `take(idx)` give source rows on the device in the training dtype
        (`take` only for `balance`), `sample_of(sample_idx)` the sample in
        draw order."""
        dev, dt = self.device, self._dtype
        n_clusters = min(n_clusters, n)
        if precomputed is not None:
            cent_np, order, counts, n_spill = precomputed
            cent = torch.from_numpy(np.asarray(cent_np, np.float32)).to(dev, dt)
            order = np.asarray(order, np.int64)
            counts = np.asarray(counts)
        else:
            rng = np.random.default_rng(seed)
            sample_idx = (rng.choice(n, min(train_sample, n), replace=False)
                          if n > train_sample else np.arange(n))
            init = rng.choice(len(sample_idx), n_clusters, replace=False)
            cent, _ = _kmeans_fit(sample_of(sample_idx), init, n_clusters=n_clusters,
                                  iters=train_iters)
            want_spill = spill > 0.0 and n_clusters > 1
            assign, second, margin = _assign_all(rows, n, cent, want_spill,
                                                 chunk=assign_chunk)
            cap = None
            if balance > 0.0 and n_clusters > 1:
                # cap from the trained granularity; splitting may then grow
                # n_clusters (children of oversized clusters)
                cap = int(np.ceil(balance * n / n_clusters))
                assign, cent_np = _split_oversized(take, n, assign, cent, cap, seed)
                n_clusters = len(cent_np)
                cent = torch.from_numpy(cent_np).to(dev, dt)
            order, counts, n_spill = _plan_entries(
                n, n_clusters, assign, second, margin, spill, cap)
        counts = np.asarray(counts, np.int64)
        offsets = np.cumsum(counts) - counts
        self.n_clusters = len(counts)
        self.n_entries = len(order)          # n + spilled copies
        self.n_spill = int(n_spill)
        self.cmax = int(counts.max())
        self.centroids = cent
        self.row_ids = torch.from_numpy(order.astype(np.int32)).to(dev)
        self.offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)
        self.counts = torch.from_numpy(counts.astype(np.int32)).to(dev)
        return order

    def _set_scale(self, amax) -> Optional[torch.Tensor]:
        """int8: the global scale from the rows' abs-max (host fp32, the JAX
        package's math); returns the quantizer's 127 / amax on the device."""
        amax = np.float32(max(np.float32(amax), np.float32(1e-30)))
        self.db_scale = float(amax / np.float32(127.0))
        return torch.tensor(np.float32(127.0) / amax, device=self.device)

    def _store(self, x: torch.Tensor, inv) -> torch.Tensor:
        """fp32 rows -> the storage dtype: int8 by round(x * (127 / amax))
        in fp32 (a multiply, as the JAX package quantizes), else a cast."""
        if inv is None:
            return x.to(self._dtype)
        return torch.clamp(torch.round(x.float() * inv.to(x.device)), -127, 127).to(torch.int8)

    def _empty_matrix(self):
        return zero_rows(self.n_entries, self.dim, torch.int8 if self._int8 else self._dtype,
                         self.device, self.mesh, self.axis)

    def _fill(self, gather, order: np.ndarray, inv, step: int = 65536) -> None:
        """The sorted matrix: `gather(idx)` gives the fp32 source rows of
        entries idx (a host index array) on the device, one step at a
        time."""
        self.matrix = self._empty_matrix()
        for lo in range(0, len(order), step):
            write_rows(self.matrix, lo, self._store(gather(order[lo:lo + step]), inv))

    # -- device builds ------------------------------------------------------

    @classmethod
    def from_device(cls, emb, *, n_clusters: int = 256, train_iters: int = 10,
                    train_sample: int = 131072, dtype: str = "bfloat16", seed: int = 0,
                    spill: float = 0.0, balance: float = 0.0, mesh=None,
                    axis: str = "data", device=None, _precomputed=None):
        """Build from rows already on the device (`emb` [n, d] float tensor;
        a host array is copied to `device` first). Every O(N * d) step runs
        there: the k-means sample gather, the assignment, the sorted
        gather and the int8 quantization (abs-max by chunks, the scale
        and its inverse in host fp32); only the O(N) entry tables cross to
        the host. The same values and seed give the host build's index bit
        for bit. With a multi-device `mesh`, the sorted rows are written
        straight into their shards."""
        from ..models.pe import resolve_device

        if not isinstance(emb, torch.Tensor):
            emb = torch.from_numpy(np.ascontiguousarray(emb)).to(resolve_device(device))
        n, d = emb.shape
        self = object.__new__(cls)
        self._setup(n, d, dtype, spill, balance, mesh, axis,
                    emb.device if device is None and mesh is None else device)
        dev, dt = self.device, self._dtype

        def take(idx):
            return emb[torch.as_tensor(np.asarray(idx), device=emb.device)].to(dev, dt)

        order = self._train(n, lambda lo, hi: emb[lo:hi].to(dev, dt), take, take,
                            n_clusters=n_clusters, train_iters=train_iters,
                            train_sample=train_sample, seed=seed, spill=spill,
                            balance=balance, precomputed=_precomputed)
        inv = None
        if self._int8:
            # abs and max by chunks: a whole abs(emb) would copy the source
            amax = max((float(emb[lo:lo + 262144].abs().max()) for lo in range(0, n, 262144)),
                       default=0.0)
            inv = self._set_scale(amax)
        self._fill(lambda idx: emb[torch.as_tensor(idx, device=emb.device)].to(dev, torch.float32),
                   order, inv)
        return self

    @classmethod
    def from_chunks(cls, chunk_fn, n: int, d: int, *, chunk: int = 1 << 19,
                    n_clusters: int = 256, train_iters: int = 10,
                    train_sample: int = 131072, dtype: str = "bfloat16", seed: int = 0,
                    spill: float = 0.0, mesh=None, axis: str = "data", device=None):
        """Build from a corpus that never exists as one array:
        `chunk_fn(lo, rows)` returns the [rows, d] float block of rows lo ..
        lo + rows on the device for any window of `chunk` rows (a seeded
        generator, a staged disk read), so an 8M x 1024 source never sits
        beside its own index. Three passes over the windows: the k-means
        sample (the same draw as every other build, placed by position),
        the assignment with the int8 abs-max, then each window's entries
        (found through the entries sorted by source row) stored and
        scattered into the sorted matrix (or its shards); one window lives
        at a time. Any `chunk` works: an assignment step that straddles two
        windows reads both. `balance` is not taken (its split re-reads
        rows at random). The same values and seed give `from_device`'s
        index bit for bit."""
        if n <= 0:
            raise ValueError("empty index")
        self = object.__new__(cls)
        self._setup(n, d, dtype, spill, 0.0, mesh, axis, device)
        dev, dt = self.device, self._dtype
        windows = [(lo, min(chunk, n - lo)) for lo in range(0, n, chunk)]
        amax = [np.float32(0.0)]
        held = {}

        def window(w: int) -> torch.Tensor:
            if held.get("w") != w:
                held.clear()
                blk = chunk_fn(*windows[w]).to(dev)
                if self._int8:
                    amax[0] = max(amax[0], np.float32(float(blk.abs().max())))
                held.update(w=w, blk=blk)
            return held["blk"]

        def rows_at(lo, hi):
            parts = []
            for w in range(lo // chunk, (hi - 1) // chunk + 1):
                w_lo = windows[w][0]
                parts.append(window(w)[max(lo, w_lo) - w_lo:min(hi, w_lo + chunk) - w_lo])
            return torch.cat(parts).to(dt) if len(parts) > 1 else parts[0].to(dt)

        def sample_of(sample_idx):
            out = torch.empty((len(sample_idx), d), dtype=dt, device=dev)
            for lo, rows in windows:
                sel = np.nonzero((sample_idx >= lo) & (sample_idx < lo + rows))[0]
                if len(sel):
                    blk = chunk_fn(lo, rows).to(dev)
                    out[torch.from_numpy(sel).to(dev)] = blk[
                        torch.from_numpy(sample_idx[sel] - lo).to(dev)].to(dt)
                    del blk
            return out

        order = self._train(n, rows_at, None, sample_of, n_clusters=n_clusters,
                            train_iters=train_iters, train_sample=train_sample, seed=seed,
                            spill=spill, balance=0.0, precomputed=None,
                            assign_chunk=min(262144, chunk))
        held.clear()
        inv = self._set_scale(amax[0]) if self._int8 else None
        self.matrix = self._empty_matrix()
        # the entries by source row: a window's entries are one run of them
        by_src = np.argsort(order, kind="stable")
        src_sorted = order[by_src]
        for lo, rows in windows:
            a, b = np.searchsorted(src_sorted, [lo, lo + rows])
            if a == b:
                continue
            blk = chunk_fn(lo, rows).to(dev)
            ent = by_src[a:b]
            x = blk[torch.from_numpy(order[ent] - lo).to(dev)]
            del blk
            scatter_rows(self.matrix, torch.from_numpy(ent).to(dev), self._store(x, inv))
            del x
        return self

    @classmethod
    def load_cache_device(cls, emb, path: str, *, dtype: str = "bfloat16", mesh=None,
                          axis: str = "data", device=None):
        """`load_cache` from rows already on the device, through
        `from_device` (one gather on the device, no O(N * d) host traffic).
        Returns None on any cache or shape mismatch."""
        pre = _read_cache(path, tuple(emb.shape))
        if pre is None:
            return None
        return cls.from_device(emb, n_clusters=len(pre[2]), dtype=dtype, mesh=mesh,
                               axis=axis, device=device, _precomputed=pre)

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
                   dtype: str = "bfloat16", mesh=None, axis: str = "data", device=None):
        """Rebuild an IVFIndex from `save_cache` output (either package's) +
        the original vectors. Returns None on any mismatch (row count/dim
        changed) so callers fall back to a fresh build."""
        pre = _read_cache(path, vectors.shape)
        if pre is None:
            return None
        return cls(vectors, n_clusters=len(pre[2]), dtype=dtype, mesh=mesh, axis=axis,
                   device=device, _precomputed=pre)

    @classmethod
    def extend_cache(cls, vectors: np.ndarray, path: str, *,
                     dtype: str = "bfloat16", mesh=None, axis: str = "data", device=None,
                     max_grow: float = 0.5):
        """Extend a cached index with newly APPENDED rows: assign rows
        [n_old:] to the cached centroids (no retrain) and merge them into
        the entry table behind the old entries of each cluster. Returns
        None if the cache is not a strict prefix, dims mismatch, or growth
        exceeds `max_grow` of the trained corpus. Spill (if the cache used
        it) applies to the new rows at the same fraction, thresholded on
        their own margin quantile."""
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

        _, dev = placement(mesh, device)
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
        return cls(vectors, n_clusters=n_clusters, dtype=dtype, mesh=mesh, axis=axis,
                   device=device, _precomputed=pre)

    # -- search ---------------------------------------------------------

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
        plain version; over a mesh, K11 on each shard's part of the probed
        clusters. `row_mask` ([n] bool over ORIGINAL row ids) restricts
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
        scan = ivf_probe_scan if self.mesh is None else self._sharded_scan
        s, pos = scan(self.matrix, q, qdig, row_scale, base, cnt,
                      k=k_fetch, cmax=self.cmax, int8=self._int8, mask_sorted=mask)
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

    def _sharded_scan(self, shards: Shards, q, qdig, row_scale, base, cnt, *, k: int,
                      cmax: int, int8: bool, mask_sorted=None):
        """`ivf_probe_scan` over the sorted matrix's shards: every shard
        scans its window [r0, r1) of each probed cluster (the cluster's
        range clipped to it: some have no rows there, others start before
        it) on its device, then the candidates merge on the index's device
        by (-score, probe rank, sorted row), the single-device order, as
        one int64 key (a product in int32 would overflow at 100M rows).
        Returns (scores [Q, k], sorted rows [Q, k], -1 past the
        candidates)."""
        cands, sent = [], {}
        for part, r0 in zip(shards.parts, shards.starts):
            dev, r1 = part.device, r0 + len(part)
            if r1 == r0:
                continue
            with on_device(dev):
                if dev not in sent:
                    sent[dev] = [None if t is None else t.to(dev)
                                 for t in (q, qdig, row_scale, base, cnt)]
                qd, dd, rd, bd, cd = sent[dev]
                lo = bd.clamp(r0, r1)
                hi = (bd + cd).clamp(r0, r1)
                s, lpos = ivf_probe_scan(
                    part, qd, dd, rd, (lo - r0).int(), (hi - lo).int(), k=k, cmax=cmax,
                    int8=int8, mask_sorted=None if mask_sorted is None
                    else mask_sorted[r0:r1].to(dev))
                cands.append((s, torch.where(lpos >= 0, lpos.long() + r0, -1)))
        s = torch.cat([c[0].to(self.device) for c in cands], 1)
        g = torch.cat([c[1].to(self.device) for c in cands], 1)
        b64, e64 = base.long()[:, None, :], (base + cnt).long()[:, None, :]
        rank = ((g[..., None] >= b64) & (g[..., None] < e64)).int().argmax(dim=2)
        key = torch.where(g >= 0, rank * (self.n_entries + 1) + g, torch.iinfo(torch.int64).max)
        cols = merge_order(s, key, k)
        return s.gather(1, cols), g.gather(1, cols).int()


def scatter_rows(dst, pos: torch.Tensor, x: torch.Tensor) -> None:
    """dst[pos] = x for a tensor or `Shards` (each shard takes the rows of
    its range, on its device)."""
    if not isinstance(dst, Shards):
        dst[pos.to(dst.device)] = x.to(dst.device)
        return
    for part, start in zip(dst.parts, dst.starts):
        sel = (pos >= start) & (pos < start + len(part))
        if bool(sel.any()):
            part[(pos[sel] - start).to(part.device)] = x[sel].to(part.device)


def _read_cache(path: str, shape: tuple):
    """(centroids, order, counts, n_spill) of a `save_cache` file whose
    rows and dim match `shape`, else None."""
    try:
        with np.load(path) as z:
            meta = z["meta"]
            if int(meta[0]) != shape[0] or int(meta[1]) != shape[1]:
                return None
            n_spill = int(meta[3]) if len(meta) > 3 else 0
            return z["centroids"], z["order"], z["counts"], n_spill
    except (OSError, KeyError, ValueError):
        return None
