"""Reverso: the engine facade, direct-embed and region paths.

The reference app's core loop: image folder -> (GroundingDINO + SAM
regions ->) PE-Core embeddings -> durable store -> exact cosine top-k.
Database management, `create_database` through the shared ingest
pipeline, `process_image_direct_pe`, `detect_regions`,
`extract_embeddings` (compat mode: each region carries its image's
global embedding, as the reference does; region mode: masked ROI pooling
of each region from one forward), `search_similar` (also through the
micro-batching searcher, `serve.py`), `search_batch`, `search_groups`,
`search_by_text`, `count` and the index routing of `_get_index` — the
exact index in bf16/fp32/int8 under every distance (cosine, dot, euclid,
manhattan), binary and product quantization with rescore, IVF, the host
index, multivector (MaxSim) spaces, sparse spaces (the host inverted
index), deleted vectors — the point and payload mutations
(`upsert_points`, `delete_points`, the payload mutators,
`update_vectors`, `delete_vectors`, `update_batch`, `index_payload`) and
the universal query (`query.py::UniversalQuery`) carry the JAX package's
method bodies and status strings; the models run in PyTorch and the
searches through the CUDA top-k and IVF kernels (euclid through the
top-k kernel on augmented rows; manhattan, PQ, MaxSim and the example
combines as plain PyTorch, as they were XLA in the JAX package).

Everything runs on one device: CUDA unless the caller asks for the CPU
(`device="cpu"`, or an encoder built on the CPU); `search.index="host"`
is the native host scan the user chose. With `use_mesh=True` the engine
makes a mesh over every visible CUDA device (`parallel.make_mesh` of
`config.mesh`, as the JAX engine does) and every index it builds
row-shards over it: each shard's scan on its card, the candidates merged
on the first (`parallel/sharding.py`).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional, Sequence

import numpy as np

from .config import EngineConfig, default_config
from .detect.regions import Regions, parse_prompts
from .ingest.images import preprocess_pil
from .ingest.pipeline import build_database, direct_pe_metadata, region_metadata
from .models.pe import PerceptionEncoder, resolve_device
from .parallel.sharding import make_mesh
from .query import UniversalQuery
from .store import (
    VectorStore, BinaryIndex, DeviceIndex, HostIndex, IVFIndex, MultiVecIndex, PQIndex,
    StoreError, StoreLockedError,
    list_databases as _list_databases,
    delete_database as _delete_database,
    unlock_database as _unlock_database,
)
from .store.index import default_pq_m, to_host
from .utils.logging import get_logger
from .utils.profiling import Metrics
from .viz import visualize_detections as _viz, render_result_thumbnail, to_rgb_array

log = get_logger("engine")


def load_or_build_ivf(store, vectors: np.ndarray, scfg, dtype: str,
                      *, space: str = "", mesh=None, device=None):
    """Load, extend, or build the store's IVF index for one vector
    space, persisting the k-means result next to the store.

    The cache is keyed on (space, clusters, count, mutation_epoch,
    spill, balance), in the JAX package's file names and format, so a
    cache written by either package serves the other. The epoch only
    moves when existing rows are rewritten (truncate), so a cache whose
    epoch matches but whose count is SMALLER covers an intact prefix —
    new rows are assigned to the cached centroids (extend) instead of
    retraining k-means."""
    count = store.count
    cache_dir = os.path.join(store.path, "index")
    sp = f"_sp{round(scfg.ivf_spill * 1000)}" if scfg.ivf_spill else ""
    if scfg.ivf_balance:
        sp += f"_b{round(scfg.ivf_balance * 100)}"
    stem = (f"ivf_{space}_c{scfg.ivf_clusters}" if space
            else f"ivf_c{scfg.ivf_clusters}")
    tail = f"_{store.mutation_epoch}{sp}.npz"
    cache = os.path.join(cache_dir, f"{stem}_{count}{tail}")
    ivf = None
    if os.path.exists(cache):
        ivf = IVFIndex.load_cache(vectors, cache, dtype=dtype, mesh=mesh, device=device)
    dirty = ivf is None
    if ivf is None and os.path.isdir(cache_dir):
        for f in sorted(os.listdir(cache_dir), reverse=True):
            # exactly the digit count between stem_ and tail: another
            # space whose name nests into this stem must not serve
            if (f.startswith(stem + "_") and f.endswith(tail)
                    and f[len(stem) + 1:-len(tail)].isdigit()):
                ivf = IVFIndex.extend_cache(
                    vectors, os.path.join(cache_dir, f), dtype=dtype,
                    mesh=mesh, device=device)
                if ivf is not None:
                    break
    if ivf is None:
        ivf = IVFIndex(vectors, n_clusters=min(scfg.ivf_clusters, count),
                       dtype=dtype, spill=scfg.ivf_spill,
                       balance=scfg.ivf_balance, mesh=mesh, device=device)
    if dirty:
        # prune only THIS config's stale caches (any count/epoch)
        def _same_cfg(f: str) -> bool:
            if not (f.startswith(stem + "_") and f.endswith(".npz")):
                return False
            parts = f[len(stem) + 1:-4].split("_", 2)
            if len(parts) < 2 or not (parts[0].isdigit()
                                      and parts[1].isdigit()):
                return False
            extra = parts[2] if len(parts) > 2 else ""
            return ("_" + extra if extra else "") == sp
        try:
            if os.path.isdir(cache_dir):
                for old in os.listdir(cache_dir):
                    if _same_cfg(old):
                        os.remove(os.path.join(cache_dir, old))
            ivf.save_cache(cache)
        except OSError:
            pass      # read-only store: rebuild per process
    return ivf


def load_or_build_pq(store, vectors: np.ndarray, scfg, *,
                     space: str = "", mesh=None, device=None):
    """Load, extend, or build the store's PQ index for one vector space,
    persisting the trained codebooks + codes next to the store, in the
    JAX package's file names and format (keyed on (space, m, count,
    mutation_epoch)); a cache with a SMALLER count at the same epoch
    covers an intact prefix, so appends encode only the tail instead of
    retraining k-means."""
    count = store.count
    dim = vectors.shape[1] if vectors.ndim == 2 and vectors.size else 0
    m = scfg.pq_m if scfg.pq_m > 0 else default_pq_m(dim)
    cache_dir = os.path.join(store.path, "index")
    stem = f"pq_{space}_m{m}" if space else f"pq_m{m}"
    tail = f"_{store.mutation_epoch}.npz"
    cache = os.path.join(cache_dir, f"{stem}_{count}{tail}")
    pqi = None
    if os.path.exists(cache):
        pqi = PQIndex.load_cache(vectors, cache, m=m, mesh=mesh, device=device)
    dirty = pqi is None
    if pqi is None and os.path.isdir(cache_dir):
        for f in sorted(os.listdir(cache_dir), reverse=True):
            # same digit-count guard as the IVF extend loop (space
            # names can nest into each other's stems)
            if (f.startswith(stem + "_") and f.endswith(tail)
                    and f[len(stem) + 1:-len(tail)].isdigit()):
                pqi = PQIndex.load_cache(
                    vectors, os.path.join(cache_dir, f), m=m, mesh=mesh, device=device)
                if pqi is not None:
                    break
    if pqi is None:
        pqi = PQIndex(vectors, m=m, mesh=mesh, device=device)
    if dirty:
        def _same_cfg(f: str) -> bool:
            return (f.startswith(stem + "_") and f.endswith(".npz")
                    and f[len(stem) + 1:-4].replace("_", "").isdigit())
        try:
            os.makedirs(cache_dir, exist_ok=True)
            for old in os.listdir(cache_dir):
                if _same_cfg(old):
                    os.remove(os.path.join(cache_dir, old))
            pqi.save_cache(cache)
        except OSError:
            pass      # read-only store: rebuild per process
    return pqi


class _IVFSearchAdapter:
    """DeviceIndex-shaped facade over IVFIndex (approximate mode).
    `impl` (SearchConfig.ivf_impl) names a TPU choice; a CUDA index
    launches the probed-scan kernel whatever it says."""

    def __init__(self, ivf, nprobe: int, impl: str = "auto"):
        self._ivf = ivf
        self.nprobe = nprobe
        self.impl = impl
        self.n_valid = ivf.n

    def search(self, queries, k: int, *, row_mask=None, **_):
        return self._ivf.search(queries, k, nprobe=self.nprobe,
                                impl=self.impl, row_mask=row_mask)


class _BinaryRescoreAdapter:
    """DeviceIndex-shaped facade over a quantized CANDIDATE index
    (BinaryIndex or PQIndex):
    oversampled packed scan on the device + exact f32 rescore of the
    candidates against the full-precision rows on the host — qdrant's
    quantization search semantics (`rescore`/`oversampling` params).
    Final results are the exact (-score, idx) order of the candidate set;
    with rescore disabled the raw proxy scores surface."""

    def __init__(self, bindex, vectors: np.ndarray, *,
                 oversampling: float = 3.0, rescore: bool = True):
        self._b = bindex
        self._v = vectors          # host f32 rows (mmap-backed is fine)
        self.oversampling = max(1.0, float(oversampling))
        self.rescore = rescore
        self.n_valid = bindex.n_valid
        self.dim = bindex.dim

    @property
    def nbytes(self) -> int:
        return self._b.nbytes

    def search(self, queries, k: int, *, row_mask=None, **_):
        import math as _math

        q = np.asarray(to_host(queries), np.float32)
        if q.ndim == 1:
            q = q[None]
        if self.n_valid == 0:
            return (np.full((len(q), k), -np.inf, np.float32),
                    np.full((len(q), k), -1, np.int32))
        k_fetch = min(max(k, int(_math.ceil(k * self.oversampling))),
                      self.n_valid)
        s, i = (to_host(a) for a in self._b.search(q, k_fetch, row_mask=row_mask))
        if not self.rescore:
            out_s = np.full((len(q), k), -np.inf, np.float32)
            out_i = np.full((len(q), k), -1, np.int32)
            w = min(k, k_fetch)
            out_s[:, :w] = s[:, :w]
            out_i[:, :w] = i[:, :w]
            return out_s, out_i
        safe = np.clip(i, 0, None)
        cand = np.asarray(self._v[safe.ravel()], np.float32) \
            .reshape(len(q), k_fetch, -1)                  # [Q, kf, d]
        scores = np.einsum("qkd,qd->qk", cand, q).astype(np.float32)
        scores[i < 0] = -np.inf
        tie_id = np.where(i < 0, np.iinfo(np.int32).max, i)
        order = np.lexsort((tie_id, -scores), axis=1)[:, :k]
        out_s = np.full((len(q), k), -np.inf, np.float32)
        out_i = np.full((len(q), k), -1, np.int32)
        w = order.shape[1]
        out_s[:, :w] = np.take_along_axis(scores, order, axis=1)
        out_i[:, :w] = np.take_along_axis(i, order, axis=1)
        out_i[np.isneginf(out_s)] = -1
        return out_s, out_i


class _PresenceMaskedIndex:
    """Facade over any dense index that excludes deleted vectors: the
    store records delete_vectors rows in a mask file
    (VectorStore.deleted_rows) and this wrapper folds the mask into every
    scan's `row_mask`, at the one choke point (_get_index), so plain
    search, the batcher, the example combines, prefetch branches, groups
    and MMR pools all see it. `best_score`/`discover`/`context` resolve
    through __getattr__, so hasattr() mirrors the wrapped index."""

    _COMBINE = ("best_score", "discover", "context")

    def __init__(self, index, presence: np.ndarray):
        self._ix = index
        self._presence = presence            # [count] bool, False = deleted

    def _and(self, row_mask):
        if row_mask is None:
            return self._presence
        m = np.array(row_mask, dtype=bool, copy=True)
        n = min(len(m), len(self._presence))
        m[:n] &= self._presence[:n]
        return m

    def search(self, queries, k: int, **kw):
        kw["row_mask"] = self._and(kw.get("row_mask"))
        return self._ix.search(queries, k, **kw)

    def __getattr__(self, name):
        inner = getattr(self._ix, name)      # AttributeError passes through
        if name in self._COMBINE:
            def call(*args, row_mask=None, **kw):
                return inner(*args, row_mask=self._and(row_mask), **kw)
            return call
        return inner


class Reverso(UniversalQuery):
    """Visual investigation engine: embed -> store -> search."""

    # "caller did not pass this" sentinel: distinguishes an EXPLICIT None
    # (a session whose query found nothing — must error, not fall back to
    # another session's engine state) from an omitted argument.
    _USE_ENGINE_STATE = object()

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 encoder: Optional[PerceptionEncoder] = None,
                 detector=None, text_embedder=None, use_mesh: bool = False,
                 device=None):
        self.config = config or default_config()
        # encoder is LAZY: store-only flows never pay the model build;
        # the device is settled now, so a machine without CUDA fails here
        # unless the caller asked for the CPU
        if device is None and encoder is not None:
            device = encoder.device
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.config.mesh) if use_mesh else None
        self._encoder = encoder
        self.detector = detector
        self.text_embedder = text_embedder
        # the last build's stage timers (`create_database` starts anew)
        self.metrics = Metrics()

        self._store: Optional[VectorStore] = None
        # per-vector-space device indexes: {space: (key, index)} with
        # key = (count, vector_version) — see _get_index
        self._indexes: dict = {}
        # host-side inverted indexes for SPARSE spaces, same key shape
        self._sparse_indexes: dict = {}
        self.current_database: Optional[str] = None

        # last query state (single-session convenience, like the reference)
        self.detected_regions: Optional[Regions] = None
        self.region_embeddings: Optional[np.ndarray] = None
        self.region_metadata_list: list[dict] = []

        self._filter_cols = None
        self._filter_cols_key = None
        self._stop_event = threading.Event()
        self._searcher = None
        self._searcher_lock = threading.Lock()
        # guards _indexes rebuild/assignment: the batcher's worker thread
        # calls _get_index concurrently with other callers, and two
        # simultaneous rebuilds would transiently hold 2x the index's
        # device memory
        self._index_lock = threading.Lock()

    @property
    def encoder(self) -> PerceptionEncoder:
        if self._encoder is None:
            self._encoder = PerceptionEncoder(self.config.model,
                                              device=self.device)
        return self._encoder

    # -- database management ---------------------------------------------

    @property
    def db_root(self) -> str:
        return self.config.store.root_dir

    def list_databases(self) -> list[str]:
        return _list_databases(self.db_root)

    def load_database(self, database_name: str) -> str:
        if not database_name:
            return "❌ Please provide a database name"
        from .store.persist import resolve_alias
        resolved = resolve_alias(self.db_root, database_name)
        try:
            store = VectorStore.open(self.db_root, resolved)
        except StoreError:
            if not os.path.isdir(os.path.join(self.db_root, resolved)):
                return f"❌ Database not found: {database_name}"
            return f"❌ Collection not found in database: {database_name}"
        self._set_store(store)
        if resolved != database_name:
            return (f"✅ Loaded database: {resolved} "
                    f"(alias {database_name})")
        return f"✅ Loaded database: {database_name}"

    def delete_database(self, database_name: str) -> str:
        if not database_name:
            return "❌ Please provide a database name"
        try:
            if self.current_database == database_name:
                self._set_store(None)
            _delete_database(self.db_root, database_name)
            return f"✅ Deleted database: {database_name}"
        except StoreLockedError:
            return (f"❌ Database '{database_name}' is locked (a build "
                    f"may be running); unlock it first")
        except StoreError:
            return f"❌ Database not found: {database_name}"
        except Exception as e:
            return f"❌ Error deleting database: {e}"

    def unlock_database(self, database_name: str) -> str:
        if not database_name:
            return "❌ Please provide a database name"
        try:
            removed = _unlock_database(self.db_root, database_name)
        except StoreError:
            return f"❌ Database not found: {database_name}"
        if removed:
            return f"✅ Removed lock file from database: {database_name}"
        return f"ℹ️ No lock file found for database: {database_name}"

    def _with_writable(self, fn):
        """Swap the read handle for a writable one, run `fn(writable)`,
        and ALWAYS reopen the read handle afterwards. Returns
        (error_message | None, fn_result | None). The device index is
        preserved across the swap whenever its (count, vector_version)
        key still holds — i.e. for payload-only mutations; anything
        that touched vectors bumps vector_version and rebuilds."""
        name = self.current_database
        with self._index_lock:
            saved = dict(self._indexes)
            saved_sp = dict(self._sparse_indexes)
        self._set_store(None)     # release the read handle before locking
        try:
            with VectorStore.open(self.db_root, name, writable=True) as w:
                result = fn(w)
        except StoreLockedError:
            return (f"❌ Database '{name}' is locked (a build may be "
                    f"running); unlock it first", None)
        except StoreError as e:
            return (f"❌ {e}", None)
        finally:
            try:
                store = VectorStore.open(self.db_root, name)
                self._set_store(store)
                live_key = (store.count, store.vector_version)
                keep = {sp: kv for sp, kv in saved.items()
                        if kv[0] == live_key}
                keep_sp = {sp: kv for sp, kv in saved_sp.items()
                           if kv[0] == live_key}
                if keep or keep_sp:
                    with self._index_lock:
                        self._indexes.update(keep)
                        self._sparse_indexes.update(keep_sp)
            except StoreError:
                pass
        return None, result

    def delete_points(self, filter=None, *, points=None) -> str:
        """Delete the selected rows — the delete role of qdrant's
        points API. Select via a payload `filter` (see `store.filter`)
        and/or `points` (row ids / `region_id` strings), same selector
        shape as the payload mutators. Rewrites the store via the
        crash-safe compaction pass (`VectorStore.compact`); the loaded
        handle and device index refresh to the compacted data."""
        from .store.filter import parse_filter, payload_mask

        if self._store is None:
            return "❌ No database loaded. Please create or load a database first."
        name = self.current_database
        has_filter = False
        try:
            if filter is not None and not parse_filter(filter).is_empty():
                has_filter = True
        except Exception as e:
            return f"❌ Bad filter: {e}"
        rows: set[int] = set()
        if points:
            rows.update(p["id"] for p in
                        self.retrieve(list(points), with_payload=False))
        if not rows and not has_filter:
            if points:
                return f"✅ Deleted 0 points from {name}"
            return ("❌ Refusing to delete with an empty selection "
                    "(use delete_database to drop everything)")

        def body(w):
            drop = np.zeros(w.count, bool)
            if has_filter:
                drop |= payload_mask(w, filter)
            if rows:
                idx = [r for r in rows if r < w.count]
                drop[idx] = True
            return w.compact(~drop)

        err, removed = self._with_writable(body)
        if err:
            return err
        return f"✅ Deleted {removed} points from {name}"

    def _mutate_payloads(self, mode: str, patch=None, keys=None, *,
                         points=None, filter=None) -> str:
        """Shared body of the payload mutation APIs: resolve the point
        selection (ids/region_ids and/or a payload filter), reopen the
        store writable, and run the crash-safe staged rewrite
        (`VectorStore.update_payloads`). Vectors and the device index
        are untouched."""
        from .store.filter import parse_filter, payload_mask

        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        name = self.current_database
        has_filter = False
        try:
            if filter is not None and not parse_filter(filter).is_empty():
                has_filter = True
        except Exception as e:
            return f"❌ Bad filter: {e}"
        rows: set[int] = set()
        if points:
            rows.update(p["id"] for p in
                        self.retrieve(list(points), with_payload=False))
        if not rows and not has_filter:
            return ("❌ Nothing selected: pass point ids and/or a "
                    "non-empty filter")

        # payload edits leave vectors untouched (vector_version holds
        # still), so _with_writable preserves the possibly multi-GB
        # device index instead of re-uploading
        def body(w):
            if has_filter:
                mask = payload_mask(w, filter)
                rows.update(np.nonzero(mask)[0].tolist())
            return w.update_payloads(sorted(rows), patch=patch,
                                     keys=keys, mode=mode)

        err, touched = self._with_writable(body)
        if err:
            return err
        verb = {"set": "Updated", "overwrite": "Overwrote",
                "delete": "Deleted keys on", "clear": "Cleared"}[mode]
        return f"✅ {verb} payload of {touched} points in {name}"

    def set_payload(self, patch: dict, *, points=None, filter=None) -> str:
        """Merge `patch` keys into the payloads of the selected points —
        qdrant's set_payload API role. Select via `points` (row ids
        and/or region_id strings) and/or a payload `filter`."""
        return self._mutate_payloads("set", patch=patch, points=points,
                                     filter=filter)

    def overwrite_payload(self, patch: dict, *, points=None,
                          filter=None) -> str:
        """Replace the whole payload of the selected points with `patch`
        — qdrant's overwrite payload API role."""
        return self._mutate_payloads("overwrite", patch=patch,
                                     points=points, filter=filter)

    def delete_payload(self, keys: Sequence[str], *, points=None,
                       filter=None) -> str:
        """Remove `keys` from the payloads of the selected points —
        qdrant's delete_payload API role."""
        return self._mutate_payloads("delete", keys=list(keys),
                                     points=points, filter=filter)

    def clear_payload(self, *, points=None, filter=None) -> str:
        """Empty the payloads of the selected points — qdrant's
        clear_payload API role."""
        return self._mutate_payloads("clear", points=points, filter=filter)

    def upsert_points(self, vectors, payloads=None) -> str:
        """Append raw points (vectors + payloads) to the loaded
        database — qdrant's upsert role for externally computed
        embeddings (the build pipeline is the model-driven path; this
        is the bring-your-own-vectors path). Vectors are L2-normalized
        here; dims must match the store. A store with NAMED vector
        spaces takes a `{space: [n, dim] array}` dict covering every
        space ('' = default). Row ids are assigned sequentially (the
        store is append-only — use delete_points / update_vectors /
        set_payload to mutate)."""
        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        name = self.current_database
        batch = dict(vectors) if isinstance(vectors, dict) \
            else {"": vectors}
        # SPARSE spaces travel in the same dict keyed by space name;
        # their rows are {"indices","values"} dicts, not arrays, and
        # are stored as-is (qdrant does not normalize sparse vectors).
        # MULTIVECTOR spaces likewise: rows are [T, d] matrices whose
        # sub-vectors ARE L2-normalized (cosine MaxSim).
        sparse_names = set(self._store.sparse)
        sparse_batch = {sp: list(batch.pop(sp))
                        for sp in list(batch) if sp in sparse_names}
        multi_batch = {}
        for sp in list(batch):
            if sp not in self._store.multi:
                continue
            rows = []
            for row in batch.pop(sp):
                if row is None:
                    rows.append(None)
                    continue
                m = np.asarray(row, np.float32)
                if m.ndim == 1:
                    m = m[None]
                norms = np.linalg.norm(m, axis=1, keepdims=True)
                if len(m) and not np.all(norms > 0):
                    return (f"❌ Zero sub-vectors in multivector space "
                            f"{sp!r} cannot be normalized")
                rows.append(m / np.maximum(norms, 1e-30))
            multi_batch[sp] = rows
        normed: dict = {}
        n = None
        cosine = self._store.distance == "cosine"
        for space, arr in batch.items():
            vecs = np.asarray(arr, np.float32)
            if vecs.ndim == 1:
                vecs = vecs[None]
            if n is None:
                n = len(vecs)
            elif len(vecs) != n:
                return (f"❌ space {space!r} has {len(vecs)} rows, "
                        f"expected {n}")
            if not cosine:
                # dot/euclid stores keep raw magnitudes — qdrant only
                # normalizes under Distance.COSINE
                normed[space] = vecs
                continue
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            if len(vecs) and not np.all(norms > 0):
                return "❌ Zero vectors cannot be normalized"
            normed[space] = vecs / np.maximum(norms, 1e-30)
        if n is None:
            return "❌ upsert needs vectors for the dense space(s)"
        for sp, rows in {**sparse_batch, **multi_batch}.items():
            if len(rows) != n:
                return (f"❌ space {sp!r} has {len(rows)} rows, "
                        f"expected {n}")
        if payloads is None:
            payloads = [{} for _ in range(n)]
        payloads = list(payloads)
        if len(payloads) != n:
            return f"❌ {n} vectors but {len(payloads)} payloads"
        if n == 0:
            return "✅ Upserted 0 points"
        arg = normed if isinstance(vectors, dict) else normed[""]

        def body(w):
            first = w.count
            w.append(arg, payloads, sparse_batch or None,
                     multi_batch or None)
            return first

        err, first = self._with_writable(body)
        if err:
            return err
        return (f"✅ Upserted {n} points into {name} "
                f"(ids {first}..{first + n - 1})")

    def update_vectors(self, points, vectors, *, using: str = "") -> str:
        """Overwrite the stored vectors of specific points — qdrant's
        update_vectors API role. `points` mixes row ids and region_id
        strings (order-aligned with `vectors` rows); vectors are
        L2-normalized here (the store holds unit fp32 rows); `using`
        selects a named vector space ('' = default). The device index
        refreshes on next search (vector content actually changed),
        and the IVF cache retrains (prefix immutability is broken by
        an in-place rewrite)."""
        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        name = self.current_database
        points = list(points)
        if using and using in self._store.sparse:
            # sparse side: `vectors` is a list of {"indices","values"}
            # rows (stored as-is; staged-rewrite journal in the store)
            rows_new = list(vectors)
            if len(points) != len(rows_new):
                return (f"❌ {len(points)} point ids but "
                        f"{len(rows_new)} sparse vectors")
            pts = self.retrieve(points, with_payload=False)
            if len(pts) != len(points):
                return (f"❌ Unknown point id(s): resolved {len(pts)} "
                        f"of {len(points)}")
            err, touched = self._with_writable(
                lambda w: w.update_sparse_vectors(
                    [p["id"] for p in pts], rows_new, using))
            if err:
                return err
            return f"✅ Updated vectors of {touched} points in {name}"
        if using and using in self._store.multi:
            # multivector side: [T, d] matrices, sub-vectors normalized
            rows_new = []
            for row in vectors:
                if row is None:
                    rows_new.append(None)
                    continue
                m = np.asarray(row, np.float32)
                if m.ndim == 1:
                    m = m[None]
                norms = np.linalg.norm(m, axis=1, keepdims=True)
                if len(m) and not np.all(norms > 0):
                    return "❌ Zero sub-vectors cannot be normalized"
                rows_new.append(m / np.maximum(norms, 1e-30))
            if len(points) != len(rows_new):
                return (f"❌ {len(points)} point ids but "
                        f"{len(rows_new)} multivectors")
            pts = self.retrieve(points, with_payload=False)
            if len(pts) != len(points):
                return (f"❌ Unknown point id(s): resolved {len(pts)} "
                        f"of {len(points)}")
            err, touched = self._with_writable(
                lambda w: w.update_multivectors(
                    [p["id"] for p in pts], rows_new, using))
            if err:
                return err
            return f"✅ Updated vectors of {touched} points in {name}"
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if len(points) != len(vecs):
            return (f"❌ {len(points)} point ids but {len(vecs)} "
                    f"vectors")
        pts = self.retrieve(points, with_payload=False)
        if len(pts) != len(points):
            known = len(pts)
            return (f"❌ Unknown point id(s): resolved {known} of "
                    f"{len(points)}")
        rows = [p["id"] for p in pts]
        if self._store.distance == "cosine":
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            if not np.all(norms > 0):
                return "❌ Zero vectors cannot be normalized"
            vecs = vecs / norms
        err, touched = self._with_writable(
            lambda w: w.update_vectors(rows, vecs, space=using))
        if err:
            return err
        return f"✅ Updated vectors of {touched} points in {name}"

    def delete_vectors(self, points=None, spaces="", *,
                       filter=None) -> str:
        """Remove specific vectors from points WITHOUT deleting the
        points — qdrant's delete_vectors API role (the points keep
        their payloads and every other space; the reference app's
        single-vector collection had no analog, core_system.py:600-622).
        Select via `points` (row ids / region_id strings, unknown ids
        skipped like delete_points) and/or a payload `filter`; `spaces`
        is one space name or a list ('' = the default dense space).
        Dense deletions are mask-based (VectorStore.delete_vector_rows:
        every scan excludes the rows exactly, `has_vector` turns
        False, a later update_vectors resurrects); sparse/multivector
        deletions rewrite the ragged row empty through the staged
        journal."""
        from .store.filter import parse_filter, payload_mask

        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        name = self.current_database
        store = self._store
        if isinstance(spaces, str):
            spaces = [spaces]
        spaces = list(dict.fromkeys(spaces))
        if not spaces:
            return "❌ delete_vectors needs at least one vector space"
        unknown = [s for s in spaces
                   if s not in store.spaces() and s not in store.sparse
                   and s not in store.multi]
        if unknown:
            return (f"❌ Unknown vector space(s) "
                    f"{sorted(unknown)} (have "
                    f"{sorted(store.spaces()) + sorted(store.sparse) + sorted(store.multi)})")
        has_filter = False
        try:
            if filter is not None and not parse_filter(filter).is_empty():
                has_filter = True
        except Exception as e:
            return f"❌ Bad filter: {e}"
        rows: set = set()
        if points:
            rows.update(p["id"] for p in
                        self.retrieve(list(points), with_payload=False))
        if not points and not has_filter:
            return "❌ delete_vectors needs points and/or a filter"

        def body(w):
            sel = set(rows)
            if has_filter:
                w.flush()
                sel.update(np.nonzero(payload_mask(w, filter))[0].tolist())
            rl = sorted(sel)
            if not rl:
                return 0
            for s in spaces:
                if s in w.sparse:
                    w.update_sparse_vectors(rl, [None] * len(rl), s)
                elif s in w.multi:
                    w.update_multivectors(rl, [None] * len(rl), s)
                else:
                    w.delete_vector_rows(rl, s)
            return len(rl)

        err, touched = self._with_writable(body)
        if err:
            return err
        labels = ", ".join(repr(s) for s in spaces)
        return (f"✅ Deleted vectors ({labels}) of {touched} points "
                f"in {name}")

    _BATCH_OPS = ("upsert", "delete", "set_payload", "overwrite_payload",
                  "delete_payload", "clear_payload", "update_vectors",
                  "delete_vectors")

    def update_batch(self, operations) -> str:
        """Apply an ordered list of point mutations in ONE writable
        session — qdrant's batch-update API role (client
        `batch_update_points`; the reference only ever upserted,
        core_system.py:608-622). Each element is a one-key dict:

          {"upsert": {"vectors": [[..]], "payloads": [dict,..]|None}}
          {"delete": {"points": [..], "filter": spec}}   # either/both
          {"set_payload": {"payload": {..}, "points": .., "filter": ..}}
          {"overwrite_payload": {"payload": {..}, "points"/"filter"}}
          {"delete_payload": {"keys": [..], "points"/"filter"}}
          {"clear_payload": {"points": .., "filter": ..}}
          {"update_vectors": {"points": [..], "vectors": [[..]]}}
          {"delete_vectors": {"points"/"filter", "spaces": [..]}}

        The whole request validates up front (a malformed op rejects
        the batch before anything is touched), then ops apply strictly
        in order against the intermediate store state: integer row ids
        refer to the state AT THAT STEP — a preceding delete renumbers
        rows, so use region_id strings for cross-op stability. The
        read handle reopens (and the device index refreshes, if any op
        touched vectors) once, after the whole batch. Selector
        resolution inside the batch can't miss an op's own effects —
        unknown ids in delete/payload selectors are skipped (qdrant
        semantics), but `update_vectors` requires every id to resolve.
        Each op commits through its own crash-safe journal; a mid-batch
        failure keeps the ops already applied (same per-op durability
        as qdrant's batch, which is ordered but not transactional)."""
        from .store.filter import PayloadColumns, parse_filter, payload_mask

        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        name = self.current_database
        dim = self._store.dim

        cosine = self._store.distance == "cosine"

        def unit_rows(i: int, raw) -> np.ndarray:
            vecs = np.asarray(raw, np.float32)
            if vecs.ndim == 1:
                vecs = vecs[None]
            if vecs.ndim != 2 or vecs.shape[1] != dim:
                raise ValueError(f"op #{i}: vectors must be [n, {dim}], "
                                 f"got {vecs.shape}")
            if not cosine:      # dot/euclid: raw magnitudes are kept
                return vecs
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            if not np.all(norms > 0):
                raise ValueError(f"op #{i}: zero vectors cannot be "
                                 "normalized")
            return vecs / norms

        ops: list[tuple[str, dict]] = []
        try:
            for i, op in enumerate(list(operations)):
                if not isinstance(op, dict) or len(op) != 1:
                    raise ValueError(f"op #{i}: expected a one-key dict")
                kind, body = next(iter(op.items()))
                if kind not in self._BATCH_OPS:
                    raise ValueError(f"op #{i}: unknown operation "
                                     f"{kind!r} (one of "
                                     f"{', '.join(self._BATCH_OPS)})")
                if body is None:
                    body = {}
                if not isinstance(body, dict):
                    raise ValueError(f"op #{i}: {kind} body must be a dict")
                known = {"upsert": {"vectors", "payloads"},
                         "delete": {"points", "filter"},
                         "set_payload": {"payload", "points", "filter"},
                         "overwrite_payload": {"payload", "points",
                                               "filter"},
                         "delete_payload": {"keys", "points", "filter"},
                         "clear_payload": {"points", "filter"},
                         "update_vectors": {"points", "vectors"},
                         "delete_vectors": {"points", "filter",
                                            "spaces"}}[kind]
                extra = set(body) - known
                if extra:
                    raise ValueError(f"op #{i}: unknown {kind} key(s) "
                                     f"{sorted(extra)}")
                spec = body.get("filter")
                has_filter = (spec is not None
                              and not parse_filter(spec).is_empty())
                points = list(body.get("points") or [])
                b: dict = {"points": points, "filter": spec,
                           "has_filter": has_filter}
                if kind == "upsert":
                    b["vectors"] = unit_rows(i, body.get("vectors"))
                    pls = body.get("payloads")
                    pls = ([{} for _ in range(len(b["vectors"]))]
                           if pls is None else list(pls))
                    if len(pls) != len(b["vectors"]):
                        raise ValueError(
                            f"op #{i}: {len(b['vectors'])} vectors but "
                            f"{len(pls)} payloads")
                    if not all(isinstance(p, dict) for p in pls):
                        raise ValueError(f"op #{i}: payloads must be dicts")
                    b["payloads"] = pls
                elif kind == "update_vectors":
                    b["vectors"] = unit_rows(i, body.get("vectors"))
                    if len(points) != len(b["vectors"]):
                        raise ValueError(
                            f"op #{i}: {len(points)} point ids but "
                            f"{len(b['vectors'])} vectors")
                elif kind in ("set_payload", "overwrite_payload"):
                    if not isinstance(body.get("payload"), dict):
                        raise ValueError(f"op #{i}: {kind} needs a "
                                         "'payload' dict")
                    b["payload"] = body["payload"]
                elif kind == "delete_payload":
                    b["keys"] = list(body.get("keys") or [])
                    if not b["keys"]:
                        raise ValueError(f"op #{i}: delete_payload needs "
                                         "keys")
                elif kind == "delete_vectors":
                    sp = body.get("spaces", "")
                    sp = [sp] if isinstance(sp, str) else list(sp)
                    if "spaces" in body and not sp:
                        # an explicitly empty list is a mistake, not a
                        # request for the default space — match the
                        # public Reverso.delete_vectors rejection
                        raise ValueError(f"op #{i}: delete_vectors "
                                         "needs at least one vector "
                                         "space")
                    sp = list(dict.fromkeys(sp)) or [""]
                    bad_sp = [s for s in sp
                              if s not in self._store.spaces()
                              and s not in self._store.sparse
                              and s not in self._store.multi]
                    if bad_sp:
                        raise ValueError(f"op #{i}: unknown vector "
                                         f"space(s) {sorted(bad_sp)}")
                    b["spaces"] = sp
                if kind in ("delete", "set_payload", "overwrite_payload",
                            "delete_payload", "clear_payload",
                            "delete_vectors") \
                        and not points and not has_filter:
                    raise ValueError(f"op #{i}: {kind} needs points "
                                     "and/or a non-empty filter")
                ops.append((kind, b))
        except Exception as e:
            return f"❌ Bad batch: {e}"
        if not ops:
            return "✅ Applied 0 operations"

        def resolve(w, points) -> list:
            """Row for each selector (None if unknown) against the
            CURRENT writable state; region_id duplicates keep-first,
            matching `retrieve`."""
            view = None
            out = []
            for p in points:
                if isinstance(p, str):
                    if view is None:
                        w.flush()
                        view = PayloadColumns(w).view("region_id")
                    code = view.uindex.get(p, -2)
                    r = None
                    if code >= 0:
                        hits = np.nonzero(view.codes == code)[0]
                        if hits.size:
                            r = int(hits[0])
                    out.append(r)
                else:
                    r = int(p)
                    out.append(r if 0 <= r < w.count else None)
            return out

        applied: list[str] = []

        def body_fn(w):
            mode = {"set_payload": "set", "overwrite_payload": "overwrite",
                    "delete_payload": "delete", "clear_payload": "clear"}
            for n, (kind, b) in enumerate(ops):
                if kind == "upsert":
                    w.append(b["vectors"], b["payloads"])
                    applied.append(f"upsert {len(b['vectors'])}")
                    continue
                if kind == "update_vectors":
                    rows = resolve(w, b["points"])
                    if any(r is None for r in rows):
                        bad = [p for p, r in zip(b["points"], rows)
                               if r is None]
                        raise StoreError(f"op #{n}: unknown point id(s) "
                                         f"{bad[:5]}")
                    touched = w.update_vectors(rows, b["vectors"])
                    applied.append(f"update_vectors {touched}")
                    continue
                rows = {r for r in resolve(w, b["points"]) if r is not None}
                if b["has_filter"]:
                    w.flush()
                    rows.update(np.nonzero(
                        payload_mask(w, b["filter"]))[0].tolist())
                if kind == "delete":
                    drop = np.zeros(w.count, bool)
                    drop[sorted(rows)] = True
                    removed = w.compact(~drop) if rows else 0
                    applied.append(f"delete {removed}")
                elif kind == "delete_vectors":
                    rl = sorted(rows)
                    for s in b["spaces"]:
                        if not rl:
                            break
                        if s in w.sparse:
                            w.update_sparse_vectors(rl, [None] * len(rl), s)
                        elif s in w.multi:
                            w.update_multivectors(rl, [None] * len(rl), s)
                        else:
                            w.delete_vector_rows(rl, s)
                    applied.append(f"delete_vectors {len(rl)}")
                else:
                    touched = w.update_payloads(
                        sorted(rows), patch=b.get("payload"),
                        keys=b.get("keys"), mode=mode[kind]) if rows else 0
                    applied.append(f"{kind} {touched}")
            return len(ops)

        err, n = self._with_writable(body_fn)
        if err:
            return err
        return (f"✅ Applied {n} operations to {name} "
                f"({'; '.join(applied)})")

    def _set_store(self, store: Optional[VectorStore]) -> None:
        with self._index_lock:
            self._store = store
            self._indexes = {}
            self._sparse_indexes = {}
        self.current_database = store.name if store else None

    def _get_index(self, using: str = ""):
        # Read the handle ONCE so a concurrent load/delete cannot swap it
        # mid-call.
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        # Key on (count, vector_version), not count alone: a truncate-then-
        # reappend to the same size must not serve stale device vectors,
        # while payload-only edits never trigger a re-upload. refresh()
        # makes external mutations visible through this read-only handle.
        store.refresh()
        using = using or ""
        key = (store.count, store.vector_version)
        cached = self._indexes.get(using)
        if cached is not None and cached[0] == key:
            return cached[1]
        with self._index_lock:
            # re-check under the lock: a concurrent caller may have just
            # rebuilt; two rebuilds would each stage the matrix on device
            cached = self._indexes.get(using)
            if cached is not None and cached[0] == key:
                return cached[1]
            if using in store.sparse:
                raise StoreError(
                    f"vector space {using!r} is sparse — only plain "
                    f"search and universal-query branches support "
                    f"sparse spaces")
            if using in store.multi:
                # MaxSim over the flat sub-vector matrix (ops/multivec.py);
                # "binary"/"pq"/"int8" are modes of the DENSE index, so the
                # MaxSim matrix is bf16 for them
                subs, indptr = store.multivectors(using)
                mv_dtype = self.config.store.dtype
                if mv_dtype in ("binary", "pq", "int8"):
                    mv_dtype = "bfloat16"
                index = MultiVecIndex(np.asarray(subs), indptr, dtype=mv_dtype,
                                      mesh=self.mesh, device=self.device)
                self._indexes[using] = (key, index)
                return index
            if using not in store.spaces():
                raise StoreError(
                    f"unknown vector space {using!r} (have "
                    f"{sorted(store.spaces()) + sorted(store.sparse) + sorted(store.multi)})")
            scfg = self.config.search
            dtype = self.config.store.dtype
            count = store.count
            vectors = np.asarray(store.vectors(using))
            if scfg.index == "host":
                # the native C++ host scan, the index the user chose for
                # deployments without a card
                index = HostIndex(vectors, distance=store.distance)
            elif (scfg.index == "ivf" and store.distance in ("cosine", "dot")
                    and count > scfg.ivf_clusters * 4):
                # IVF probes dense clusters: "binary" and "pq" are modes
                # of the exact index, not IVF cell dtypes — coerce to bf16.
                # Euclid/manhattan have no IVF form: the exact index
                ivf_dtype = "bfloat16" if dtype in ("binary", "pq") else dtype
                ivf = load_or_build_ivf(store, vectors, scfg, ivf_dtype,
                                        space=using, mesh=self.mesh, device=self.device)
                index = _IVFSearchAdapter(ivf, scfg.ivf_nprobe,
                                          impl=scfg.ivf_impl)
            elif dtype == "binary":
                # packed candidate scan + exact f32 rescore of the top
                # oversampling*k ids against the on-disk rows
                if store.distance in ("euclid", "manhattan"):
                    raise StoreError(
                        "binary quantization ranks by sign dots — it "
                        "needs a cosine or dot store (this store's "
                        f"distance is {store.distance})")
                index = _BinaryRescoreAdapter(
                    BinaryIndex(vectors, mesh=self.mesh, device=self.device), vectors,
                    oversampling=scfg.binary_oversampling,
                    rescore=scfg.binary_rescore)
            elif dtype == "pq":
                # learned-codebook candidate scan + the same exact f32
                # rescore; codebooks/codes persist next to the store
                if store.distance in ("euclid", "manhattan"):
                    raise StoreError(
                        "product quantization ranks by codebook dots — "
                        "it needs a cosine or dot store (this store's "
                        f"distance is {store.distance})")
                pqi = load_or_build_pq(store, vectors, scfg, space=using,
                                       mesh=self.mesh, device=self.device)
                index = _BinaryRescoreAdapter(
                    pqi, vectors, oversampling=scfg.pq_oversampling,
                    rescore=scfg.pq_rescore)
            else:
                index = DeviceIndex(vectors, mesh=self.mesh, dtype=dtype,
                                    distance=store.distance,
                                    device=self.device,
                                    int8_quantile=scfg.int8_quantile)
            gone = store.deleted_rows(using)
            if gone.size:
                # per-point delete_vectors mask, folded into every scan
                # (a delete bumps vector_version, so this entry rebuilds)
                presence = np.ones(count, np.bool_)
                presence[gone] = False
                index = _PresenceMaskedIndex(index, presence)
            self._indexes[using] = (key, index)
            return index

    def _get_sparse_index(self, space: str):
        """Cached host-side inverted index for a SPARSE vector space
        (keyed like _get_index; sparse scoring is host-native — see
        store/sparse.py)."""
        from .store import SparseIndex

        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        if space not in store.sparse:
            raise StoreError(f"unknown sparse vector space {space!r} "
                             f"(have {sorted(store.sparse)})")
        key = (store.count, store.vector_version)
        cached = self._sparse_indexes.get(space)
        if cached is not None and cached[0] == key:
            return cached[1]
        with self._index_lock:
            cached = self._sparse_indexes.get(space)
            if cached is not None and cached[0] == key:
                return cached[1]
            index = SparseIndex.from_store(store, space)
            self._sparse_indexes[space] = (key, index)
            return index

    def _presence_and(self, mask, using: str = ""):
        """AND the dense delete_vectors presence of `using` into a row
        mask. Scans get this via _PresenceMaskedIndex; this helper is
        for the paths that pick rows WITHOUT scanning (random sampling,
        search_matrix) — a point whose vector was deleted must not be
        sampled in that space. Returns None unchanged when nothing is
        deleted (the no-mask fast paths stay intact)."""
        store = self._store
        if store is None or using not in store.spaces():
            return mask
        gone = store.deleted_rows(using)
        if not gone.size:
            return mask
        m = (np.ones(store.count, np.bool_) if mask is None
             else np.array(mask, dtype=bool, copy=True))
        m[gone[gone < len(m)]] = False
        return m

    def _drop_deleted(self, cand: list, using: str = "") -> list:
        """Drop candidate row ids whose `using` vector was deleted via
        delete_vectors. The exact-rescore / MMR prefetch-union paths
        read `store.vectors(using)[cand]` directly (no index, no
        presence mask), so a cross-space prefetch could otherwise score
        a deleted point with its stale on-disk bytes — qdrant skips a
        point with no vector in the rescoring space."""
        store = self._store
        if store is None or using not in store.spaces():
            return cand
        gone = store.deleted_rows(using)
        if not gone.size:
            return cand
        gone_set = set(int(g) for g in gone)
        return [c for c in cand if int(c) not in gone_set]

    def _payload_columns(self):
        """Cached columnar payload view for the loaded store, keyed on
        (count, data_version): filters against an unchanged store evaluate
        in vectorized numpy with no IO."""
        from .store.filter import PayloadColumns

        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        key = (store.count, store.data_version)
        with self._index_lock:
            if self._filter_cols is None or self._filter_cols_key != key:
                self._filter_cols = PayloadColumns(store)
                self._filter_cols_key = key
            return self._filter_cols

    @staticmethod
    def _payloads_with(store, ids, with_payload):
        """Payloads for `ids` under a qdrant with_payload selector:
        bool, key string/list (include shorthand), or
        {"include"|"exclude": [paths]} — the PayloadSelector role
        (store.filter.compile_payload_selector). Malformed selectors
        raise before any store IO (FilterError -> UI 400)."""
        from .store.filter import compile_payload_selector

        sel = compile_payload_selector(with_payload)
        if sel is False:
            return [None] * len(ids)
        pays = store.payloads(ids)
        return pays if sel is True else [sel(p) for p in pays]

    def _filter_mask(self, filter_spec) -> Optional[np.ndarray]:
        """Evaluate a payload filter (dict/string/Filter; see
        `store.filter`) against the loaded store -> [count] bool mask.
        Returns None for an empty filter."""
        from .store.filter import evaluate_filter, parse_filter

        filt = parse_filter(filter_spec)
        if filt.is_empty():
            return None
        cols = self._payload_columns()
        cols.ensure(sorted(filt.keys()))
        return evaluate_filter(filt, cols)

    def index_payload(self, keys: Sequence[str], *,
                      text: bool = False) -> str:
        """Extract + persist typed column views for `keys` — the
        create_payload_index role of qdrant's API. Later processes
        mmap-load the arrays instead of streaming the whole JSONL, so
        their first filtered search / facet / order_by is instant.
        (Big stores auto-persist keys on first use; this is the
        explicit, guard-free version.) With `text=True` it also builds
        and persists the full-text inverted index for those keys
        (qdrant's field_schema="text" index, store/text.py), so
        text/phrase matches skip per-unique tokenization in every
        later process."""
        if self._store is None:
            return ("❌ No database loaded. Please create or load a "
                    "database first.")
        keys = [str(k) for k in keys]
        if not keys:
            return "❌ No payload keys given"
        cols = self._payload_columns()
        cols.ensure(keys)
        path = (cols.persist_text(keys) if text
                else cols.persist(keys, force=True))
        if path is None:
            return "❌ Could not write the column cache (read-only dir?)"
        kind = "text-indexed" if text else "Indexed"
        return (f"✅ {kind} payload keys {', '.join(keys)} "
                f"({os.path.basename(path)})")

    def count(self, filter=None) -> int:
        """Number of stored points, optionally restricted to a payload
        filter (qdrant's count API role)."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        mask = self._filter_mask(filter) if filter is not None else None
        return store.count if mask is None else int(mask.sum())

    # -- serving ----------------------------------------------------------

    @property
    def searcher(self):
        """Micro-batching search front-end (`serve.BatchingSearcher`).

        Coalesces concurrent callers' queries into single device
        launches; created lazily, bound to `_get_index` so store
        rebuilds are picked up per launch. Callers must not run
        concurrently with a build on the same engine (the UI's build
        guard enforces that)."""
        if self._searcher is None:
            # Creation must be locked: concurrent first callers would each
            # build a private searcher and nothing would ever coalesce.
            with self._searcher_lock:
                if self._searcher is None:
                    from .serve import BatchingSearcher
                    self._searcher = BatchingSearcher(self._get_index)
        return self._searcher

    def warmup(self, *, include_detector: bool = False) -> str:
        """Run the serving path once (embed, the search through the
        batcher, and optionally the detector) so the first real request
        pays neither the kernels' build at first use nor the device
        index's upload. Call after load_database; idempotent."""
        size = self.config.model.image_size
        warmed = []
        np.asarray(self.encoder.encode_image(
            np.zeros((1, size, size, 3), np.float32)))
        warmed.append("encoder")
        if self._store is not None and self._store.count > 0:
            # Warm THROUGH the batcher: its launches pad k to a multiple
            # of 8 and bucket the batch to a power of two, so a single
            # queued request launches as (bucket=1, k_pad), exactly the
            # steady-state low-traffic shape, and the index the batcher
            # reads is the one uploaded here.
            self.searcher.search(
                np.zeros(self.encoder.embed_dim, np.float32),
                k=self.config.search.top_k, timeout=900.0)
            warmed.append("search")
        if include_detector and self.detector is not None:
            self.detector.detect(np.zeros((64, 64, 3), np.uint8),
                                 ["object"])
            warmed.append("detector")
        return "warmed: " + ", ".join(warmed)

    # -- query path -------------------------------------------------------

    def search_batch(self, embeddings, k: Optional[int] = None, *,
                     filter=None, using: str = ""):
        """Bulk search: [B, d] query embeddings in ONE kernel launch.

        Returns host arrays (scores [B, k], ids [B, k]) with the usual
        (-score, idx) order and -1 padding. `filter` restricts results to
        rows whose payload matches (see `store.filter` for the
        qdrant-shaped spec); filtered scans are exact over the matching
        subset. `using` selects a named vector space ('' = default)."""
        k = self.config.search.top_k if k is None else int(k)
        q = np.asarray(embeddings, np.float32)
        if q.ndim == 1:
            q = q[None]
        mask = self._filter_mask(filter) if filter is not None else None
        scores, ids = self._get_index(using).search(q, k, row_mask=mask)
        return to_host(scores), to_host(ids)

    def _preprocess(self, image) -> tuple[np.ndarray, tuple[int, int]]:
        from PIL import Image as PILImage
        arr = to_rgb_array(image)
        h, w = arr.shape[:2]
        px = preprocess_pil(PILImage.fromarray(arr), self.config.model.image_size)
        return px[None], (w, h)

    def process_image_direct_pe(self, image):
        """Whole-image embedding of one image."""
        px, (w, h) = self._preprocess(image)
        emb = np.asarray(self.encoder.encode_image(px))
        meta = direct_pe_metadata(w, h)
        self.detected_regions = None
        self.region_embeddings = emb
        self.region_metadata_list = [meta]
        return emb, [meta]

    def detect_regions(self, image, text_prompt: Optional[str] = None) -> int:
        """Prompt-conditioned region detection (reference core_system.py:237-318)."""
        if self.detector is None:
            raise RuntimeError(
                "no detector configured; construct Reverso(detector=...) or "
                "use process_image_direct_pe")
        prompts = parse_prompts(text_prompt, self.config.detector.default_prompt)
        arr = to_rgb_array(image)
        self.detected_regions = self.detector.detect(arr, prompts)
        self.region_embeddings = None
        self.region_metadata_list = []
        log.info(f"found {len(self.detected_regions)} regions for prompts {prompts}")
        return len(self.detected_regions)

    def extract_embeddings(self, image):
        """Embed detected regions (reference core_system.py:320-429).

        ingest.region_embed_mode selects "compat" (every region carries
        the global image embedding, exactly what the reference does,
        core_system.py:406) or "region" (masked ROI pooling)."""
        regions = self.detected_regions
        if regions is None or len(regions) == 0:
            return [], []
        px, (w, h) = self._preprocess(image)
        n = min(len(regions), self.config.ingest.max_regions)
        use_roi = (self.config.ingest.region_embed_mode == "region"
                   and regions.masks is not None and n > 0)
        if use_roi:
            # masks pool onto the patch grid on the host; the region count
            # pads to a power of two, the bucket the batched ingest uses
            rb = 1 << (n - 1).bit_length()
            pooled = self.encoder.pool_masks([regions.masks[:n]], rb)
            _, region_embs = self.encoder.encode_regions(px, pooled)
            region_embs = np.asarray(region_embs)[0][:n]
        else:
            emb = np.asarray(self.encoder.encode_image(px))[0]
        vecs, metas = [], []
        for i in range(n):
            meta = region_metadata(regions, i)
            if meta is None:
                continue
            if meta["bbox"] is None:
                meta["bbox"] = [0, 0, w, h]
            vecs.append(region_embs[i] if use_roi else emb)
            metas.append(meta)
        self.region_embeddings = (np.stack(vecs) if vecs
                                  else np.zeros((0, self.encoder.embed_dim),
                                                np.float32))
        self.region_metadata_list = metas
        return list(self.region_embeddings), metas

    def search_similar(self, similarity_threshold: Optional[float] = None,
                       max_results: Optional[int] = None,
                       query_index: int = 0, *,
                       embeddings=_USE_ENGINE_STATE,
                       use_batcher: bool = False,
                       filter=None, using: str = ""):
        """Search the loaded database with a previously extracted
        embedding. Returns (text, items).

        `embeddings` overrides the engine's last-query state with an
        explicit [R, d] array, making the call stateless. `use_batcher`
        routes the launch through the micro-batching searcher so
        concurrent searches coalesce. `filter` (dict/string; see
        `store.filter`) restricts results to rows whose payload matches,
        e.g. `{"folder": 3}` or `"confidence>=0.5"`; filtered searches
        launch directly (masks do not coalesce in the batcher)."""
        cfg = self.config.search
        threshold = cfg.score_threshold if similarity_threshold is None else similarity_threshold
        k = cfg.top_k if max_results is None else max_results
        # explicit None must NOT fall back to the engine singleton
        embs = (self.region_embeddings
                if embeddings is Reverso._USE_ENGINE_STATE
                else (None if embeddings is None
                      else np.asarray(embeddings)))
        if embs is None or len(embs) == 0:
            return ("❌ No query embeddings available. Please detect/process an image first.", [])
        store = self._store    # single read: see _get_index
        if store is None:
            return ("❌ No database loaded. Please create or load a database first.", [])
        query_index = min(query_index, len(embs) - 1)
        query = embs[query_index]

        mask = self._filter_mask(filter) if filter is not None else None
        if mask is None and use_batcher and k <= 128:
            # k > 128 exceeds the batcher's k cap: a direct index search
            # instead of silently truncating results
            scores, ids = self.searcher.search(query, k, space=using)
        else:
            scores, ids = self._get_index(using).search(query, k, row_mask=mask)
            scores, ids = to_host(scores)[0], to_host(ids)[0]
        hits = [(float(s), int(i)) for s, i in zip(scores, ids)
                if i >= 0 and s >= threshold]
        if not hits:
            return (f"❌ No similar regions found above threshold {threshold}", [])
        return self._render_hits(hits, store)

    def _render_hits(self, hits, store):
        """[(score, row_id)] -> the (text, items) result shape the UI
        renders."""
        payloads = store.payloads([i for _, i in hits])
        text = f"🎯 Found {len(hits)} similar regions:\n\n"
        items = []
        for rank, ((score, row_id), payload) in enumerate(zip(hits, payloads)):
            payload = payload or {}
            filename = payload.get("filename", "Unknown")
            image_path = payload.get("image_source", "")
            bbox = payload.get("bbox", [0, 0, 0, 0])
            text += f"{rank + 1}. {filename} (Similarity: {score:.3f})\n"
            text += f"   Source: {image_path}\n"
            text += f"   📍 Bounding box: {bbox}\n\n"
            thumb = render_result_thumbnail(image_path, score) if image_path else None
            items.append({"image": thumb, "score": score, "id": row_id,
                          "filename": filename, "bbox": bbox,
                          "payload": payload})
        return text, items

    def search_by_text(self, text: str,
                       similarity_threshold: Optional[float] = None,
                       max_results: Optional[int] = None, *,
                       stateless: bool = False, use_batcher: bool = False,
                       filter=None):
        """Search the loaded database with a natural-language description
        via the CLIP/PE text tower (capability the reference's models had
        but its app never exposed). Returns (text, items) like
        search_similar.

        `stateless=True` leaves the engine's last-query state untouched
        (concurrent UI sessions); `use_batcher` coalesces the device
        launch with other in-flight searches."""
        if self.text_embedder is None:
            return ("❌ No text encoder configured. Load CLIP/PE text "
                    "weights to enable search-by-text.", [])
        if not text or not text.strip():
            return ("❌ Please provide a text description.", [])
        emb = np.asarray(self.text_embedder.embed(text))
        if not stateless:
            self.detected_regions = None
            self.region_embeddings = emb
            self.region_metadata_list = [{"query_text": text}]
        if similarity_threshold is None:
            # text-image cosine scores live on a different scale than
            # image-image ones; never fall through to the 0.7 default
            similarity_threshold = self.config.search.text_score_threshold
        return self.search_similar(similarity_threshold, max_results,
                                   embeddings=emb, use_batcher=use_batcher,
                                   filter=filter)

    def search_groups(self, similarity_threshold: Optional[float] = None,
                      max_groups: Optional[int] = None,
                      query_index: int = 0, *,
                      group_by: str = "filename", group_size: int = 3,
                      embeddings=_USE_ENGINE_STATE, filter=None,
                      using: str = "", with_lookup=None):
        """Grouped similarity search — qdrant's search_groups API role
        over the reference's store (core_system.py:659-664): results
        are bucketed by a payload field and each bucket reports its top
        `group_size` hits, so e.g. one image with many matching regions
        fills ONE group instead of the whole result page.

        Groups are ranked by their best hit; hits within a group keep
        global score order. Exact: the scan deepens (doubling k) until
        every selected group is full or candidates above the threshold
        are exhausted, so the output equals a brute-force group-by over
        the full masked scan. Rows without the `group_by` key are
        skipped (qdrant semantics). Returns (text, groups) where groups
        is a list of {"key", "hits"} with hits shaped like
        search_similar items. `with_lookup={"collection": name,
        "with_vectors": bool?}` (or just the name) joins each group key
        against a point of another collection — qdrant's with_lookup:
        int keys are row ids there, string keys match region_id; each
        group gains a "lookup" record (None when absent)."""
        cfg = self.config.search
        threshold = (cfg.score_threshold if similarity_threshold is None
                     else similarity_threshold)
        n_groups = cfg.top_k if max_groups is None else int(max_groups)
        group_size = max(1, int(group_size))
        embs = (self.region_embeddings
                if embeddings is Reverso._USE_ENGINE_STATE
                else (None if embeddings is None else np.asarray(embeddings)))
        if embs is None or len(embs) == 0:
            return ("❌ No query embeddings available. Please detect/process an image first.", [])
        store = self._store
        if store is None:
            return ("❌ No database loaded. Please create or load a database first.", [])
        query = embs[min(query_index, len(embs) - 1)]

        try:
            fmask = self._filter_mask(filter) if filter is not None else None
            cols = self._payload_columns()
            key_col = cols.column(group_by)
            present = cols.present(group_by)
        except StoreError as e:
            return (f"❌ {e}", [])
        mask = present if fmask is None else (present & fmask)
        n_avail = int(mask.sum())
        if n_avail == 0:
            return (f"❌ No points carry payload key '{group_by}'"
                    + (" and match the filter" if fmask is not None else "")
                    + ".", [])
        index = self._get_index(using)

        k = min(n_avail, max(n_groups * group_size, 32))
        while True:
            scores, ids = (to_host(a)[0] for a in
                           index.search(query[None], k, row_mask=mask))
            sel: dict = {}
            complete = False
            exhausted = True          # flips if we stop at k with room left
            for s, i in zip(scores, ids):
                s, i = float(s), int(i)
                if i < 0 or s < threshold:
                    break             # scores are sorted: nothing below counts
                kv = key_col[i]
                if not isinstance(kv, (str, int, float, bool)):
                    kv = json.dumps(kv, sort_keys=True)   # lists/dicts
                hits = sel.get(kv)
                if hits is None:
                    if len(sel) >= n_groups:
                        continue      # group set is final (best-hit order)
                    sel[kv] = [(s, i)]
                elif len(hits) < group_size:
                    hits.append((s, i))
                if (len(sel) == n_groups
                        and all(len(v) >= group_size for v in sel.values())):
                    complete = True
                    break
            else:
                # consumed all k rows without finishing: deeper rows may
                # still fill groups unless the scan already covered
                # every masked row
                exhausted = k >= n_avail
            if complete or exhausted or k >= n_avail:
                break
            k = min(n_avail, k * 2)

        if not sel:
            return (f"❌ No similar regions found above threshold {threshold}", [])
        all_ids = [i for hits in sel.values() for _, i in hits]
        payloads = dict(zip(all_ids, store.payloads(all_ids)))
        text = f"🎯 Found {len(sel)} groups (by {group_by}):\n\n"
        groups = []
        for rank, (kv, hits) in enumerate(sel.items()):
            text += f"{rank + 1}. {group_by}={kv} — best {hits[0][0]:.3f}, {len(hits)} hit(s)\n"
            items = []
            for s, i in hits:
                payload = payloads.get(i) or {}
                image_path = payload.get("image_source", "")
                thumb = (render_result_thumbnail(image_path, s)
                         if image_path else None)
                items.append({"image": thumb, "score": s, "id": i,
                              "filename": payload.get("filename", "Unknown"),
                              "bbox": payload.get("bbox", [0, 0, 0, 0]),
                              "payload": payload})
                text += f"     {payload.get('filename', 'Unknown')} (Similarity: {s:.3f})\n"
            text += "\n"
            groups.append({"key": kv, "hits": items})
        if with_lookup is not None:
            try:
                self._attach_group_lookups(groups, with_lookup)
            except (StoreError, ValueError) as e:
                return (f"❌ {e}", [])
        return text, groups

    def _attach_group_lookups(self, groups, with_lookup) -> None:
        """qdrant with_lookup: join each group key against a point of
        ANOTHER collection — int keys are row ids, string keys match
        region_id (one payload stream over the lookup collection
        builds the map; intended for modest document collections,
        qdrant's usage). Each group dict gains a "lookup" record
        (None when the key names no point). Shared by search_groups
        and query_groups."""
        spec = (with_lookup if isinstance(with_lookup, dict)
                else {"collection": with_lookup})
        lstore, _ = self._lookup_store(spec)
        try:
            rid_map = None
            for gdict in groups:
                kv = gdict["key"]
                row = None
                if isinstance(kv, bool):
                    row = None
                elif isinstance(kv, (int, np.integer)) or (
                        isinstance(kv, float) and
                        float(kv).is_integer()):
                    r = int(kv)
                    row = r if 0 <= r < lstore.count else None
                elif isinstance(kv, str):
                    if rid_map is None:
                        rid_map = {}
                        pays = lstore.payloads(
                            list(range(lstore.count)))
                        for r, p in enumerate(pays):
                            rid = (p or {}).get("region_id")
                            if isinstance(rid, str) \
                                    and rid not in rid_map:
                                rid_map[rid] = r
                    row = rid_map.get(kv)
                if row is None:
                    gdict["lookup"] = None
                    continue
                rec = {"id": row,
                       "payload": lstore.payloads([row])[0]}
                if spec.get("with_vectors"):
                    rec["vector"] = np.asarray(
                        lstore.vectors()[row], np.float32).tolist()
                gdict["lookup"] = rec
        finally:
            lstore.close()

    # -- index build ------------------------------------------------------

    def request_stop(self) -> None:
        """Cooperative cancellation of a running build."""
        self._stop_event.set()

    def create_database(self, folder_path: str, database_name: str,
                        text_prompt: str = "person . car . building",
                        use_direct_pe: bool = False,
                        progress_callback=None,
                        resume_from_checkpoint: bool = False,
                        include_subfolders: bool = False) -> str:
        """Build a searchable database from a folder."""
        self._set_store(None)  # release any handle on the target store
        self.metrics = Metrics()
        result = build_database(
            self.encoder, folder_path, database_name,
            config=self.config, text_prompt=text_prompt,
            use_direct_pe=use_direct_pe, detector=self.detector,
            progress_callback=progress_callback,
            resume_from_checkpoint=resume_from_checkpoint,
            include_subfolders=include_subfolders,
            stop_event=self._stop_event, metrics=self.metrics)
        if result.total_embeddings > 0 and not result.stopped:
            try:
                self._set_store(VectorStore.open(self.db_root, database_name))
            except StoreError:
                pass
        return result.transcript

    # -- visualization ----------------------------------------------------

    def visualize_detections(self, image, selected_region_index=None,
                             regions=_USE_ENGINE_STATE):
        """Draw region contours (None regions for a direct-PE query)."""
        if regions is Reverso._USE_ENGINE_STATE:
            regions = self.detected_regions
        return _viz(image, regions, selected_region_index)
