"""Reverso: the engine facade, direct-embed and region paths.

The reference app's core loop: image folder -> (GroundingDINO + SAM
regions ->) PE-Core embeddings -> durable store -> exact cosine top-k.
Database management, `create_database` through the shared ingest
pipeline, `process_image_direct_pe`, `detect_regions`,
`extract_embeddings` (compat mode: each region carries its image's
global embedding, as the reference does; region mode: masked ROI pooling
of each region from one forward), `search_similar` and
`search_batch` (with payload `filter=`), `count` and the index routing of
`_get_index` — the exact index in bf16/fp32/int8 under every distance
(cosine, dot, euclid, manhattan), binary and product quantization with
rescore, IVF, the host index, multivector (MaxSim) spaces, deleted
vectors — carry the JAX package's method bodies and status strings; the
models run in PyTorch and the searches through the CUDA top-k and IVF
kernels (euclid through the top-k kernel on augmented rows; manhattan,
PQ and MaxSim as plain PyTorch, as they were XLA in the JAX package).

Everything runs on one device: CUDA unless the caller asks for the CPU
(`device="cpu"`, or an encoder built on the CPU); `search.index="host"`
is the native host scan the user chose. Parts of the JAX engine not
ported yet (the micro-batching searcher, point mutations, the universal
query, meshes) raise rather than run a different path.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from .config import EngineConfig, default_config
from .detect.regions import Regions, parse_prompts
from .ingest.images import preprocess_pil
from .ingest.pipeline import build_database, direct_pe_metadata, region_metadata
from .models.pe import PerceptionEncoder, resolve_device
from .store import (
    VectorStore, BinaryIndex, DeviceIndex, HostIndex, IVFIndex, MultiVecIndex, PQIndex,
    StoreError, StoreLockedError,
    list_databases as _list_databases,
    delete_database as _delete_database,
    unlock_database as _unlock_database,
)
from .store.index import default_pq_m
from .utils.logging import get_logger
from .utils.profiling import Metrics
from .viz import visualize_detections as _viz, render_result_thumbnail, to_rgb_array

log = get_logger("engine")


def load_or_build_ivf(store, vectors: np.ndarray, scfg, dtype: str,
                      *, space: str = "", device=None):
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
        ivf = IVFIndex.load_cache(vectors, cache, dtype=dtype, device=device)
    dirty = ivf is None
    if ivf is None and os.path.isdir(cache_dir):
        for f in sorted(os.listdir(cache_dir), reverse=True):
            # exactly the digit count between stem_ and tail: another
            # space whose name nests into this stem must not serve
            if (f.startswith(stem + "_") and f.endswith(tail)
                    and f[len(stem) + 1:-len(tail)].isdigit()):
                ivf = IVFIndex.extend_cache(
                    vectors, os.path.join(cache_dir, f), dtype=dtype,
                    device=device)
                if ivf is not None:
                    break
    if ivf is None:
        ivf = IVFIndex(vectors, n_clusters=min(scfg.ivf_clusters, count),
                       dtype=dtype, spill=scfg.ivf_spill,
                       balance=scfg.ivf_balance, device=device)
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
                     space: str = "", device=None):
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
        pqi = PQIndex.load_cache(vectors, cache, m=m, device=device)
    dirty = pqi is None
    if pqi is None and os.path.isdir(cache_dir):
        for f in sorted(os.listdir(cache_dir), reverse=True):
            # same digit-count guard as the IVF extend loop (space
            # names can nest into each other's stems)
            if (f.startswith(stem + "_") and f.endswith(tail)
                    and f[len(stem) + 1:-len(tail)].isdigit()):
                pqi = PQIndex.load_cache(
                    vectors, os.path.join(cache_dir, f), m=m, device=device)
                if pqi is not None:
                    break
    if pqi is None:
        pqi = PQIndex(vectors, m=m, device=device)
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


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


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

    def search(self, queries, k: int, *, row_mask=None, **_):
        import math as _math

        q = np.asarray(_host(queries), np.float32)
        if q.ndim == 1:
            q = q[None]
        if self.n_valid == 0:
            return (np.full((len(q), k), -np.inf, np.float32),
                    np.full((len(q), k), -1, np.int32))
        k_fetch = min(max(k, int(_math.ceil(k * self.oversampling))),
                      self.n_valid)
        s, i = (_host(a) for a in self._b.search(q, k_fetch, row_mask=row_mask))
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
    scan's `row_mask`, at the one choke point (_get_index)."""

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


class Reverso:
    """Visual investigation engine: embed -> store -> search."""

    # "caller did not pass this" sentinel: distinguishes an EXPLICIT None
    # (a session whose query found nothing — must error, not fall back to
    # another session's engine state) from an omitted argument.
    _USE_ENGINE_STATE = object()

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 encoder: Optional[PerceptionEncoder] = None,
                 detector=None, device=None):
        self.config = config or default_config()
        # encoder is LAZY: store-only flows never pay the model build;
        # the device is settled now, so a machine without CUDA fails here
        # unless the caller asked for the CPU
        if device is None and encoder is not None:
            device = encoder.device
        self.device = resolve_device(device)
        self._encoder = encoder
        self.detector = detector
        self.metrics = Metrics()

        self._store: Optional[VectorStore] = None
        # per-vector-space device indexes: {space: (key, index)} with
        # key = (count, vector_version) — see _get_index
        self._indexes: dict = {}
        self.current_database: Optional[str] = None

        # last query state (single-session convenience, like the reference)
        self.detected_regions: Optional[Regions] = None
        self.region_embeddings: Optional[np.ndarray] = None
        self.region_metadata_list: list[dict] = []

        self._filter_cols = None
        self._filter_cols_key = None
        self._stop_event = threading.Event()
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

    def _set_store(self, store: Optional[VectorStore]) -> None:
        with self._index_lock:
            self._store = store
            self._indexes = {}
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
                                      device=self.device)
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
                                        space=using, device=self.device)
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
                    BinaryIndex(vectors, device=self.device), vectors,
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
                                       device=self.device)
                index = _BinaryRescoreAdapter(
                    pqi, vectors, oversampling=scfg.pq_oversampling,
                    rescore=scfg.pq_rescore)
            else:
                index = DeviceIndex(vectors, dtype=dtype,
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

    def count(self, filter=None) -> int:
        """Number of stored points, optionally restricted to a payload
        filter (qdrant's count API role)."""
        store = self._store
        if store is None:
            raise StoreError("no database loaded")
        store.refresh()
        mask = self._filter_mask(filter) if filter is not None else None
        return store.count if mask is None else int(mask.sum())

    def delete_vectors(self, *args, **kwargs):
        raise NotImplementedError(
            "delete_vectors is not ported yet (point mutations: the surface "
            "slice, ROADMAP queue 1 item 17); VectorStore.delete_vector_rows "
            "writes the same mask")

    def update_vectors(self, *args, **kwargs):
        raise NotImplementedError(
            "update_vectors is not ported yet (point mutations: the surface "
            "slice, ROADMAP queue 1 item 17)")

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
        return _host(scores), _host(ids)

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
        explicit [R, d] array, making the call stateless. `filter`
        (dict/string; see `store.filter`) restricts results to rows whose
        payload matches, e.g. `{"folder": 3}` or `"confidence>=0.5"`."""
        if use_batcher:
            raise NotImplementedError(
                "the micro-batching searcher is not ported yet (serve.py: "
                "ROADMAP queue 1 item 18)")
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
        scores, ids = self._get_index(using).search(query, k, row_mask=mask)
        scores, ids = _host(scores)[0], _host(ids)[0]
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
