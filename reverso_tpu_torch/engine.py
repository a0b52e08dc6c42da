"""Reverso: the engine facade, direct-embed and region paths.

The reference app's core loop: image folder -> (GroundingDINO + SAM
regions ->) PE-Core embeddings -> durable store -> exact cosine top-k.
Database management, `create_database` through the shared ingest
pipeline, `process_image_direct_pe`, `detect_regions`,
`extract_embeddings` (compat mode: each region carries its image's
global embedding, as the reference does), `search_similar` and
`search_batch` carry the JAX package's method bodies and status strings;
the models run in PyTorch and the search through the CUDA top-k kernel.

Everything runs on one device: CUDA unless the caller asks for the CPU
(`device="cpu"`, or an encoder built on the CPU). Parts of the JAX engine
not ported yet (ROI pooling, payload filters, the micro-batching
searcher, approximate indexes, named-space deletions) raise rather than
run a different path.
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
    VectorStore, DeviceIndex, StoreError, StoreLockedError,
    list_databases as _list_databases,
    delete_database as _delete_database,
    unlock_database as _unlock_database,
)
from .utils.logging import get_logger
from .utils.profiling import Metrics
from .viz import visualize_detections as _viz, render_result_thumbnail, to_rgb_array

log = get_logger("engine")


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
                raise NotImplementedError(
                    "multivector (MaxSim) spaces are not ported yet")
            if using not in store.spaces():
                raise StoreError(
                    f"unknown vector space {using!r} (have "
                    f"{sorted(store.spaces()) + sorted(store.sparse) + sorted(store.multi)})")
            scfg = self.config.search
            if scfg.index != "exact" or self.config.store.dtype not in (
                    "bfloat16", "float32"):
                raise NotImplementedError(
                    f"index={scfg.index!r} / dtype="
                    f"{self.config.store.dtype!r}: only the exact bf16/fp32 "
                    f"index is ported")
            if store.deleted_rows(using).size:
                raise NotImplementedError(
                    "stores with deleted vectors need filtered search, "
                    "which is not ported yet")
            index = DeviceIndex(
                np.asarray(store.vectors(using)),
                dtype=self.config.store.dtype,
                distance=store.distance,
                device=self.device)
            self._indexes[using] = (key, index)
            return index

    # -- query path -------------------------------------------------------

    def search_batch(self, embeddings, k: Optional[int] = None, *,
                     filter=None, using: str = ""):
        """Bulk search: [B, d] query embeddings in ONE kernel launch.

        Returns host arrays (scores [B, k], ids [B, k]) with the usual
        (-score, idx) order and -1 padding."""
        if filter is not None:
            raise NotImplementedError("payload filters are not ported yet")
        k = self.config.search.top_k if k is None else int(k)
        q = np.asarray(embeddings, np.float32)
        if q.ndim == 1:
            q = q[None]
        scores, ids = self._get_index(using).search(q, k)
        return scores.cpu().numpy(), ids.cpu().numpy()

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

    def _check_region_mode(self) -> None:
        if self.config.ingest.region_embed_mode == "region":
            raise NotImplementedError(
                "region_embed_mode='region' (ROI pooling) is not ported yet; "
                "use region_embed_mode='compat'")

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
        """Embed detected regions (reference core_system.py:320-429): every
        region carries the global image embedding, exactly what the
        reference does (core_system.py:406)."""
        self._check_region_mode()
        regions = self.detected_regions
        if regions is None or len(regions) == 0:
            return [], []
        px, (w, h) = self._preprocess(image)
        n = min(len(regions), self.config.ingest.max_regions)
        emb = np.asarray(self.encoder.encode_image(px))[0]
        vecs, metas = [], []
        for i in range(n):
            meta = region_metadata(regions, i)
            if meta is None:
                continue
            if meta["bbox"] is None:
                meta["bbox"] = [0, 0, w, h]
            vecs.append(emb)
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
                       filter=None, using: str = ""):
        """Search the loaded database with a previously extracted
        embedding. Returns (text, items).

        `embeddings` overrides the engine's last-query state with an
        explicit [R, d] array, making the call stateless."""
        if filter is not None:
            raise NotImplementedError("payload filters are not ported yet")
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

        scores, ids = self._get_index(using).search(query, k)
        scores, ids = scores[0].cpu().numpy(), ids[0].cpu().numpy()
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
        if not use_direct_pe:
            self._check_region_mode()
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
