"""Drop-in compatibility layer: the reference's `SimpleReverso` API.

Code written against the reference (reference core_system.py:44-757)
runs against this class unchanged — same method names, same argument
orders and defaults, same return conventions (status strings with the
reference's emoji, `(embeddings, metadata)` tuples, `(results_text,
items)` search results). Underneath it is the PyTorch engine: batched
detection and embedding, device-resident exact top-k through the CUDA
kernel, working checkpoints. It runs on the card unless the caller asks
for the CPU (`device="cpu"`).
"""
from __future__ import annotations

from typing import Optional

from .config import EngineConfig, default_config
from .engine import Reverso


class SimpleReverso:
    """Reference-compatible facade (reference core_system.py:44)."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 encoder=None, detector=None, device=None):
        self._engine = Reverso(config or default_config(), encoder=encoder,
                               detector=detector, device=device)

    # the reference exposes these as instance state; mirror them
    @property
    def detected_regions(self):
        return self._engine.detected_regions

    @property
    def region_embeddings(self):
        emb = self._engine.region_embeddings
        return None if emb is None else list(emb)

    @property
    def current_database(self):
        return self._engine.current_database

    # -- database management (core_system.py:74-154) --------------------
    def list_databases(self):
        return self._engine.list_databases()

    def load_database(self, database_name):
        return self._engine.load_database(database_name)

    def delete_database(self, database_name):
        return self._engine.delete_database(database_name)

    def unlock_database(self, database_name):
        return self._engine.unlock_database(database_name)

    # -- query path (core_system.py:237-455) -----------------------------
    def detect_regions(self, image, text_prompt=None):
        return self._engine.detect_regions(image, text_prompt)

    def extract_embeddings(self, image):
        return self._engine.extract_embeddings(image)

    def process_image_direct_pe(self, image):
        emb, metas = self._engine.process_image_direct_pe(image)
        return list(emb), metas

    # -- index build / search (core_system.py:457-717) -------------------
    def request_stop(self):
        self._engine.request_stop()

    def create_database(self, folder_path, database_name,
                        text_prompt="person . car . building",
                        use_direct_pe=False, progress_callback=None,
                        resume_from_checkpoint=False,
                        include_subfolders=False):
        return self._engine.create_database(
            folder_path, database_name, text_prompt=text_prompt,
            use_direct_pe=use_direct_pe, progress_callback=progress_callback,
            resume_from_checkpoint=resume_from_checkpoint,
            include_subfolders=include_subfolders)

    def search_similar(self, similarity_threshold=0.7, max_results=5):
        return self._engine.search_similar(similarity_threshold, max_results)

    # -- visualization (core_system.py:719-757) ---------------------------
    def visualize_detections(self, image, selected_region_index=None):
        return self._engine.visualize_detections(image, selected_region_index)
