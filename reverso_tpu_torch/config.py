"""Typed configuration for the Reverso-TPU engine.

The reference keeps its knobs as hard-coded constants scattered through
`core_system.py` plus a dead `config.py` that is never imported
(reference `config.py:1-18`, `core_system.py:222-223,363,492,612`).
Here every knob lives in one typed, immutable config tree; the defaults
reproduce the reference's behavior exactly (the "compat profile").
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


# Image extensions the folder scanner accepts (reference core_system.py:492).
IMAGE_EXTENSIONS: tuple[str, ...] = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp")

# Video extensions (reference video_processing.py:28,478).
VIDEO_EXTENSIONS: tuple[str, ...] = (".mp4", ".mov", ".avi", ".mkv", ".webm")

# Domain allowlist for URL ingestion (reference video_processing.py:70-76).
SUPPORTED_VIDEO_DOMAINS: frozenset[str] = frozenset({
    "youtube.com", "youtu.be", "youtube-nocookie.com",
    "twitter.com", "x.com", "nitter.net",
    "facebook.com", "fb.com", "m.facebook.com",
    "instagram.com", "tiktok.com", "vimeo.com",
    "dailymotion.com", "twitch.tv",
})


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.

    axes: mapping of logical axis name -> size. By convention:
      - "data":   batch / throughput axis (DP for embedding, row-shard for search)
      - "model":  tensor-parallel axis for the ViT (optional, 1 by default)
    A size of -1 means "all remaining devices".
    """
    axis_names: tuple[str, ...] = ("data", "model")
    axis_sizes: tuple[int, ...] = (-1, 1)

    def resolved_sizes(self, n_devices: int) -> tuple[int, ...]:
        sizes = list(self.axis_sizes)
        known = 1
        wild = None
        for i, s in enumerate(sizes):
            if s == -1:
                if wild is not None:
                    raise ValueError("at most one mesh axis may be -1")
                wild = i
            else:
                known *= s
        if wild is not None:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by {known}")
            sizes[wild] = n_devices // known
        total = 1
        for s in sizes:
            total *= s
        if total != n_devices:
            raise ValueError(f"mesh {sizes} != {n_devices} devices")
        return tuple(sizes)


@dataclass(frozen=True)
class ModelConfig:
    """Vision-tower architecture (PE-Core family; reference core_system.py:169-203)."""
    name: str = "PE-Core-L14-336"
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024          # output embedding dim (1024-d, core_system.py:596)
    use_cls_token: bool = True
    pool_type: str = "attn"        # "attn" | "cls" | "mean"
    use_rope: bool = True          # PE-Core uses 2D RoPE
    use_abs_pos: bool = True
    use_ln_post: bool = True
    layer_scale_init: float | None = 0.1
    dtype: str = "bfloat16"        # activation dtype on TPU
    param_dtype: str = "float32"
    # LayerNorm compute dtype. fp32 is the parity-exact default; bf16
    # (stats still accumulate fp32 inside the VPU reduce) trades ~1e-3
    # embedding drift for throughput on bf16 towers.
    norm_dtype: str = "float32"
    # "int8": dynamic-int8 fused-MLP matmuls on the s8 MXU path
    # (Pallas, 1.28x/layer; tower 1.08x end-to-end). Opt-in throughput
    # knob: ~1.8e-2 relative noise per MLP vs bf16's 2.3e-3, diluted
    # by the residual stream to ~3e-5 embedding cosine drift and 0.99
    # top-10 neighbor overlap (scripts/bench_embed_int8.py). The qkv
    # projections stay bf16 — int8 measured slower in-model
    # (scripts/bench_embed_quant_parts.py).
    quant: str = "none"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)


@dataclass(frozen=True)
class DetectorConfig:
    """Open-vocabulary detection + segmentation (reference core_system.py:205-235)."""
    box_threshold: float = 0.35    # core_system.py:222
    text_threshold: float = 0.25   # core_system.py:223
    max_regions: int = 50          # hard cap per image, core_system.py:363
    mask_threshold: float = 0.5
    image_size: int = 1024         # SAM-style input resolution
    default_prompt: str = "object"  # fallback when prompt empty, core_system.py:213
    # Activation dtype for GroundingDINO + SAM. fp32 is the default and
    # the closest to reference numerics — but not bit-exact on TPU: the
    # big attention contractions (SAM global layers' flash rel-bias
    # path, and any XLA einsum at default precision) run one bf16 MXU
    # pass (~3e-3 rel, PERF.md precision trap), so near-threshold
    # detections CAN differ from a CPU fp32 run; thresholds are still
    # compared against f32-accumulated logits. "bfloat16" runs the
    # whole stack in bf16 — since the Pallas deformable kernel it is no
    # faster end-to-end (PERF.md round-2 A/B) and quantizes near-
    # threshold results harder; sampling COORDINATES stay fp32 either
    # way (round-3: the ~0.5 px bf16 sampling quantization is gone).
    dtype: str = "float32"


@dataclass(frozen=True)
class StoreConfig:
    """On-device sharded embedding store + host persistence."""
    root_dir: str = "./simple_reverso_db"   # reference DB root, core_system.py:76,471
    # on-device matrix dtype: "bfloat16" | "float32" (strict parity) |
    # "int8" (2x capacity at the same scan speed; exact w.r.t. the int8
    # device copy, disk persistence stays fp32 — ops.topk int8-exact) |
    # "binary" (16x bf16 capacity: sign-packed candidate scan + exact
    # f32 rescore of the top oversampling*k — qdrant binary
    # quantization; approximate, SearchConfig.binary_* tune it) |
    # "pq" (product quantization: m-byte codes + learned codebooks,
    # one-hot-through-MXU decompress scan + the same exact rescore —
    # qdrant ProductQuantization; approximate, SearchConfig.pq_* tune)
    dtype: str = "bfloat16"
    capacity_step: int = 65536              # device matrix grows in multiples of this
    shard_axis: str = "data"                # mesh axis rows are sharded over
    upsert_batch: int = 100                 # reference upsert batch, core_system.py:612


@dataclass(frozen=True)
class SearchConfig:
    """Query defaults (reference core_system.py:650, ui.py:341-342)."""
    score_threshold: float = 0.7
    # Text->image cosine scores peak around 0.2-0.35 for CLIP/PE towers,
    # so text search gets its own default — the image-image 0.7 would
    # filter out every hit and make the feature appear broken.
    text_score_threshold: float = 0.18
    top_k: int = 5
    query_tile: int = 256     # queries per kernel tile
    db_tile: int = 1024       # database rows per kernel tile
    exact_dtype: str = "float32"   # parity mode accumulates/storage in fp32
    # approximate index for very large corpora (BASELINE config #5):
    # "exact" = fused full scan; "ivf" = k-means coarse quantizer;
    # "host" = the native C++ multithreaded host scan (reverso_native),
    # for hosts without an accelerator — the role qdrant local mode's
    # numpy scan plays in the reference (core_system.py:659)
    index: str = "exact"
    ivf_clusters: int = 1024
    ivf_nprobe: int = 16
    # fraction of rows duplicated into their runner-up cluster
    # (SOAR/replication-lite): boundary rows survive probe misses, so
    # recall at fixed nprobe rises for ~spill x storage overhead.
    # Results stay dedup'd and exactly ordered.
    ivf_spill: float = 0.0
    # cluster-size cap as a multiple of the mean (0 = off, else >= 1.0):
    # oversized clusters are recursively split into child centroids so
    # cmax <= ceil(balance * n / clusters). The probed scan reads a
    # PADDED [cmax, d] slice per (query, probe), so one skewed cluster
    # taxes EVERY probe — capping cmax bounds per-probe DMA on real
    # (lognormal-skewed) data.
    ivf_balance: float = 0.0
    # probed-scan implementation: "auto" (Pallas kernel on single-TPU
    # serving shapes, XLA otherwise), "xla", "pallas". The operational
    # escape hatch if the kernel misbehaves on a new toolchain.
    ivf_impl: str = "auto"
    # binary quantization (StoreConfig.dtype == "binary"): the packed
    # candidate scan fetches ceil(oversampling * k) ids, then the
    # engine rescores them exactly against the full-precision rows
    # (qdrant's rescore/oversampling search params). rescore=False
    # surfaces the raw binary proxy scores.
    binary_oversampling: float = 3.0
    binary_rescore: bool = True
    # product quantization (StoreConfig.dtype == "pq"): same
    # oversample-then-rescore split as binary. pq_m = subspace count
    # (bytes per row in HBM); 0 = d/8, matching binary's footprint
    # with 256-entry learned codebooks instead of sign bits.
    pq_m: int = 0
    pq_oversampling: float = 3.0
    pq_rescore: bool = True
    # scalar-quantization clipping quantile (StoreConfig.dtype ==
    # "int8"): 0.0 keeps the exact abs-max scale; 0 < q < 1 sets the
    # int8 scale from the q abs-value quantile of the matrix (qdrant
    # ScalarQuantization's `quantile` — outliers clip to +-127 and the
    # bulk of the distribution gains resolution). Scores stay exact
    # w.r.t. the STORED int8 either way — the contract never changes,
    # only what the rounding keeps. IVF int8 cells always use abs-max
    # (their cache persists across quantile changes).
    int8_quantile: float = 0.0


@dataclass(frozen=True)
class IngestConfig:
    batch_size: int = 64           # images per device batch in the embed pipeline
    max_regions: int = 50
    # "compat": every region stores the global image embedding (what the
    # reference actually does, core_system.py:406 "Use global for now").
    # "region": fused masked-ROI attention pooling -> true per-region
    # embeddings (north-star improvement).
    region_embed_mode: str = "compat"
    checkpoint_every: int = 10     # images between checkpoints, core_system.py:582
    # Host decode/resize backend for the ingest loader. "pil" is the
    # reference-transform family (PIL bicubic; JPEGs use DCT draft decode
    # when no original-resolution copy is needed — 2.1x faster, pixels
    # within JPEG quantization noise of a full decode). "cv2" uses
    # OpenCV's SIMD decode+INTER_CUBIC (~2x faster again per core;
    # resize-kernel pixel deltas ~1.3/255 vs PIL — below retrieval
    # relevance, but not bit-compatible with the reference transform).
    decode_backend: str = "pil"
    image_extensions: tuple[str, ...] = IMAGE_EXTENSIONS
    video_extensions: tuple[str, ...] = VIDEO_EXTENSIONS
    jpeg_quality: int = 95         # frame-write quality, video_processing.py:275
    frames_per_scene: int = 2
    scene_threshold: float = 30.0
    uniform_num_frames: int = 20


@dataclass(frozen=True)
class EngineConfig:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "EngineConfig":
        raw = json.loads(text)
        def build(cls, d):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in d.items():
                if k not in fields:
                    continue
                t = fields[k].type
                if dataclasses.is_dataclass(fields[k].default_factory() if fields[k].default_factory is not dataclasses.MISSING else None):  # type: ignore[misc]
                    kw[k] = build(type(fields[k].default_factory()), v)  # type: ignore[misc]
                elif isinstance(v, list):
                    kw[k] = tuple(v)
                else:
                    kw[k] = v
            return cls(**kw)
        return build(EngineConfig, raw)


# Named model presets (PE-Core family; sizes follow the public PE-Core family:
# the reference targets PE-Core-L14-336 with fallback to any available config,
# core_system.py:177-191).
MODEL_PRESETS: Mapping[str, ModelConfig] = {
    "PE-Core-T16-384": ModelConfig(
        name="PE-Core-T16-384", image_size=384, patch_size=16, width=192,
        depth=12, num_heads=3, embed_dim=512),
    "PE-Core-S16-384": ModelConfig(
        name="PE-Core-S16-384", image_size=384, patch_size=16, width=384,
        depth=12, num_heads=6, embed_dim=512),
    "PE-Core-B16-224": ModelConfig(
        name="PE-Core-B16-224", image_size=224, patch_size=16, width=768,
        depth=12, num_heads=12, embed_dim=1024),
    "PE-Core-L14-336": ModelConfig(
        name="PE-Core-L14-336", image_size=336, patch_size=14, width=1024,
        depth=24, num_heads=16, embed_dim=1024),
    "PE-Core-G14-448": ModelConfig(
        name="PE-Core-G14-448", image_size=448, patch_size=14, width=1536,
        depth=50, num_heads=16, mlp_ratio=8960 / 1536, embed_dim=1280),
    # HF-CLIP fallbacks for scripts/fetch_weights.py (the reference's PE
    # checkpoints share the ViT-L/14-336 architecture; these presets let
    # openly-downloadable OpenAI CLIP weights flow through the same stack).
    "CLIP-L14-336": ModelConfig(
        name="CLIP-L14-336", image_size=336, patch_size=14, width=1024,
        depth=24, num_heads=16, embed_dim=768, use_rope=False,
        pool_type="cls", layer_scale_init=None),
    "CLIP-B16-224": ModelConfig(
        name="CLIP-B16-224", image_size=224, patch_size=16, width=768,
        depth=12, num_heads=12, embed_dim=512, use_rope=False,
        pool_type="cls", layer_scale_init=None),
    # Tiny config for tests / CI (not a released PE model).
    "test-tiny": ModelConfig(
        name="test-tiny", image_size=32, patch_size=8, width=64,
        depth=2, num_heads=4, embed_dim=32),
}


def default_config() -> EngineConfig:
    return EngineConfig()


def db_root() -> str:
    return os.environ.get("REVERSO_DB_ROOT", StoreConfig.root_dir)
