"""Reverso in PyTorch for NVIDIA Hopper GPUs.

The port of `reverso_tpu` (JAX/flax with Pallas kernels for the TPU): the
same engine surface, store format and search contract, with the models
(PE-Core / CLIP towers, GroundingDINO, SAM) in PyTorch and every kernel on
the direct-embed and region paths and the capacity indexes (flash
attention with 2D RoPE, the fused MLP, exact top-k in bf16/fp32, masked,
int8 and binary modes, flash attention with SAM's rel-pos bias,
multi-scale deformable attention, the IVF probed scan) hand-written in
CUDA C++ for sm_90a (`csrc/`, built by `kernels.py` at first use). CPU tensors run each kernel's plain
PyTorch version; entry points run on CUDA unless given `device="cpu"`.
`train/` fine-tunes the vision tower on one device, the attention's and
the MLP's gradients on hand-written backward kernels.
"""

__version__ = "0.1.0"

from .engine import Reverso
from .config import (
    EngineConfig,
    MeshConfig,
    ModelConfig,
    DetectorConfig,
    StoreConfig,
    SearchConfig,
    IngestConfig,
    MODEL_PRESETS,
    default_config,
)
