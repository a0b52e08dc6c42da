"""Reverso in PyTorch for NVIDIA Hopper GPUs.

The port of `reverso_tpu` (JAX/flax with Pallas kernels for the TPU): the
same engine surface, store format and search contract, with the model in
PyTorch and every kernel on the main path (flash attention with 2D RoPE,
the fused MLP, exact top-k) hand-written in CUDA C++ for sm_90a
(`csrc/`, built by `kernels.py` at first use). CPU tensors run each
kernel's plain PyTorch version.
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
