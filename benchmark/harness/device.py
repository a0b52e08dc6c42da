"""The card and the process around a run: cache directories inside the
checkout, the look for cards, the guard against JAX, the device fields
of the result."""
from __future__ import annotations

import os
import subprocess
import sys

from .cell import ROOT

# top-level module names that no run may load: JAX, and the JAX package
# the port was made from (compared whole: the port's own name begins
# with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "reverso_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds. The port's kernel library
    builds into its own `reverso_tpu_torch/_build/`, inside the checkout;
    these cover PyTorch's extension builds and Triton's cache."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ.setdefault("USE_FLAX", "0")


def cards_missing(n: int):
    """None where `n` CUDA cards are visible, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark measures only on a card"
    if torch.cuda.device_count() < n:
        return f"the cell needs {n} CUDA cards, {torch.cuda.device_count()} visible"
    return None


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def free_cache() -> None:
    """Hand the allocator's cached blocks back, between the program and
    the reference."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def memory_peak(n: int) -> int:
    import torch

    return max(torch.cuda.max_memory_allocated(d) for d in range(n))


def card_line() -> str:
    """The card's name, power limit and state, as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
                              "clocks.sm,temperature.gpu,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def device_fields(n: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n,
            "memory_peak_bytes": int(peak)}
