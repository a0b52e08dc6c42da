"""Builds and binds the hand-written CUDA kernels in `csrc/`.

Each `csrc/*.cu` compiles with its own `nvcc` for `sm_90a`, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ctypes. The build runs at first use and again
whenever a source is newer than the library, so a fresh checkout needs
nothing but the CUDA toolkit. Each `extern "C"` launcher takes raw
device pointers, ints and PyTorch's current stream, launches without
synchronising, and returns `cudaGetLastError()`; `check()` raises on any
non-zero status.

Nothing here runs at import: importing the package needs neither a card
nor a compiler.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libreverso_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8, BINARY_PACKED = 2, 3   # top-k / IVF modes: int8 digits, packed sign bits
UNSUPPORTED = -1
MAP_ERROR = -2   # a TMA tensor map could not be encoded (csrc/flash_tc.cuh)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, cos, sin, o, lse, B, S, W, heads, kv_valid, scale, use_rope, stream
    "rv_flash_heads_tc": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, cos, sin, o, lse, B, S, W, heads, kv_valid, scale, use_rope, stream
    "rv_flash_heads_split": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, o, dO, lse, cos, sin, qr, kr, D, dq, dk, dv, B, S, W, heads,
    # kv_valid, scale, use_rope, stream
    "rv_flash_heads_bwd_tc": [_P] * 14 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, o, dO, lse, cos, sin, parts, D, dq, dk, dv, B, S, W, heads,
    # kv_valid, scale, use_rope, dtype, parts' pitch, stream
    "rv_flash_heads_bwd_parts": [_P] * 13 + [_I] * 5 + [_F, _I, _I, _I, _P],
    # x, w1 parts, b1, w2 parts, dy, x parts, dy parts, h, dz, db1 partials, T, W,
    # H, act, W's pitch, H's pitch, stream (fp32)
    "rv_fused_mlp_bwd_split": [_P] * 10 + [_I] * 6 + [_P],
    # x, w1, b1, w2, dy, h, dz, db1 partials, T, W, H, act, stream (bf16)
    "rv_fused_mlp_bwd_tc": [_P] * 8 + [_I] * 4 + [_P],
    # x, w1, b1, w2, b2, h, out, T, W, H, act, stream
    "rv_fused_mlp_tc": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w1 parts, b1, w2 parts, b2, x parts, h parts, out, T, W, H, act, stream
    "rv_fused_mlp_split": [_P] * 8 + [_I] * 4 + [_P],
    # x, out, rows, cols, out_rows, pitch, parts, dtype, stream
    "rv_split_parts": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w1, s1, b1, w2, s2, b2, x8, xs, h8, hs, out, T, W, H, act, dtype, stream
    "rv_fused_mlp_int8": [_P] * 12 + [_I] * 5 + [_P],
    # db, q, q_scale, row_scale, D, Q, n_valid, k, n_splits, part_s, part_i,
    # out_s, out_i, stream
    "rv_topk_int8_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # db, q, mask, D, Q, n_valid, k, n_splits, part_s, part_i, out_s, out_i, mode, stream
    "rv_topk_stream": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # mat, q_src, q_op, planes, pitch, scale_src, scale_op, mask, base, cnt, ws,
    # U, H, D, M, Q, nprobe, k, n, splits, rps, part_s, part_i, out_s, out_pos,
    # mode, stream
    "rv_ivf_scan": [_P, _P, _P, _I, _I] + [_P] * 6 + [_I] * 10 + [_P] * 4 + [_I, _P],
    # base, cnt, ws, U, H, Q, nprobe, n, rps, stream
    "rv_ivf_plan": [_P, _P, _P] + [_I] * 6 + [_P],
    # q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, out_dtype, stream
    "rv_flash_attn_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, stream
    "rv_flash_attn_split": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, dtype, stream
    "rv_add_layernorm": [_P] * 9 + [_I, _I, _F, _I, _P],
    # value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, dtype, stream
    "rv_ms_deform": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # the hardware probes (probes/): db, n_tiles, tile, n_bufs, streams, d,
    # ctas_per_sm, out, stream
    "rv_probe_dma": [_P] + [_I] * 6 + [_P, _P],
    # a, a2, bt, M, K, N, iters, mode, out, stream
    "rv_probe_mxu": [_P] * 3 + [_I] * 5 + [_P, _P],
    # db, q, n, d, Q, variant, stages, out, stream
    "rv_probe_scan": [_P, _P] + [_I] * 5 + [_P, _P],
    # mat, q, offs, n, d, reps, dtype, grid, out, stream
    "rv_probe_dyn_dma": [_P] * 3 + [_I] * 5 + [_P, _P],
    # tab, idx, n, iters, in_smem, out, stream
    "rv_probe_gather": [_P, _P] + [_I] * 3 + [_P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = 0.0   # wall time of the last build in this process (0 if cached)
# ptxas's report of the last build in this process, by source file name:
# each kernel's registers, shared memory and spill bytes (`-Xptxas -v`)
ptxas_log: dict[str, str] = {}

# Kernel launches per wrapper: each wrapper adds one right where it
# launches its kernel, and nowhere else, so a run can show which kernels
# its main path went through.
# `flash_attn` and `flash_attn_relbias` count the [B, H, S, D] attention's
# two modes apart: plain (the ViT past the heads-in-lanes envelope) and
# with SAM's decomposed rel-pos bias; `topk_stream`, `topk_masked`,
# `topk_int8` and `topk_binary` the top-k kernel's modes: bf16/fp32 rows
# without and with a row mask, int8 rows (masked or not), packed sign
# bits; `topk_stream_f32` the launches on fp32 rows of either of the first
# two (the split mode); `topk_int8_rows` its per-row-scale int8 candidate scan (the
# two-stage search's first stage); `fused_mlp_int8` the MLP's int8 mode.
# `flash_heads`, `flash_attn`, `flash_attn_relbias` and `fused_mlp` count
# every launch of their mode; `flash_heads_tc`, `flash_attn_tc` and
# `flash_attn_relbias_tc` only those that went to the bf16 tensor-core
# attention core (csrc/flash_tc.cuh, through TMA or the lanes' copy),
# `flash_heads_split`, `flash_attn_split` and `flash_attn_relbias_split`
# those that went to its fp32 split mode (csrc/flash_heads_split.cu,
# flash_attn_split.cu), `fused_mlp_tc` the bf16 MLP calls and
# `fused_mlp_split` the fp32 ones that went to the wgmma GEMMs (one count
# per MLP call, not per GEMM); `split_parts` the split pass's launches
# outside an MLP call (the weights' parts, the bf16 MLP's padded copies,
# the fp32 top-k's query parts). `flash_heads_bwd` and `fused_mlp_bwd`
# count the backward kernels of K3 and K4 (one per backward call), and one
# counter per route says which: `flash_heads_bwd_tc` and `fused_mlp_bwd_tc`
# the bf16 wgmma + TMA kernels (K3's is three kernels a call, K4's one;
# widths TMA cannot take on zero-padded copies), `flash_heads_bwd_split`
# and `fused_mlp_bwd_split` the same kernels' fp32 split mode (K3's three
# kernels a call; K4's the split pass of x and dY, then the kernel).
# `probe_dma`, `probe_mxu`, `probe_scan`, `probe_dyn_dma` and
# `probe_gather` count the hardware probes' kernels (`probes/`, P1-P5).
# `add_layernorm` counts the tower's fused residual + LayerNorm passes
# (`ops/norm.py`, one a norm site).
launches = {"flash_heads": 0, "fused_mlp": 0, "topk_stream": 0,
            "flash_attn": 0, "flash_attn_relbias": 0, "ms_deform": 0,
            "topk_masked": 0, "topk_int8": 0, "topk_binary": 0, "ivf_scan": 0,
            "fused_mlp_int8": 0, "topk_int8_rows": 0, "flash_heads_tc": 0,
            "flash_attn_tc": 0, "flash_attn_relbias_tc": 0, "flash_attn_split": 0,
            "flash_attn_relbias_split": 0, "fused_mlp_tc": 0, "topk_stream_f32": 0,
            "flash_heads_split": 0, "fused_mlp_split": 0, "split_parts": 0,
            "flash_heads_bwd": 0, "fused_mlp_bwd": 0, "flash_heads_bwd_tc": 0,
            "flash_heads_bwd_split": 0, "fused_mlp_bwd_tc": 0, "fused_mlp_bwd_split": 0,
            "probe_dma": 0, "probe_mxu": 0, "probe_scan": 0, "probe_dyn_dma": 0,
            "probe_gather": 0, "add_layernorm": 0}
# Launches per (kernel, shape) of the kernels whose time depends most on the
# call's shape, so that a run can weigh each launch at the shape it ran
# at: {("fused_mlp_int8", (T, W, H, dtype)): n, ("fused_mlp_split", (T, W,
# H)): n, ("fused_mlp_tc", (T, W, H, act)): n, ("flash_heads_bwd", (B, S, W,
# heads, rope, dtype)): n, ("fused_mlp_bwd", (T, W, H, act, dtype)): n,
# ("flash_heads_split", (B, S, W, heads)): n, ("flash_heads_tc", (B, S, W,
# heads, rope)): n, ("ms_deform", (B,
# Lq, level shapes, H, D, P, dtype)): n, (top-k counter, (Q, n_valid, d, k,
# masked)): n, ("ivf_scan", (Q, nprobe, d, k, masked, mode)): n,
# ("add_layernorm", (T, W, dtype, residual, scaled)): n}, fp32-row top-k
# launches under "topk_stream_f32"
# (`ops/topk.py::launch_key`). Counted beside `launches`, which stays the
# per-kernel count.
shape_launches: collections.Counter = collections.Counter()
# Shape-rule dispatches of CUDA tensors to a plain version: k above the
# top-k kernel's cap; int8 k above the cap or d above the exactness bound
# (1040); binary k above the cap; an IVF fetch (2k under spill) above it;
# a norm site whose dtype or width the fused pass does not take.
plain_dispatches = {"topk_above_cap": 0, "int8_above_cap_or_wide": 0,
                    "binary_above_cap": 0, "ivf_fetch_above_cap": 0, "norm_shape": 0}


def reset_counts() -> None:
    for d in (launches, plain_dispatches):
        for key in d:
            d[key] = 0
    shape_launches.clear()


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(force: bool = False) -> str:
    """Compile `csrc/*.cu` into `_build/libreverso_kernels.so` if it is
    missing or older than a source: one `nvcc -c` per source, all running
    at once, then one link. Returns the library path."""
    global build_seconds
    if not force and not _stale():
        return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, errors = [], []
    ptxas_log.clear()
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        objs.append(obj)
        ptxas_log[os.path.basename(cmd[-1])] = out + err
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{out}\n{err}")
    tmp = f"{LIB_PATH}.{tag}"
    if not errors:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, LIB_PATH)   # atomic: a concurrent build never sees a torn file
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, status: int) -> None:
    if status == UNSUPPORTED:
        raise ValueError(f"{name}: shape or dtype not supported by the kernel")
    if status == MAP_ERROR:
        raise RuntimeError(f"{name}: the TMA tensor map could not be encoded")
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def grad_recorded(*tensors) -> bool:
    """Whether autograd records a call on these tensors: grad mode on and
    one of them (None skipped) requires grad. Never under
    `torch.inference_mode()` or `no_grad`, so the serving forwards launch
    as they did without autograd."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype and layout checks shared by the kernel wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
