"""Least times of the port's kernels at given shapes, against the data
sheet's peaks of one NVIDIA H100 SXM (dense, at 700 W).

Frozen copies of `chip_smoke.py`'s `bound`, `heads_bound`, `mlp_bound`,
`topk_bound`, `heads_bwd_bound` and `mlp_bwd_bound` (the repository's
smoke script, as of the benchmark's first version). Each returns (least
time in ms, "bytes" or "operations", whichever bounds it).
"""
from __future__ import annotations

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W); fp32
# products at fp32 accuracy: six bf16 tensor-core passes of three-way
# split operands, 989 / 6 TFLOP/s; "float32": work that is not products
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12, "float32_split": 989e12 / 6,
              "int8": 1979e12}


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations
    over the peak rate of `dtype`, in ms."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def heads_bound(b: int, s: int, w: int, heads: int, itemsize: int,
                dtype: str, rope: bool = True) -> tuple[float, str]:
    """K3 on [B, S, W]: q, k, v read and o written once, the two fp32 RoPE
    tables read once where the call rotates; 4 B H S^2 hd operations."""
    hd = w // heads
    tables = 2 * s * hd * 4 if rope else 0
    return bound(4 * b * s * w * itemsize + tables, 4 * b * heads * s * s * hd, dtype)


def mlp_bound(t: int, w: int, hid: int, itemsize: int, dtype: str) -> tuple[float, str]:
    """K4 at [T, W] -> H -> W: x read and y written, both weights and both
    biases read once; 4 T W H operations."""
    return bound((2 * t * w + 2 * hid * w + hid + w) * itemsize, 4 * t * w * hid, dtype)


def topk_bound(kind: str, q: int, n: int, d: int, k: int, masked: bool) -> tuple[float, str]:
    """A top-k scan: the rows, the mask, the queries and the [Q, k]
    results once; 2 Q N d operations (fp32 rows at the split rate; int8
    twice, one per query digit)."""
    if kind == "topk_stream_f32":
        return bound(n * d * 4 + (n if masked else 0) + q * d * 4 + q * k * 8, 2 * q * n * d,
                     "float32_split")
    if kind == "topk_int8":
        return bound(n * d + (n if masked else 0) + 2 * q * d + q * k * 8, 2 * 2 * q * n * d,
                     "int8")
    rows = n * d // 8 if kind == "topk_binary" else n * d * 2
    return bound(rows + (n if masked else 0) + q * d * 2 + q * k * 8, 2 * q * n * d, "bfloat16")


def heads_bwd_bound(b: int, s: int, w: int, heads: int, itemsize: int,
                    dtype: str, rope: bool = True) -> tuple[float, str]:
    """K3's backward on [B, S, W]: q, k, v and dO read and dq, dk, dv
    written once, the RoPE tables read once; five products of B H S^2 hd
    multiply-adds, 10 B H S^2 hd operations."""
    hd = w // heads
    tables = 2 * s * hd * 4 if rope else 0
    return bound(7 * b * s * w * itemsize + tables, 10 * b * heads * s * s * hd, dtype)


def mlp_bwd_bound(t: int, w: int, hid: int, itemsize: int, dtype: str,
                  kernel_only: bool = False) -> tuple[float, str]:
    """K4's backward at [T, W] -> H -> W. The whole gradient: x, dY, W1, b1
    and W2 read, dx, dW1, db1, dW2 and db2 written; 10 T W H operations.
    The kernel alone: x, dY, W1, b1 and W2 read, h and dz written; 4 T W H."""
    reads = 2 * t * w + 2 * w * hid + hid
    if kernel_only:
        return bound((reads + 2 * t * hid) * itemsize, 4 * t * w * hid, dtype)
    return bound((reads + t * w + 2 * w * hid + hid + w) * itemsize, 10 * t * w * hid, dtype)
