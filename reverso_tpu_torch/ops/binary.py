"""Binary-quantized candidate scan (qdrant BinaryQuantization role).

A packed row holds one sign bit per dimension, d/8 bytes (16x less than
bf16). The scan scores the FULL-PRECISION query (cast to bf16) against
the rows' signs unpacked to {-1, +1}: candidate scores are
`sum_i q_i * sign(x_i)`, a monotone proxy for cosine on unit-normalized
data, NOT the true score. Callers that need true scores rescore the top
oversampling*k candidates against the f32 rows (the engine's rescore
adapter does, matching qdrant's semantics).

Result contract as every other scan: ordered by (-score, idx), ties to
the lower row id, -1 in absent slots. On a CUDA tensor `binary_topk`
launches the wgmma scan of `csrc/topk_stream.cu` in binary mode (K10, any
plane width W <= 1024: rows through TMA where W % 16 == 0, copied by its
producer warp otherwise), with the query permuted to the kernel's
dimension order (`kernel_order`); on a CPU tensor it runs
`binary_topk_ref`.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import kernels
from .topk import (K_CAP, _CHUNK_ROWS, _finish, _launch_topk, _mask_scores, as_queries,
                   as_row_mask, as_shards, log, merge_topk, shard_candidates)


def pack_signs(vectors, plane_width: Optional[int] = None):
    """[N, d] float -> [N, W] uint8 of sign bits (x > 0) in PLANAR layout:
    bit j of byte b is dimension j*W + b (W = plane_width, default
    ceil(d/8); dims >= d read as zeros -> bit 0). Plane j is then just
    `(packed >> j) & 1`, a full-width shifted copy, and the 8 planes
    concatenate along columns back into the original dimension order.
    Takes and returns a numpy array or a tensor (on its device); the bytes
    equal the JAX package's `pack_signs` at the same plane width."""
    is_np = not isinstance(vectors, torch.Tensor)
    v = torch.from_numpy(np.asarray(vectors)) if is_np else vectors
    n = v.shape[0]
    d = v.shape[1] if v.ndim == 2 and v.numel() else 0
    w = plane_width if plane_width is not None else max((d + 7) // 8, 1)
    if 8 * w < d:
        raise ValueError(f"plane_width {w} too small for d={d}")
    bits = torch.zeros((n, 8 * w), dtype=torch.uint8, device=v.device)
    bits[:, :d] = v > 0
    weights = (1 << torch.arange(8, device=v.device, dtype=torch.int32))
    packed = (bits.reshape(n, 8, w).to(torch.int32) * weights[None, :, None]).sum(1)
    packed = packed.to(torch.uint8)
    return packed.numpy() if is_np else packed


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """[C, W] planar uint8 -> [C, d] fp32 in {-1, +1} (bit -> 2b - 1)."""
    planes = [(packed >> j) & 1 for j in range(8)]
    u = torch.cat(planes, dim=1)[:, :d].float()
    return u * 2 - 1


def kernel_order(w: int) -> torch.Tensor:
    """The binary kernel's dimension order for plane width `w`: [8 * W16]
    int64 (W16 = w rounded up to 16), entry kappa the planar dimension
    b * w + p that the k loop's position kappa scores (-1: a padding byte).

    Byte p of a row (p = 8 s + 4 m + t) bit b sits at kappa = 64 s + 32 m +
    16 (b >> 2) + 8 ((b >> 1) & 1) + 2 t + (b & 1): the 8 bits of one byte
    are the 8 wgmma A-fragment values one consumer thread holds for two k16
    chunks of the 64-wide k step s (csrc/topk_stream.cu, scan_wg). A sum over dimensions does not
    depend on their order, so the query is permuted to match."""
    w16 = -(-w // 16) * 16
    p = torch.arange(w16).repeat_interleave(8)            # byte of each (p, b)
    b = torch.arange(8).repeat(w16)                       # its bit
    kappa = (64 * (p // 8) + 32 * (p % 8 // 4) + 16 * (b >> 2) + 8 * ((b >> 1) & 1)
             + 2 * (p % 4) + (b & 1))
    order = torch.full((8 * w16,), -1, dtype=torch.int64)
    order[kappa] = torch.where(p < w, b * w + p, -1)
    return order


def kernel_queries(queries: torch.Tensor, w: int) -> torch.Tensor:
    """[Q, d] queries -> [Q, 8 * W16] bf16 in the binary kernel's
    dimension order (`kernel_order`), zero at padding positions and at
    planar dimensions >= d."""
    cols = _kernel_columns(w, str(queries.device))
    qb = torch.zeros((queries.shape[0], 8 * w + 1), dtype=torch.bfloat16,
                     device=queries.device)
    qb[:, :queries.shape[1]] = queries
    return qb[:, cols]


@functools.lru_cache(maxsize=None)
def _kernel_columns(w: int, device: str) -> torch.Tensor:
    """`kernel_order(w)` on `device` with padding pointed at column 8w (a
    zero column), made once per (w, device): no host-to-card copy per call."""
    order = kernel_order(w)
    return torch.where(order >= 0, order, 8 * w).to(device)


def binary_topk_ref(packed: torch.Tensor, queries: torch.Tensor, k: int, d: int,
                    n_valid: Optional[int] = None, row_mask=None, *,
                    chunk: int = _CHUNK_ROWS):
    """Plain version of the binary scan (K10), the JAX package's
    `binary_topk_xla` math: bf16 queries against the unpacked +-1 rows,
    fp32 sums, over the rows below n_valid that row_mask keeps.

    packed: [N, W] uint8 (pack_signs layout, 8W >= d). queries: [Q, d].
    Returns (scores [Q, k] f32, idx [Q, k] int32)."""
    n = packed.shape[0]
    qb = queries.to(torch.bfloat16).float()
    mask = as_row_mask(row_mask, n, packed.device)
    scores = torch.cat([qb @ unpack_signs(packed[lo:lo + chunk], d).t()
                        for lo in range(0, n, chunk)], 1) if n else qb.new_empty((len(qb), 0))
    return _finish(_mask_scores(scores, n_valid, mask), k)


def binary_topk(packed: torch.Tensor, queries: torch.Tensor, k: int, d: int,
                n_valid: Optional[int] = None, row_mask=None):
    """Fused binary candidate top-k; same contract as `binary_topk_ref`.

    A CUDA matrix launches the wgmma scan's binary mode (the query cast to
    bf16 and permuted by `kernel_queries`); above the kernel's k cap a
    CUDA search takes the plain version, counted in
    `kernels.plain_dispatches["binary_above_cap"]`."""
    n, w = packed.shape
    if packed.dtype != torch.uint8 or 8 * w < d:
        raise ValueError(f"packed {tuple(packed.shape)} {packed.dtype} does not "
                         f"hold d={d} sign bits")
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} do not match d={d}")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if packed.device.type == "cpu":
        return binary_topk_ref(packed, queries, k, d, n_valid, row_mask)
    if k > K_CAP:
        log.info(f"k={k} above the top-k kernel cap {K_CAP}: plain binary scan")
        kernels.plain_dispatches["binary_above_cap"] += 1
        return binary_topk_ref(packed, queries, k, d, n_valid, row_mask)
    return _launch_topk("binary_topk", "topk_binary", packed, kernel_queries(queries, w), k,
                        n_valid, kernels.BINARY_PACKED,
                        as_row_mask(row_mask, n, packed.device), dims=d)


def sharded_binary_topk(packed, queries, k: int, d: int, mesh, axis: str = "data",
                        n_valid=None, row_mask=None):
    """Binary candidate top-k over packed rows row-sharded across `axis`
    (a `Shards`, or the whole packed matrix, sharded here): K10 on each
    shard (`binary_topk`) with its own valid count, then one (-score,
    global id) merge on the mesh's first device; the single-device scan's
    result."""
    cands = shard_candidates(
        as_shards(packed, mesh, axis), as_queries(queries).float(), k,
        lambda part, q, lv, m: binary_topk(part, q, k, d, n_valid=lv, row_mask=m),
        n_valid=n_valid, row_mask=row_mask)
    return merge_topk(cands, k, mesh.first)
