"""Exact top-k search: the streaming CUDA kernel and its plain versions.

The database is a device-resident [N, d] matrix: L2-normalized bf16 or
fp32 rows (fp32 accumulation; fp32 rows at the TPU kernel's
Precision.HIGHEST), or int8 rows with one global scale, scored exactly
against a two-digit int8 split of each query. Results are ordered by
(-score, index): ties go to the lower row, rows at or past `n_valid` and
rows whose `row_mask` entry is False never score, and slots beyond the
scoring rows come back as (score -inf, idx -1). On a CUDA tensor
`cosine_topk` and `cosine_topk_int8_exact` launch `csrc/topk_stream.cu`,
whose two passes never materialize the [Q, N] score matrix; on a CPU
tensor they run `cosine_topk_ref` / `cosine_topk_int8_ref`.

Every launch runs the kernel's wgmma + TMA scan, `topk_scan_wg_kernel`,
in the mode `wg_mode` names: bf16 rows (K1, K2 with a row mask), fp32
rows in the split mode (K1, K2: each row value split into three bf16
parts in registers, against the query's three parts from the split pass,
`ops/split.py`; six bf16 products a step), packed sign rows (K10,
`ops/binary.py`) and int8 rows (K9 here, K12 in `ops/topk_int8.py`; s8
wgmma with exact s32 sums). Each CTA scores 256-row tiles (128 where the
accumulator is wider than 64 columns) against a block of up to 128
queries, 64 in the int8 modes (K9's two query digits make the
accumulator twice as wide; K12's k-select runs over fewer lists)
(`wg_plan`; Q above a block runs as several blocks, each reading the
rows again). Rows whose stride or base TMA cannot take are copied by the
kernel's producer warp.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..parallel.sharding import Mesh, Shards, on_device, shard_rows
from ..utils.logging import get_logger
from .split import split_parts

log = get_logger("ops.topk")

# k cap of the CUDA kernel (TOPK_KMAX in csrc/topk_select.cuh)
K_CAP = 128
# the wgmma scan's geometry (scan_wg:: in csrc/topk_stream.cu); its modes
# (kMode*): K1/K2 on bf16 rows, K10, K9, K12, K1/K2 on fp32 rows
WG_BF16, WG_BINARY, WG_INT8, WG_INT8_ROWS, WG_F32 = 0, 1, 2, 3, 4
WG_ROWS = 128        # rows of a tile per m64 tile of each warpgroup (wg_m_tiles)
WG_SLOT_BYTES = 16384   # the candidate slots of a query block
WG_MAX_STAGES = 8
WG_N_MAX = 128       # queries of a block
WG_N_MAX_INT8 = 64   # the int8 modes' (kNMaxI8): K9's 2N-wide accumulator, K12's select
SMEM_MAX = 232448    # shared memory a CTA may use (227 KB)
# int8 exactness: every digit's dot (and each partial sum) is an integer of
# magnitude <= d * 127^2, exact in fp32 only below 2^24, i.e. d <= 1040
INT8_D_MAX = (2 ** 24 - 1) // (127 * 127)
_CHUNK_ROWS = 65536   # rows per step of the chunked plain scans


def _select_topk(scores: torch.Tensor, k: int):
    """Exact (-score, idx)-ordered top-k of each row of [Q, N] fp32 scores.
    `torch.topk` picks any of several equal scores at the k-th place; the
    boundary ties are re-picked as the lowest indices."""
    vals, _ = torch.topk(scores, k, dim=1)
    kth = vals[:, -1:]
    eq = scores == kth
    need = k - (scores > kth).sum(dim=1, keepdim=True)
    sel = (scores > kth) | (eq & (torch.cumsum(eq.to(torch.int32), dim=1) <= need))
    cols = torch.nonzero(sel)[:, 1].reshape(scores.shape[0], k)  # ascending
    s = scores.gather(1, cols)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    return s.gather(1, order), cols.gather(1, order)


def _finish(scores: torch.Tensor, k: int, ids: Optional[torch.Tensor] = None):
    """(-score, column)-ordered top-k of [Q, N] scores with the repo-wide
    padding: -inf slots hold -1, slots past N are (-inf, -1). `ids` [Q, N]
    maps columns to row ids (default: the column itself)."""
    q, n = scores.shape
    k_eff = min(k, n)
    if k_eff > 0:
        top_s, cols = _select_topk(scores, k_eff)
        top_i = cols if ids is None else ids.gather(1, cols)
        top_i = torch.where(torch.isneginf(top_s), -1, top_i)
    else:
        top_s = scores.new_empty((q, 0))
        top_i = torch.empty((q, 0), dtype=torch.int64, device=scores.device)
    if k_eff < k:
        top_s = torch.cat([top_s, top_s.new_full((q, k - k_eff), float("-inf"))], 1)
        top_i = torch.cat([top_i, top_i.new_full((q, k - k_eff), -1)], 1)
    return top_s.float(), top_i.to(torch.int32)


def _mask_scores(scores: torch.Tensor, n_valid: Optional[int], row_mask,
                 col0: int = 0) -> torch.Tensor:
    """-inf into the columns (rows col0 .. col0 + width) at or past n_valid
    and where row_mask is False."""
    width = scores.shape[1]
    if n_valid is not None and n_valid < col0 + width:
        scores[:, max(int(n_valid) - col0, 0):] = float("-inf")
    if row_mask is not None:
        keep = row_mask[col0:col0 + width].bool()
        scores.masked_fill_(~keep[None, :], float("-inf"))
    return scores


def as_row_mask(row_mask, n: int, device) -> Optional[torch.Tensor]:
    """A [>= n or < n] bool mask (host array or tensor) -> [n] uint8 on
    `device`; entries past the given mask are False."""
    if row_mask is None:
        return None
    m = torch.as_tensor(np.asarray(row_mask, bool) if not isinstance(
        row_mask, torch.Tensor) else row_mask).to(device=device, dtype=torch.uint8)
    if m.shape[0] < n:
        m = torch.cat([m, m.new_zeros(n - m.shape[0])])
    return m[:n].contiguous()


def cosine_topk_ref(db: torch.Tensor, queries: torch.Tensor, k: int,
                    n_valid: Optional[int] = None, row_mask=None):
    """Exact top-k by full score materialization.

    db: [N, d] L2-normalized. queries: [Q, d] L2-normalized. `row_mask`
    ([N] bool/uint8) excludes rows: the result equals the exact scan over
    the subset. Returns (scores [Q, k] f32, idx [Q, k] int32), ordered by
    (-score, idx).
    """
    scores = torch.matmul(queries.to(db.dtype).float(), db.float().t())
    return _finish(_mask_scores(scores, n_valid, row_mask), k)


def split_count(sms: int, q_blocks: int, n_valid: int, row_tile: int) -> int:
    """About two waves of CTAs: 2 * sms / q_blocks row splits, at most one
    per row tile."""
    n_row_tiles = max(1, -(-n_valid // row_tile))
    return max(1, min(-(-2 * sms // q_blocks), n_row_tiles))


def wg_cand(n: int) -> int:
    """Candidate slots per query of an n-query block (scan_wg::cand_slots):
    16 KB of (score, row) pairs, 8 to 32 a query."""
    return max(8, min(32, WG_SLOT_BYTES // 8 // n))


def wg_width(n: int, mode: int) -> int:
    """The accumulator's columns at query block n (scan_wg::width): K9's
    hi and lo digits are one B operand of 2n rows."""
    return 2 * n if mode == WG_INT8 else n


def wg_m_tiles(w: int) -> int:
    """m64 tiles a consumer warpgroup holds at accumulator width w
    (scan_wg::m_tiles): two (256-row tiles) at w <= 64, one at 128."""
    return 2 if w <= 64 else 1


def wg_query_bytes(n: int, mode: int) -> int:
    """Bytes of the query block's B operand a ring stage holds
    (scan_wg::query_bytes): [wg_width(n)][128 B], or in the fp32 mode
    the three bf16 parts of 32 dims, [3][n][64 B]."""
    return 3 * n * 64 if mode == WG_F32 else wg_width(n, mode) * 128


def wg_smem(n: int, k: int, mode: int, stages: int, ivf: bool = False) -> int:
    """Shared memory of one wgmma scan CTA (scan_wg::smem_bytes): 1 KB of
    alignment, the ring (a stage holds 128 bytes of each row but in binary
    mode, [128 m][128 B] with m = wg_m_tiles(wg_width(n)), then the query
    block's B operand, `wg_query_bytes`, rounded up to 1 KB), binary
    mode's two-slot ring of packed row chunks ([128 m][128 B] each), the
    sorted lists ([n][k | 1] score, index pairs), the candidate slots, the
    k-th entries and counts, the query scales (K12's, and the IVF scan's
    in int8: `ivf`), the 8 consumer warps' merge scratch (128 pairs each),
    and the barriers. `mode` is one of WG_BF16, WG_BINARY (or False /
    True), WG_INT8, WG_INT8_ROWS, WG_F32."""
    w = wg_width(n, mode)
    rows = WG_ROWS * wg_m_tiles(w)
    ring = stages * ((0 if mode == WG_BINARY else rows * 128)
                     + -(-wg_query_bytes(n, mode) // 1024) * 1024)
    chunks = 2 * rows * 128 if mode == WG_BINARY else 0
    scales = 4 * n if mode == WG_INT8_ROWS or (ivf and mode == WG_INT8) else 0
    return (1024 + chunks + ring + n * (8 * (k | 1) + 8 * wg_cand(n) + 12) + scales
            + 8 * 8 * K_CAP + 16 * (WG_MAX_STAGES + 2))


def wg_plan(qn: int, k: int, mode: int, ivf: bool = False) -> tuple[int, int, int]:
    """(n_pad, q_blocks, stages) of a wgmma scan launch (scan_wg::plan).

    The query block is the widest power of two <= 128 (64 in the int8
    modes) whose sorted lists fit beside a two-stage ring (the cap at
    every k <= 128); Q runs as ceil(Q / block) blocks of equal size, each
    padded to the power of two n_pad >= its size (wgmma's N, 8 at Q = 1),
    and the ring takes as many stages (2-8) as fit. `ivf`: the IVF
    scan's shared memory (`wg_smem`)."""
    nmax = WG_N_MAX_INT8 if mode in (WG_INT8, WG_INT8_ROWS) else WG_N_MAX
    while nmax > 8 and wg_smem(nmax, k, mode, 2, ivf) > SMEM_MAX:
        nmax //= 2
    q_blocks = -(-qn // nmax)
    per = -(-qn // q_blocks)
    n_pad = 8
    while n_pad < per:
        n_pad *= 2
    stages = 2
    while stages < WG_MAX_STAGES and wg_smem(n_pad, k, mode, stages + 1, ivf) <= SMEM_MAX:
        stages += 1
    return n_pad, q_blocks, stages


def wg_splits(dev: torch.device, qn: int, k: int, n_valid: int, mode: int) -> int:
    """Row splits of a wgmma scan launch: `split_count` over the plan's
    query blocks and row tile (the launcher then caps them at one wave)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_pad, q_blocks, _ = wg_plan(qn, k, mode)
    return split_count(sms, q_blocks, n_valid, WG_ROWS * wg_m_tiles(wg_width(n_pad, mode)))


def wg_mode(mode: int) -> int:
    """The wgmma scan's mode for a `rv_topk_stream` launch (every launch
    takes the scan; rows TMA cannot take are copied by its producer warp)."""
    return {kernels.DTYPE_CODES[torch.bfloat16]: WG_BF16,
            kernels.DTYPE_CODES[torch.float32]: WG_F32,
            kernels.BINARY_PACKED: WG_BINARY, kernels.INT8: WG_INT8}[mode]


def launch_key(counter: str, dtype: torch.dtype, shape: tuple) -> tuple:
    """The `kernels.shape_launches` key of a top-k launch: its counter and
    its shape (Q, n_valid, dims, k, masked). Launches on fp32 rows, masked
    or not, count under "topk_stream_f32", so that a shape is always timed
    on rows of the dtype it ran on."""
    return ("topk_stream_f32" if dtype == torch.float32 else counter, shape)


def tma_rows(x: torch.Tensor) -> torch.Tensor:
    """Query operand rows for TMA: the last dim zero-padded to a multiple
    of 16 bytes (16 int8 or 8 bf16 values), contiguous and 16-byte aligned
    (a copy only where needed; zeros add nothing to a dot)."""
    per = 16 // x.element_size()
    d = x.shape[-1]
    w = -(-d // per) * per
    if w == d and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((*x.shape[:-1], w))
    out[..., :d] = x
    return out


def _launch_topk(name: str, counter: str, db: torch.Tensor, q: torch.Tensor,
                 k: int, n_valid: int, mode: int, row_mask=None, dims: Optional[int] = None):
    """Launch csrc/topk_stream.cu in `mode` (q: the operand that mode takes,
    [Q, d'] or [parts, Q, d']); returns (scores, idx) [Q, k]. Counts the
    launch in `kernels.launches[counter]` (a scan of fp32 rows in
    "topk_stream_f32" too) and, by shape (Q, n_valid, dims, k, masked;
    `dims` the scored dimensions, default d), in `kernels.shape_launches`
    under `launch_key`."""
    kernels.require_cuda(name, db, q, *([row_mask] if row_mask is not None else []))
    d = db.shape[1]
    qn = q.shape[-2]
    dev = db.device
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_s, out_i
    n_splits = wg_splits(dev, qn, k, n_valid, wg_mode(mode))
    part_s = torch.empty((n_splits, qn, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, qn, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):   # launch on the tensors' card
        status = kernels.lib().rv_topk_stream(
            db.data_ptr(), q.data_ptr(),
            row_mask.data_ptr() if row_mask is not None else None,
            d, qn, n_valid, k, n_splits, part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), mode, kernels.stream_ptr(dev))
    kernels.check(name, status)
    kernels.launches[counter] += 1
    if db.dtype == torch.float32:
        kernels.launches["topk_stream_f32"] += 1
    shape = (qn, n_valid, dims or d, k, row_mask is not None)
    kernels.shape_launches[launch_key(counter, db.dtype, shape)] += 1
    return out_s, out_i


def cosine_topk(db: torch.Tensor, queries: torch.Tensor, k: int,
                n_valid: Optional[int] = None, row_mask=None):
    """Fused exact cosine top-k; same contract as `cosine_topk_ref`.

    Queries are cast to the database dtype. With `row_mask` a CUDA search
    runs the kernel's masked mode (K2). Above the kernel's k cap (K_CAP) a
    CUDA search takes the plain version — a shape rule, logged and counted
    in `kernels.plain_dispatches`."""
    n, d = db.shape
    queries = queries.to(db.dtype)
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} do not match db "
                         f"{tuple(db.shape)}")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    mask = as_row_mask(row_mask, n, db.device)
    if db.device.type == "cpu":
        return cosine_topk_ref(db, queries, k, n_valid=n_valid, row_mask=mask)
    if k > K_CAP:
        log.info(f"k={k} above the top-k kernel cap {K_CAP}: plain scan")
        kernels.plain_dispatches["topk_above_cap"] += 1
        return cosine_topk_ref(db, queries, k, n_valid=n_valid, row_mask=mask)
    if db.dtype not in kernels.DTYPE_CODES:
        raise ValueError(f"cosine_topk: unsupported dtype {db.dtype}")
    # fp32: the query's three bf16 parts, [3, Q, d rounded up to 8]; bf16:
    # the query rows at a 16-byte pitch
    q = split_parts(queries, 3) if db.dtype == torch.float32 else tma_rows(queries)
    return _launch_topk("cosine_topk", "topk_masked" if mask is not None else "topk_stream",
                        db, q, k, n_valid, kernels.DTYPE_CODES[db.dtype], mask)


# ---------------------------------------------------------------------------
# int8-stored exact search (K9)
# ---------------------------------------------------------------------------

def quantize_db_int8(db):
    """Symmetric global int8 quantization of an embedding matrix.

    Returns (v8 [N, d] int8, scale 0-d f32) with db ~= scale * v8. The int8
    matrix IS the stored database: searches are exact with respect to it.
    Rounds `db * (127 / amax)` (an fp32 multiply by the inverse, as the
    JAX package does: a division can land one ulp off at halfway points)."""
    db32 = torch.as_tensor(db).float()
    amax = torch.clamp(db32.abs().max(), min=1e-30)
    inv = 127.0 / amax
    v8 = torch.clamp(torch.round(db32 * inv), -127, 127).to(torch.int8)
    return v8, amax / 127.0


def int8_clip_bound(values: np.ndarray, quantile: float) -> np.float32:
    """Host-side clipping bound for symmetric int8 quantization.

    `quantile == 0` (the default everywhere) returns the exact abs-max
    — nothing clips. With 0 < quantile < 1, returns that abs-value
    quantile over a deterministic stride sample of the matrix, the
    role of qdrant ScalarQuantization's `quantile` parameter: long-tail
    outliers saturate to +-127 and the remaining 254 steps resolve the
    bulk of the distribution more finely. The int8-exact search
    contract is unaffected either way — scores are exact with respect
    to the STORED int8 rows, however they were rounded."""
    a = np.abs(np.asarray(values, np.float32))
    if quantile and a.size:
        if not 0.0 < quantile < 1.0:
            raise ValueError(
                f"int8 quantile must be in (0, 1), got {quantile}")
        flat = a.reshape(-1)
        stride = max(1, flat.size // (1 << 22))   # deterministic sample
        bound = np.quantile(flat[::stride], quantile)
        return np.float32(max(bound, 1e-30))
    return np.float32(max(a.max(initial=0.0), 1e-30))


def int8_query_digits(queries: torch.Tensor):
    """Two-digit int8 query decomposition for the exact int8 scans.

    q ~= c1*q_hi + c2*q_lo with c1 = 254*c2 (c1 from the per-query abs-max,
    1e-30 floored): two s8 dots combine to an exact ~15-bit-query-precision
    f32 score. Scales are PER-QUERY — positive scaling leaves each row's
    (-score, idx) order untouched, so the scans rank unscaled combined dots
    and the caller restores true scores with row_scale = c2 * db_scale.
    fp32 divisions and separately rounded multiply and subtract, as the
    JAX package computes them eagerly.
    Returns (q_hi [Q, d] i8, q_lo [Q, d] i8, c2 [Q, 1] f32)."""
    qs32 = queries.float()
    c1 = torch.clamp(qs32.abs().amax(dim=1, keepdim=True), min=1e-30) / 127.0
    c2 = c1 / 254.0
    q_hi = torch.clamp(torch.round(qs32 / c1), -127, 127).to(torch.int8)
    resid = qs32 - q_hi.float() * c1
    q_lo = torch.clamp(torch.round(resid / c2), -127, 127).to(torch.int8)
    return q_hi, q_lo, c2


def int8_combine(s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """f32(s_hi) * 254 + f32(s_lo), rounded after the multiply and again
    after the add (two eager ops: nothing contracts them into one FMA)."""
    return s_hi.float() * 254.0 + s_lo.float()


def _int8_dots(db_i8: torch.Tensor, q_hi: torch.Tensor, q_lo: torch.Tensor):
    """Exact [Q, N] digit dots as fp32 integers: every partial sum is an
    integer of magnitude below 2^24 (d <= INT8_D_MAX), so fp32 sums are
    exact in any order."""
    rows = db_i8.float()
    return q_hi.float() @ rows.t(), q_lo.float() @ rows.t()


def _scale(scores: torch.Tensor, idx: torch.Tensor, c2, db_scale):
    """Unscaled (-score, idx)-ordered int8 results -> true scores."""
    row_scale = c2 * torch.as_tensor(db_scale, dtype=torch.float32, device=c2.device)
    scores = scores * row_scale
    return scores, torch.where(torch.isneginf(scores), -1, idx)


def _check_int8(db_i8: torch.Tensor, k: int) -> None:
    if db_i8.dtype != torch.int8:
        raise ValueError(f"int8 scan needs an int8 matrix, got {db_i8.dtype}")
    if k > K_CAP:
        raise ValueError(f"int8-exact scan supports k <= {K_CAP}")
    if db_i8.shape[1] > INT8_D_MAX:
        raise ValueError(
            f"int8-exact scan requires d <= {INT8_D_MAX} for exact f32 partials "
            f"(got d={db_i8.shape[1]}); use cosine_topk_int8_xla for larger dims")


def cosine_topk_int8_ref(db_i8: torch.Tensor, db_scale, queries: torch.Tensor,
                         k: int, n_valid: Optional[int] = None, row_mask=None):
    """Plain version of the int8-exact kernel (K9): the same two-digit math.

    Ranks the unscaled combined dots f32(hi) * 254 + f32(lo) by (-score,
    idx) over the rows below n_valid that row_mask keeps, then scales each
    query's scores by c2 * db_scale. Returns (scores [Q, k] f32, idx int32)."""
    _check_int8(db_i8, k)
    q_hi, q_lo, c2 = int8_query_digits(queries)
    s_hi, s_lo = _int8_dots(db_i8, q_hi, q_lo)
    mask = as_row_mask(row_mask, db_i8.shape[0], db_i8.device)
    s, i = _finish(_mask_scores(int8_combine(s_hi, s_lo), n_valid, mask), k)
    return _scale(s, i, c2, db_scale)


def cosine_topk_int8_exact(db_i8: torch.Tensor, db_scale, queries: torch.Tensor,
                           k: int, n_valid: Optional[int] = None, row_mask=None):
    """Exact cosine top-k over an int8-stored database (K9).

    db_i8 [N, d] int8 with d <= INT8_D_MAX and its `quantize_db_int8`
    scale; queries [Q, d] in any float dtype (used in fp32). Same contract
    as `cosine_topk_ref`; scores are deterministic f32 cosines against the
    dequantized stored rows. A CUDA matrix launches the kernel's int8 mode,
    a CPU one runs `cosine_topk_int8_ref`."""
    _check_int8(db_i8, k)
    n, d = db_i8.shape
    if queries.ndim != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} do not match db "
                         f"{tuple(db_i8.shape)}")
    n_valid = n if n_valid is None else max(0, min(int(n_valid), n))
    if db_i8.device.type == "cpu":
        return cosine_topk_int8_ref(db_i8, db_scale, queries, k, n_valid, row_mask)
    q_hi, q_lo, c2 = int8_query_digits(queries)
    digits = tma_rows(torch.stack([q_hi, q_lo]))   # [2, Q, d rounded up to 16]
    s, i = _launch_topk("cosine_topk_int8_exact", "topk_int8", db_i8, digits, k,
                        n_valid, kernels.INT8, as_row_mask(row_mask, n, db_i8.device))
    return _scale(s, i, c2, db_scale)


def scan_topk(score_chunk, n: int, qn: int, k: int, device, *,
              n_valid: Optional[int] = None, row_mask=None,
              chunk: int = _CHUNK_ROWS):
    """Exact top-k of a score matrix that is never materialized: `score_chunk(lo,
    hi)` gives the [Q, hi - lo] fp32 scores of rows lo..hi, merged chunk by
    chunk into a running (-score, idx) top-k. Rows at or past `n_valid` and
    rows `row_mask` drops score -inf; results are padded as `_finish` pads.
    The chunked plain scans (int8 past the kernel's bounds, Manhattan, PQ)
    run on it."""
    mask = as_row_mask(row_mask, n, device)
    n_valid = n if n_valid is None else int(n_valid)
    k_eff = min(k, n)
    top_s = torch.empty((qn, 0), device=device)
    top_i = torch.empty((qn, 0), dtype=torch.int64, device=device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = _mask_scores(score_chunk(lo, hi), n_valid, mask, lo)
        # the carry (lower ids) precedes the chunk: column order is id order
        all_s = torch.cat([top_s, s], 1)
        all_i = torch.cat([top_i, torch.arange(lo, hi, device=device).expand(qn, -1)], 1)
        top_s, cols = _select_topk(all_s, min(k_eff, all_s.shape[1]))
        top_i = all_i.gather(1, cols)
    return _finish(top_s, k, ids=top_i)


def cosine_topk_int8_xla(db_i8: torch.Tensor, db_scale, queries: torch.Tensor,
                         k: int, n_valid: Optional[int] = None, row_mask=None, *,
                         chunk: int = _CHUNK_ROWS):
    """Exact top-k over an int8 database, any k and d: fp32 queries against
    the rows dequantized one chunk at a time (`rows * scale`, `scan_topk`),
    so the full fp32 matrix never exists. The counterpart of the JAX
    package's `cosine_topk_int8_xla`; the index takes it above the kernel's
    k cap or past d = INT8_D_MAX."""
    q32 = queries.float()
    scale = torch.as_tensor(db_scale, dtype=torch.float32, device=db_i8.device)
    return scan_topk(lambda lo, hi: q32 @ (db_i8[lo:hi].float() * scale).t(),
                     db_i8.shape[0], q32.shape[0], k, db_i8.device, n_valid=n_valid,
                     row_mask=row_mask, chunk=chunk)


def dot_topk(db: torch.Tensor, queries: torch.Tensor, k: int,
             n_valid: Optional[int] = None, row_mask=None, db_scale=None):
    """The exact dot top-k of one matrix as the index stores it: bf16 or
    fp32 rows on `cosine_topk` (K1, K2), int8 rows on
    `cosine_topk_int8_exact` (K9) with their global `db_scale`, or, above
    the kernel's k cap or past d = INT8_D_MAX, on the chunked plain scan
    (a counted shape rule on the card)."""
    if db.dtype != torch.int8:
        return cosine_topk(db, queries, k, n_valid=n_valid, row_mask=row_mask)
    if k > K_CAP or db.shape[1] > INT8_D_MAX:
        if db.device.type == "cuda":
            log.info(f"int8 k={k} d={db.shape[1]} past the kernel's bounds: chunked scan")
            kernels.plain_dispatches["int8_above_cap_or_wide"] += 1
        return cosine_topk_int8_xla(db, db_scale, queries, k, n_valid=n_valid,
                                    row_mask=row_mask)
    return cosine_topk_int8_exact(db, db_scale, queries, k, n_valid=n_valid,
                                  row_mask=row_mask)


# ---------------------------------------------------------------------------
# Sharded search (rows sharded over a mesh of devices, parallel/sharding.py)
# ---------------------------------------------------------------------------

def merge_order(scores: torch.Tensor, keys: torch.Tensor, k: int) -> torch.Tensor:
    """The columns [Q, k] of candidates [Q, C] (C >= k) in (-score, key)
    order: two stable sorts, the key first. -inf candidates sort last."""
    by_key = torch.argsort(keys, dim=1, stable=True)
    by_score = torch.sort(scores.gather(1, by_key), dim=1, descending=True,
                          stable=True).indices
    return by_key.gather(1, by_score)[:, :k]


def merge_topk(cands, k: int, device) -> tuple:
    """Merge (scores [Q, k'], global ids [Q, k']) candidate lists on
    `device` into the (-score, id)-ordered top-k: the single-device scan's
    order, since every row's score is the same on any shard (the
    counterpart of `all_gather` + lexsort in the JAX package's sharded
    scans)."""
    s = torch.cat([c[0].to(device) for c in cands], 1)
    i = torch.cat([c[1].to(device) for c in cands], 1)
    cols = merge_order(s, i.long(), k)
    return s.gather(1, cols), i.gather(1, cols).to(torch.int32)


def shard_candidates(shards: Shards, queries, k: int, scan, *,
                     n_valid: Optional[int] = None, row_mask=None) -> list:
    """Each shard's local top-k with global ids, on its own device:
    `scan(part, q, n_valid_p, mask_p)` runs shard p's scan under its
    device (`on_device`: a launcher launches on the current device) with
    the queries and the shard's slice of `row_mask` ([n] over global
    rows) copied there; a shard without valid rows scans nothing. The
    scans are queued one after another and run asynchronously, so shards
    on different cards overlap."""
    qs, out = {}, []
    mask = as_row_mask(row_mask, shards.n, queries.device) if row_mask is not None else None
    masks = shards.slices(mask) if mask is not None else [None] * len(shards.parts)
    for part, start, lv, m in zip(shards.parts, shards.starts, shards.local_valid(n_valid),
                                  masks):
        dev = part.device
        with on_device(dev):
            if lv == 0:
                out.append(_empty_topk(queries.shape[0], k, dev))
                continue
            if dev not in qs:
                qs[dev] = queries.to(dev)
            s, i = scan(part, qs[dev], lv, m)
            out.append((s, torch.where(i >= 0, i + start, -1)))
    return out


def _empty_topk(qn: int, k: int, device) -> tuple:
    return (torch.full((qn, k), float("-inf"), device=device),
            torch.full((qn, k), -1, dtype=torch.int32, device=device))


def as_shards(db, mesh: Mesh, axis="data") -> Shards:
    """`db` as row shards over the mesh's `axis` (a name or a tuple of
    names; sharded here when it is a whole tensor or host array)."""
    return db if isinstance(db, Shards) else shard_rows(db, mesh, axis)


def as_queries(queries) -> torch.Tensor:
    """[Q, d] or [d] host array or tensor -> [Q, d] tensor (where it is)."""
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(
        np.asarray(queries, np.float32))
    return q[None] if q.ndim == 1 else q


def _dot_scan(k: int, db_scale):
    return lambda part, q, lv, m: dot_topk(part, q, k, n_valid=lv, row_mask=m,
                                          db_scale=db_scale)


def sharded_cosine_topk(db, queries, k: int, mesh: Mesh, axis: str = "data",
                        impl: str = "auto", n_valid=None, db_scale=None, row_mask=None):
    """Top-k over a database row-sharded across `axis` of `mesh` (a
    `Shards`, or a whole matrix that is sharded here): each shard's scan
    (`dot_topk`: K1/K2 on bf16 and fp32 rows, K9 on int8 rows with the
    global `db_scale`) on its device with its own valid count, then one
    merge on the mesh's first device. `row_mask` ([n] bool over global
    rows) excludes rows exactly. `impl` names a TPU choice of the JAX
    package and is ignored. Returns (scores [Q, k] f32, idx [Q, k] int32),
    the single-device scan's result."""
    del impl
    cands = shard_candidates(as_shards(db, mesh, axis), as_queries(queries), k,
                             _dot_scan(k, db_scale), n_valid=n_valid, row_mask=row_mask)
    return merge_topk(cands, k, mesh.first)


def tree_merge_topk(db, queries, k: int, mesh: Mesh, *, ici_axis: str = "chip",
                    dcn_axis: str = "host", impl: str = "auto", n_valid=None,
                    db_scale=None):
    """Two-level top-k over rows sharded across BOTH mesh axes (the JAX
    package's multi-host layout): shard (host, chip) holds the rows of
    shard host * chips + chip; each host's chips merge on the host's first
    device, then the hosts' winners merge on the mesh's first device. The
    same result as one merge of every shard."""
    del impl
    shards = as_shards(db, mesh, (dcn_axis, ici_axis))
    cands = shard_candidates(shards, as_queries(queries), k, _dot_scan(k, db_scale),
                             n_valid=n_valid)
    chips = mesh.shape[ici_axis]
    hosts = [merge_topk(cands[h * chips:(h + 1) * chips], k, shards.parts[h * chips].device)
             for h in range(mesh.shape[dcn_axis])]
    return merge_topk(hosts, k, mesh.first)


def apply_score_threshold(scores: torch.Tensor, idx: torch.Tensor,
                          threshold: float):
    """Invalidate hits below threshold (keep score >= threshold).

    Returns (scores, idx, valid_mask); invalid idx slots become -1.
    """
    mask = scores >= threshold
    return scores, torch.where(mask, idx, torch.full_like(idx, -1)), mask
