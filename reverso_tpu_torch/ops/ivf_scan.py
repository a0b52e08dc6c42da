"""Probed-cluster scan of the IVF index: the CUDA kernel and its plain versions.

For each (query, probe) only the probed cluster's rows of the
cluster-sorted matrix are scored (bf16/fp32 rows against the query, or
int8 rows against its two int8 digits, exact s32 dots combined as
f32(hi) * 254 + f32(lo) and times the query's scale), and each query keeps
its k best candidates ordered by (-score, probe rank, position within the
cluster): the order of the JAX package's probe loop
(`store/ivf.py::_ivf_search`), whose `scores_all` columns are
`probe * cmax + within`. Results are sorted-matrix rows; `store/ivf.py`
maps them to original row ids and applies the spill dedup.

On a CUDA matrix `ivf_probe_scan` (K11) runs cluster-major in one call
of `csrc/ivf_scan.cu`: a plan on the card inverts the (query, probe)
pairs into a work table of (row range, block of the pairs that probe
it) slices, the wgmma + TMA scan of `csrc/topk_stream.cu` walks it,
reading each probed cluster once per query block, and a merge orders
each query's lists. On a CPU matrix it runs `ivf_probe_scan_ref`, the
probe loop. `ivf_plan` is the plan's plain version, and
`ivf_cluster_major_ref` the decomposition's: its work table walked with
plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from .split import split_parts
from .topk import (K_CAP, WG_BF16, WG_F32, WG_INT8, WG_ROWS, _finish, int8_combine, log,
                   tma_rows, wg_m_tiles, wg_plan, wg_width)

# most (probe, split) lists a query's merge keeps heads for (12 bytes each
# in shared memory)
MERGE_LISTS = 4096


def ivf_probe_scan_ref(mat: torch.Tensor, queries: torch.Tensor, qdig,
                       row_scale, base: torch.Tensor, cnt: torch.Tensor, *,
                       k: int, cmax: int, int8: bool,
                       mask_sorted: Optional[torch.Tensor] = None):
    """The probe loop, one probe rank at a time: gather each query's
    [cmax, d] cluster slice, score it (fp32 sums; int8: exact digit dots,
    two-rounding combine, times row_scale), -inf past the cluster's count
    and where mask_sorted is False. Returns (scores [Q, k] f32, sorted-
    matrix rows [Q, k] int32, -1 past the candidates)."""
    qn, nprobe = base.shape
    dev = mat.device
    m = mat.shape[0]
    within = torch.arange(cmax, device=dev)
    scores_all = torch.full((qn, nprobe * cmax), float("-inf"), device=dev)
    pos_all = torch.full((qn, nprobe * cmax), -1, dtype=torch.int64, device=dev)
    for p in range(nprobe):
        b = base[:, p].long()[:, None]
        valid = within[None, :] < cnt[:, p].long()[:, None]          # [Q, cmax]
        rows_at = torch.where(valid, b + within[None, :], 0).clamp(max=max(m - 1, 0))
        rows = mat[rows_at].float()                                   # [Q, cmax, d]
        if int8:
            # exact: integer partial sums below 2^24 (d <= 1040)
            s_hi = torch.bmm(rows, qdig[0].float()[:, :, None])[..., 0]
            s_lo = torch.bmm(rows, qdig[1].float()[:, :, None])[..., 0]
            s = int8_combine(s_hi, s_lo) * row_scale.reshape(-1, 1)
        else:
            s = torch.bmm(rows, queries.float()[:, :, None])[..., 0]
        if mask_sorted is not None:
            valid = valid & mask_sorted[rows_at].bool()
        scores_all[:, p * cmax:(p + 1) * cmax] = torch.where(valid, s, float("-inf"))
        pos_all[:, p * cmax:(p + 1) * cmax] = torch.where(valid, b + within[None, :], -1)
    return _finish(scores_all, k, ids=pos_all)


def ivf_geometry(qn: int, nprobe: int, k: int, cmax: int, m: int, *, wg: int, sms: int):
    """(n_block, rps, splits) of a K11 launch, from what the host knows.

    n_block: the scan's query block, a power of two from 8: four times the
    pairs a cluster has on average (the P = Q * nprobe pairs over at least
    m / cmax clusters), so that the busiest cluster's pairs mostly fit one
    block, but at most the block that holds Q columns where the lists fit
    (`wg_plan`: 128, 64 in int8), since a query probes a cluster once. A
    block of Q would score every cluster against Q columns, and in the fp32
    mode the products, not the rows, then bound the scan; a cluster with
    more pairs than a block is read once per block, the blocks of a split
    by neighbouring CTAs. rps: rows of a split, whole row tiles of that
    block's scan: one tile while the Q * nprobe pairs are fewer than the
    SMs, a tile more for every further SM's worth of pairs, up to a whole
    cluster (cmax), so that a launch fills a wave at Q = 1 and reads each
    cluster in one slice at Q = 64. splits: ceil(cmax / rps), the most
    splits of one cluster, with at most MERGE_LISTS (probe, split) lists a
    query."""
    busy = -(-4 * qn * nprobe * cmax // max(m, 1))
    n_block = min(wg_plan(qn, k, wg, ivf=True)[0], max(8, 1 << (busy - 1).bit_length()))
    tile = WG_ROWS * wg_m_tiles(wg_width(n_block, wg))
    tiles = max(1, -(-cmax // tile))
    per = max(1, min(qn * nprobe // sms, tiles))
    if nprobe * -(-tiles // per) > MERGE_LISTS:
        per = -(-tiles // max(1, MERGE_LISTS // nprobe))
    rps = per * tile
    return n_block, rps, max(1, -(-cmax // rps))


def ivf_plan(base: torch.Tensor, cnt: torch.Tensor, *, m: int, n_block: int, rps: int,
             splits: int):
    """The cluster-major work table of a K11 launch (the plain version of
    `csrc/ivf_scan.cu::ivf_plan_kernel`), on base's device, with no host
    sync (every size follows from the arguments' shapes).

    The P = Q * nprobe (query, probe) pairs with cnt > 0 are sorted by
    their cluster (base, cnt) (stable: in pair order within a cluster;
    the kernel orders clusters and places within one by its atomics),
    the pairs with cnt = 0 after them; each cluster's rows [base, base +
    cnt) are cut into splits of rps rows and its run of pairs into blocks
    of n_block, one slice a (split, block). Returns
      work   [P * splits, 5] int32: slice u (r_begin, r_end, q0, nq,
             split) for u < n_work, zeros after: rows r_begin .. r_end - 1
             against the pairs at places q0 .. q0 + nq - 1 of the order;
      n_work [1] int32, the slices;
      slot   [P] int32, each pair's place in the order (its partial lists
             sit at [split, slot]);
      qrow   [P] int64, the query of the pair at each place."""
    qn, nprobe = base.shape
    n_pairs = qn * nprobe
    dev = base.device
    b = base.reshape(-1).long()
    c = cnt.reshape(-1).long()
    dead = (m + 1) ** 2            # above every key b * (m + 1) + c
    key, perm = torch.sort(torch.where(c > 0, b * (m + 1) + c, dead), stable=True)
    live = key < dead
    first = live.clone()
    first[1:] &= key[1:] != key[:-1]
    gid = torch.cumsum(first, 0) - 1          # each live place's cluster
    place = torch.arange(n_pairs, device=dev)
    at_first = torch.where(first, gid, n_pairs)      # n_pairs: a slot that is dropped
    g_q0 = torch.zeros(n_pairs + 1, dtype=torch.int64, device=dev).scatter_(0, at_first, place)
    g_b = torch.zeros_like(g_q0).scatter_(0, at_first, b[perm])
    g_c = torch.zeros_like(g_q0).scatter_(0, at_first, c[perm])
    g_np = torch.zeros_like(g_q0).scatter_add_(0, torch.where(live, gid, n_pairs),
                                               torch.ones_like(place))
    g_q0, g_b, g_c, g_np = g_q0[:-1], g_b[:-1], g_c[:-1], g_np[:-1]   # slots past the last: 0
    n_qb = (g_np + n_block - 1) // n_block
    items = (g_c + rps - 1) // rps * n_qb
    ends = torch.cumsum(items, 0)
    u = torch.arange(n_pairs * splits, device=dev)
    g = torch.searchsorted(ends, u, right=True).clamp(max=n_pairs - 1)
    local = u - (ends[g] - items[g])
    nqb = n_qb[g].clamp(min=1)
    split = local // nqb                      # a split's query blocks are neighbours
    q0 = g_q0[g] + (local - split * nqb) * n_block
    r_begin = g_b[g] + split * rps
    r_end = torch.minimum(g_b[g] + g_c[g], r_begin + rps)
    nq = torch.clamp(g_q0[g] + g_np[g] - q0, max=n_block)
    work = torch.stack([r_begin, r_end, q0, nq, split], 1)
    work = torch.where((u < ends[-1])[:, None], work, 0).to(torch.int32).contiguous()
    slot = torch.empty_like(place).scatter_(0, perm, place).to(torch.int32)
    return work, ends[-1:].to(torch.int32), slot, perm // nprobe


def check_plan(base: torch.Tensor, cnt: torch.Tensor, work: torch.Tensor,
               n_work: torch.Tensor, slot: torch.Tensor, qrow: torch.Tensor, *,
               n_block: int, rps: int) -> None:
    """Raises AssertionError unless (work, n_work, slot, qrow) is a plan of
    `ivf_plan`'s contract for these probes: slot a permutation of the
    places with the live pairs (cnt > 0) first, qrow[slot[pair]] the
    pair's query; every slice's pairs live and of one cluster, its rows
    that cluster's split (base + split * rps .. min(base + cnt, + rps)),
    1 .. n_block pairs; and every live pair in exactly one slice of each
    of its cluster's ceil(cnt / rps) splits, so the splits tile [base,
    base + cnt) exactly."""
    def need(cond, what):
        if not cond:
            raise AssertionError(f"the plan breaks its contract: {what}")

    nprobe = base.shape[1]
    b, c = (t.reshape(-1).cpu().numpy().astype(np.int64) for t in (base, cnt))
    n_pairs = len(b)
    slot, qrow = (t.cpu().numpy().astype(np.int64) for t in (slot, qrow))
    live = c > 0
    need(np.array_equal(np.sort(slot), np.arange(n_pairs)), "slot is not a permutation")
    need(np.array_equal(qrow[slot], np.arange(n_pairs) // nprobe), "qrow misplaces a query")
    need((slot[live] < live.sum()).all(), "a dead pair before a live one")
    pair_at = np.empty(n_pairs, np.int64)
    pair_at[slot] = np.arange(n_pairs)
    n = int(n_work.reshape(-1)[0])
    rb, re, q0, nq, sp = work[:n].cpu().numpy().astype(np.int64).T
    need(((nq > 0) & (nq <= n_block) & (re > rb) & (re - rb <= rps)).all(), "a slice's size")
    item = np.repeat(np.arange(n), nq)
    pair = pair_at[q0[item] + np.arange(len(item)) - np.repeat(np.cumsum(nq) - nq, nq)]
    need(live[pair].all(), "a slice holds a pair of an empty probe")
    need(np.array_equal(rb[item], b[pair] + sp[item] * rps), "a slice's first row")
    need(np.array_equal(re[item], np.minimum(b[pair] + c[pair], rb[item] + rps)), "a slice's end")
    keys, times = np.unique(pair * (c.max(initial=0) + 1) + sp[item], return_counts=True)
    need((times == 1).all(), "a pair twice in one split")
    need(len(keys) == ((c[live] + rps - 1) // rps).sum(), "a split a pair misses")


def plan_sizes(qn: int, nprobe: int, splits: int) -> tuple[int, int, int]:
    """(P, U, H) of a K11 call: its pairs, the work table's rows (the most
    slices: each pair in one block of each split of its cluster) and the
    plan's hash slots (a power of two >= 2P)."""
    n_pairs = qn * nprobe
    return n_pairs, n_pairs * splits, 1 << (2 * n_pairs - 1).bit_length()


def workspace_ints(n_work_max: int, n_pairs: int, slots: int) -> int:
    """int32 words of the plan's workspace (`csrc/ivf_scan.cu::carve`):
    the work table, its count, slot and qrow; one word of alignment; the
    hash table's keys (two words) and cluster numbers; three counters;
    per cluster its pairs, first row, rows, first place and first slice;
    per pair its cluster and rank."""
    return 5 * n_work_max + 9 * n_pairs + 3 * slots + 5


def ivf_plan_cuda(base: torch.Tensor, cnt: torch.Tensor, *, n_block: int, rps: int,
                  splits: int):
    """`ivf_plan`'s contract computed by the plan kernel on the card:
    (work, n_work, slot, qrow) as `ivf_plan` returns them, but in the
    kernel's order of clusters and places (and qrow int32)."""
    qn, nprobe = base.shape
    n_pairs, n_work_max, slots = plan_sizes(qn, nprobe, splits)
    base = base.to(torch.int32).contiguous()
    cnt = cnt.to(torch.int32).contiguous()
    ws = torch.empty(workspace_ints(n_work_max, n_pairs, slots), dtype=torch.int32,
                     device=base.device)
    kernels.require_cuda("ivf_plan_cuda", base, cnt, ws)
    with torch.cuda.device(base.device):
        status = kernels.lib().rv_ivf_plan(base.data_ptr(), cnt.data_ptr(), ws.data_ptr(),
                                           n_work_max, slots, qn, nprobe, n_block, rps,
                                           kernels.stream_ptr(base.device))
    kernels.check("ivf_plan_cuda", status)
    o = 5 * n_work_max
    return (ws[:o].view(n_work_max, 5), ws[o:o + 1], ws[o + 1:o + 1 + n_pairs],
            ws[o + 1 + n_pairs:o + 1 + 2 * n_pairs])


def _wg_mode(mat: torch.Tensor, int8: bool) -> int:
    return WG_INT8 if int8 else WG_F32 if mat.dtype == torch.float32 else WG_BF16


def ivf_cluster_major_ref(mat: torch.Tensor, queries: torch.Tensor, qdig, row_scale,
                          base: torch.Tensor, cnt: torch.Tensor, *, k: int, cmax: int,
                          int8: bool, mask_sorted: Optional[torch.Tensor] = None,
                          sms: int = 132):
    """Plain version of K11's decomposition, the same contract as
    `ivf_probe_scan_ref`: `ivf_plan`'s work table for a card of `sms` SMs,
    each slice scored with plain PyTorch (fp32 sums; int8 as the probe
    loop) into sorted (-score, row) lists of k per pair and split, then
    each query's lists merged by (-score, probe rank, row). Walks the
    table on the host (a test of the plan, not a search path)."""
    qn, nprobe = base.shape
    n_pairs = qn * nprobe
    dev = mat.device
    n_block, rps, splits = ivf_geometry(qn, nprobe, k, cmax, mat.shape[0], wg=_wg_mode(mat, int8),
                                        sms=sms)
    work, n_work, slot, qrow = ivf_plan(base, cnt, m=mat.shape[0], n_block=n_block, rps=rps,
                                        splits=splits)
    part_s = torch.full((splits, n_pairs, k), float("-inf"), device=dev)
    part_i = torch.full((splits, n_pairs, k), -1, dtype=torch.int64, device=dev)
    for r_begin, r_end, q0, nq, split in work[:int(n_work[0])].tolist():
        assert 0 < nq <= n_block and r_end - r_begin <= rps
        rows = mat[r_begin:r_end].float()
        qs = qrow[q0:q0 + nq]
        if int8:
            s = int8_combine(rows @ qdig[0, qs].float().t(), rows @ qdig[1, qs].float().t())
            s = s * row_scale.reshape(-1)[qs][None, :]
        else:
            s = rows @ queries[qs].float().t()                    # [rows, nq]
        if mask_sorted is not None:
            s[~mask_sorted[r_begin:r_end].bool()] = float("-inf")
        top_s, top_r = _finish(s.t().contiguous(), k)            # by (-score, row)
        part_s[split, q0:q0 + nq] = top_s
        part_i[split, q0:q0 + nq] = torch.where(top_r >= 0, top_r.long() + r_begin, -1)
    # each query's lists: probe p's splits at [split, slot[q, p]]
    lists_s = part_s[:, slot.long()].reshape(splits, qn, nprobe, k)
    lists_i = part_i[:, slot.long()].reshape(splits, qn, nprobe, k)
    live = (torch.arange(splits, device=dev)[:, None, None] <
            ((cnt.long() + rps - 1) // rps)[None])[..., None]      # [splits, Q, nprobe, 1]
    lists_s = torch.where(live & (lists_i >= 0), lists_s, float("-inf"))
    probe = torch.arange(nprobe, device=dev)[None, None, :, None].expand_as(lists_i)
    flat_s = lists_s.permute(1, 2, 0, 3).reshape(qn, -1)
    flat_i = lists_i.permute(1, 2, 0, 3).reshape(qn, -1)
    flat_p = probe.permute(1, 2, 0, 3).reshape(qn, -1)
    out_s = torch.full((qn, k), float("-inf"), device=dev)
    out_i = torch.full((qn, k), -1, dtype=torch.int32, device=dev)
    for q in range(qn):
        keep = torch.isfinite(flat_s[q])
        s, p, r = flat_s[q][keep], flat_p[q][keep], flat_i[q][keep]
        order = sorted(range(len(s)), key=lambda e: (-float(s[e]), int(p[e]), int(r[e])))[:k]
        out_s[q, :len(order)] = s[order]
        out_i[q, :len(order)] = r[order].to(torch.int32)
    return out_s, out_i


def launch_key(mat: torch.Tensor, base: torch.Tensor, *, k: int, int8: bool,
               masked: bool) -> tuple:
    """The `kernels.shape_launches` key of a K11 launch: (Q, nprobe, d, k,
    masked, mode), mode "int8" or the rows' dtype name, so that each shape
    is timed in the mode it ran in."""
    mode = "int8" if int8 else str(mat.dtype).removeprefix("torch.")
    return ("ivf_scan", (base.shape[0], base.shape[1], mat.shape[1], k, masked, mode))


def ivf_probe_scan(mat: torch.Tensor, queries: torch.Tensor, qdig, row_scale,
                   base: torch.Tensor, cnt: torch.Tensor, *, k: int, cmax: int,
                   int8: bool, mask_sorted: Optional[torch.Tensor] = None):
    """Probed-scan top-k (K11); same contract as `ivf_probe_scan_ref`.

    mat        [M, d] cluster-sorted rows (compact: cluster c is rows
               offsets[c] .. offsets[c] + counts[c])
    queries    [Q, d] in the matrix dtype (bf16/fp32 path)
    qdig       [2, Q, d] int8 query digits, row_scale [Q, 1] f32 (int8 path)
    base, cnt  [Q, nprobe] int32 probed clusters' first rows and counts
    cmax       the largest cluster count (the probe-rank stride of the order)
    mask_sorted [M] bool/uint8 over sorted rows, or None
    On a CUDA matrix: the sizes from `ivf_geometry` and `plan_sizes`,
    the query operand (bf16 rows, fp32 rows' three bf16 parts, or int8
    digits with their scales), then one `rv_ivf_scan` call (the plan on
    the card, the operand gathered into its order, the scan, the merge).
    Above the kernel's k cap a CUDA scan takes the plain
    version, counted in `kernels.plain_dispatches["ivf_fetch_above_cap"]`."""
    if mat.device.type == "cpu":
        return ivf_probe_scan_ref(mat, queries, qdig, row_scale, base, cnt, k=k,
                                  cmax=cmax, int8=int8, mask_sorted=mask_sorted)
    if k > K_CAP:
        log.info(f"IVF fetch k={k} above the kernel cap {K_CAP}: plain probe loop")
        kernels.plain_dispatches["ivf_fetch_above_cap"] += 1
        return ivf_probe_scan_ref(mat, queries, qdig, row_scale, base, cnt, k=k,
                                  cmax=cmax, int8=int8, mask_sorted=mask_sorted)
    kernels.require_cuda("ivf_probe_scan", mat)
    qn, nprobe = base.shape
    m, d = mat.shape
    dev = mat.device
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_pos = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_s, out_pos
    wg = _wg_mode(mat, int8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_block, rps, splits = ivf_geometry(qn, nprobe, k, cmax, m, wg=wg, sms=sms)
    n_pairs, n_work_max, slots = plan_sizes(qn, nprobe, splits)
    # the queries' operand rows (16-byte pitch), gathered into the plan's order on the card
    scale = scale_op = None
    if int8:
        src = tma_rows(qdig)                                 # [2, Q, d rounded up to 16]
        scale = row_scale.reshape(-1).float().contiguous()
        scale_op = torch.empty(n_pairs, dtype=torch.float32, device=dev)
        mode = kernels.INT8
    elif mat.dtype == torch.float32:
        src = split_parts(queries.float(), 3)                # [3, Q, d rounded up to 8]
        mode = kernels.DTYPE_CODES[mat.dtype]
    else:
        src = tma_rows(queries.to(mat.dtype))[None]
        mode = kernels.DTYPE_CODES[mat.dtype]
    q_op = src.new_empty((src.shape[0], n_pairs, src.shape[2]))
    base = base.to(torch.int32).contiguous()
    cnt = cnt.to(torch.int32).contiguous()
    mask = None if mask_sorted is None else mask_sorted.to(torch.uint8).contiguous()
    ws = torch.empty(workspace_ints(n_work_max, n_pairs, slots), dtype=torch.int32, device=dev)
    kernels.require_cuda("ivf_probe_scan", mat, src, base, cnt,
                         *[t for t in (scale, mask) if t is not None])
    part_s = torch.empty((splits, n_pairs, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, n_pairs, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = kernels.lib().rv_ivf_scan(
            mat.data_ptr(), src.data_ptr(), q_op.data_ptr(), src.shape[0],
            src.shape[2] * src.element_size(), None if scale is None else scale.data_ptr(),
            None if scale_op is None else scale_op.data_ptr(),
            None if mask is None else mask.data_ptr(), base.data_ptr(), cnt.data_ptr(),
            ws.data_ptr(), n_work_max, slots, d, m, qn, nprobe, k, n_block, splits, rps,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_pos.data_ptr(), mode,
            kernels.stream_ptr(dev))
    kernels.check("ivf_probe_scan", status)
    kernels.launches["ivf_scan"] += 1
    kernels.shape_launches[launch_key(mat, base, k=k, int8=int8, masked=mask is not None)] += 1
    return out_s, out_pos
