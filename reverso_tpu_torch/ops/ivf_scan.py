"""Probed-cluster scan of the IVF index: the CUDA kernel and its plain version.

For each (query, probe) only the probed cluster's rows of the
cluster-sorted matrix are scored (bf16/fp32 rows against the query, or
int8 rows against its two int8 digits, exact s32 dots combined as
f32(hi) * 254 + f32(lo) and times the query's scale), and each query keeps
its k best candidates ordered by (-score, probe rank, position within the
cluster): the order of the JAX package's probe loop
(`store/ivf.py::_ivf_search`), whose `scores_all` columns are
`probe * cmax + within`. Results are sorted-matrix rows; `store/ivf.py`
maps them to original row ids and applies the spill dedup.

On a CUDA matrix `ivf_probe_scan` launches `csrc/ivf_scan.cu` (K11),
masked or not; on a CPU matrix it runs `ivf_probe_scan_ref`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .topk import K_CAP, _finish, int8_combine, log


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
    Above the kernel's k cap a CUDA scan takes the plain version, counted
    in `kernels.plain_dispatches["ivf_fetch_above_cap"]`."""
    if mat.device.type == "cpu":
        return ivf_probe_scan_ref(mat, queries, qdig, row_scale, base, cnt, k=k,
                                  cmax=cmax, int8=int8, mask_sorted=mask_sorted)
    if k > K_CAP:
        log.info(f"IVF fetch k={k} above the kernel cap {K_CAP}: plain probe loop")
        kernels.plain_dispatches["ivf_fetch_above_cap"] += 1
        return ivf_probe_scan_ref(mat, queries, qdig, row_scale, base, cnt, k=k,
                                  cmax=cmax, int8=int8, mask_sorted=mask_sorted)
    qn, nprobe = base.shape
    d = mat.shape[1]
    dev = mat.device
    if int8:
        q = qdig.contiguous()
        scale = row_scale.reshape(-1).float().contiguous()
        mode = kernels.INT8
    else:
        q = queries.to(mat.dtype).contiguous()
        scale = None
        mode = kernels.DTYPE_CODES[mat.dtype]
    base = base.to(torch.int32).contiguous()
    cnt = cnt.to(torch.int32).contiguous()
    mask = None if mask_sorted is None else mask_sorted.to(torch.uint8).contiguous()
    kernels.require_cuda("ivf_probe_scan", mat, q, base, cnt,
                         *[t for t in (scale, mask) if t is not None])
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_pos = torch.empty((qn, k), dtype=torch.int32, device=dev)
    if qn == 0:
        return out_s, out_pos
    part_s = torch.empty((qn * nprobe, k), dtype=torch.float32, device=dev)
    part_w = torch.empty((qn * nprobe, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = kernels.lib().rv_ivf_scan(
            mat.data_ptr(), q.data_ptr(), None if scale is None else scale.data_ptr(),
            base.data_ptr(), cnt.data_ptr(), None if mask is None else mask.data_ptr(),
            d, qn, nprobe, k, part_s.data_ptr(), part_w.data_ptr(),
            out_s.data_ptr(), out_pos.data_ptr(), mode, kernels.stream_ptr(dev))
    kernels.check("ivf_probe_scan", status)
    kernels.launches["ivf_scan"] += 1
    kernels.shape_launches[launch_key(mat, base, k=k, int8=int8, masked=mask is not None)] += 1
    return out_s, out_pos
