"""K11's cluster-major decomposition on the CPU.

`ops/ivf_scan.py` states the card's plan in plain PyTorch (`ivf_plan`)
and the whole decomposition (`ivf_cluster_major_ref`: the plan's work
table walked slice by slice, then each query's lists merged by (-score,
probe rank, position)). Here the plan is held against its contract
(`check_plan`) over ragged layouts, the decomposition against the probe
loop (`ivf_probe_scan_ref`) and, at index level, against the JAX
package's `IVFIndex.search`; and the index's row mask is taken as a host
array or a tensor alike. tests/test_torch_cuda.py holds the plan kernel
and the scan against the same contracts on the card.
"""
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from reverso_tpu.store.ivf import IVFIndex as JaxIVF
from reverso_tpu_torch.ops import ivf_scan
from reverso_tpu_torch.ops.ivf_scan import (MERGE_LISTS, check_plan, ivf_cluster_major_ref,
                                            ivf_geometry, ivf_plan, ivf_probe_scan_ref)
from reverso_tpu_torch.ops.topk import (WG_BF16, WG_F32, WG_INT8, WG_ROWS, int8_query_digits,
                                        quantize_db_int8, wg_m_tiles, wg_width)
from reverso_tpu_torch.store.ivf import IVFIndex
from test_torch_ivf import _clustered, _ids_agree

WGS = {"bfloat16": WG_BF16, "float32": WG_F32, "int8": WG_INT8}


def _layout(counts, probes):
    counts = torch.as_tensor(counts)
    offsets = torch.cumsum(counts, 0) - counts
    probes = torch.as_tensor(probes)
    return offsets[probes].int(), counts[probes].int(), int(counts.max()), int(counts.sum())


@st.composite
def ragged_probes(draw):
    """Cluster sizes with empty and one-row clusters and some past a row
    tile; Q from 1 (one-tile splits) to 150 (more pairs a cluster than a
    block holds); nprobe up to every cluster."""
    n_cl = draw(st.integers(1, 12))
    counts = draw(st.lists(st.sampled_from([0, 1, 2, 37, 255, 256, 257, 700, 1300]),
                           min_size=n_cl, max_size=n_cl))
    qn = draw(st.sampled_from([1, 2, 5, 64, 150]))
    nprobe = draw(st.integers(1, n_cl))
    perm = draw(st.permutations(range(n_cl)))
    probes = [[perm[(q * 7 + j) % n_cl] for j in range(nprobe)] for q in range(qn)]
    return counts, probes, draw(st.sampled_from(sorted(WGS))), draw(st.sampled_from([1, 4, 132]))


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(ragged_probes())
def test_plan_tiles_every_probe(case):
    """Every (query, probe) pair with cnt > 0 lies in exactly one query
    block of each row split of its cluster, and the splits tile [base,
    base + cnt) exactly (`check_plan`), in the geometry a card of `sms`
    SMs gives: a power-of-two block within the mode's cap, splits of whole
    row tiles, at most MERGE_LISTS lists a query."""
    counts, probes, mode, sms = case
    base, cnt, cmax, m = _layout(counts, probes)
    if cmax == 0:
        cmax = 1
    qn, nprobe = base.shape
    n_block, rps, splits = ivf_geometry(qn, nprobe, 10, cmax, m, wg=WGS[mode], sms=sms)
    assert n_block in (8, 16, 32, 64, 128) and (mode != "int8" or n_block <= 64)
    assert rps % (WG_ROWS * wg_m_tiles(wg_width(n_block, WGS[mode]))) == 0
    assert splits == -(-cmax // rps) and nprobe * splits <= max(MERGE_LISTS, nprobe)
    plan = ivf_plan(base, cnt, m=m, n_block=n_block, rps=rps, splits=splits)
    check_plan(base, cnt, *plan, n_block=n_block, rps=rps)
    if qn == 1 and sms == 132:   # Q = 1: one-tile splits, so a launch fills the SMs
        assert rps == WG_ROWS * wg_m_tiles(wg_width(n_block, WGS[mode]))


def _inputs(mode, counts, probes, qn_tie=0, seed=0, d=40):
    """Unit rows in the given compact layout, queries, and the probe
    loop's arguments in `mode`; row 300 of cluster 1 (700 rows) is a copy
    of its row 200 and of query `qn_tie`: a tie across a split's edge."""
    base, cnt, cmax, m = _layout(counts, probes)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((base.shape[0], d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    b1 = int(np.cumsum(counts)[0])          # cluster 1's first row
    x[b1 + 300] = x[b1 + 200]
    q[qn_tie] = x[b1 + 200]
    x, q = torch.from_numpy(x), torch.from_numpy(q)
    if mode == "int8":
        mat, scale = quantize_db_int8(x)
        q_hi, q_lo, c2 = int8_query_digits(q)
        return (mat, q, torch.stack([q_hi, q_lo]), c2 * scale, base, cnt), cmax, b1
    dtype = getattr(torch, mode)
    return (x.to(dtype), q.to(dtype), None, None, base, cnt), cmax, b1


COUNTS = [37, 700, 0, 1, 256, 300, 120]
CASES = {
    "one_query": ([[1, 0, 2, 6]], 10, None, 0),             # Q = 1: 256-row splits of 700
    "masked": ([[1, 3, 4], [5, 1, 6], [0, 4, 1]], 20, 0.6, 0),
    "k_at_the_cap": ([[1, 5, 6, 0]] * 3, 128, None, 1),
    "every_cluster": ([list(range(7)), list(range(6, -1, -1))], 16, 0.8, 1),
}


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("sms", [1, 132])
def test_cluster_major_equals_the_probe_loop(mode, case, sms):
    """The plain cluster-major decomposition against the probe loop:
    ids equal, scores bit for bit in int8 and within 1e-6 in fp32 and
    bf16 (fp32 sums in another order). Ties inside a split and across a
    split's edge (the query that copies row 200 of the 700-row cluster
    finds rows 200 and 300 in row order), masks, an empty and a one-row
    cluster, k = 128 (the cap, past the candidates); sms = 1 makes whole
    clusters, 132 one-tile splits."""
    probes, k, keep, tie_q = CASES[case]
    args, cmax, b1 = _inputs(mode, COUNTS, probes, qn_tie=tie_q)
    mask = None
    if keep is not None:
        mask = torch.from_numpy(np.random.default_rng(1).random(sum(COUNTS)) < keep)
        mask[[b1 + 200, b1 + 300]] = True
    kw = dict(k=k, cmax=cmax, int8=mode == "int8", mask_sorted=mask)
    rs, ri = ivf_probe_scan_ref(*args, **kw)
    cs, ci = ivf_cluster_major_ref(*args, **kw, sms=sms)
    assert torch.equal(ci, ri)
    fin = torch.isfinite(rs)
    assert torch.equal(fin, torch.isfinite(cs))
    if mode == "int8":
        assert torch.equal(cs, rs)
    else:
        assert float((cs[fin] - rs[fin]).abs().max()) <= 1e-6
    assert ci[tie_q, :2].tolist() == [b1 + 200, b1 + 300]


@pytest.mark.parametrize("mode", ["float32", "int8"])
def test_cluster_major_with_spill_copies(mode):
    """A spilled row (a second copy in another cluster) found through
    both clusters: both sorted rows come back, in probe-rank order."""
    counts = [50, 700, 80]
    args, cmax, b1 = _inputs(mode, counts, [[2, 1], [1, 2]], qn_tie=0, seed=3)
    mat, q = args[0].clone(), args[1]
    mat[700 + 50 + 10] = mat[b1 + 200]                         # cluster 2's row 10
    args = (mat,) + args[1:]
    kw = dict(k=12, cmax=cmax, int8=mode == "int8")
    rs, ri = ivf_probe_scan_ref(*args, **kw)
    cs, ci = ivf_cluster_major_ref(*args, **kw, sms=132)
    assert torch.equal(ci, ri)
    assert ci[0, :3].tolist() == [760, b1 + 200, b1 + 300]    # probe 0 is cluster 2
    if mode == "int8":
        assert torch.equal(cs, rs)


@pytest.mark.parametrize("dtype,spill,balance", [("bfloat16", 0.0, 0.0),
                                                 ("float32", 0.2, 1.5), ("int8", 0.1, 2.0)])
@pytest.mark.parametrize("sms", [1, 132])
def test_index_with_the_decomposition_matches_jax(monkeypatch, dtype, spill, balance, sms):
    """The port's `IVFIndex.search` with its probed scan replaced by the
    plain cluster-major decomposition, against the JAX package's index on
    the same clustered data (built by each package from the same seeded
    draws): ids equal (`_ids_agree`), at nprobe 4 and 16 and with a row
    mask."""
    x, q = _clustered(7, 3000)
    jix = JaxIVF(x, n_clusters=16, dtype=dtype, spill=spill, balance=balance)
    tix = IVFIndex(x, n_clusters=16, dtype=dtype, spill=spill, balance=balance, device="cpu")
    monkeypatch.setattr("reverso_tpu_torch.store.ivf.ivf_probe_scan",
                        functools.partial(ivf_cluster_major_ref, sms=sms))
    mask = np.arange(3000) % 3 != 0
    for nprobe, m in ((4, None), (16, None), (4, mask)):
        _ids_agree(jix.search(q, 10, nprobe=nprobe, row_mask=m),
                   tix.search(q, 10, nprobe=nprobe, row_mask=m), dtype)


@pytest.mark.parametrize("length", [3000, 2500, 3500])
def test_sorted_mask_takes_a_tensor_or_an_array(length):
    """`IVFIndex.search(row_mask=)` gives the same results for a numpy
    array and a torch tensor (bool or uint8) of the same mask, shorter
    than the index (the rest False) or longer (cut)."""
    x, q = _clustered(8, 3000)
    tix = IVFIndex(x, n_clusters=16, dtype="bfloat16", spill=0.2, device="cpu")
    mask = np.random.default_rng(2).random(length) < 0.4
    want = tix.search(q, 10, nprobe=8, row_mask=mask)
    for m in (torch.from_numpy(mask), torch.from_numpy(mask).to(torch.uint8)):
        got = tix.search(q, 10, nprobe=8, row_mask=m)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    ids = want[1].numpy()
    assert mask[ids[(ids >= 0) & (ids < length)]].all() and not (ids >= length).any()
    assert torch.equal(tix._sorted_mask(torch.from_numpy(mask)),
                       tix._sorted_mask(mask)) and tix._sorted_mask(mask).dtype == torch.uint8


def test_plan_is_in_cluster_order_here():
    """The plain plan sorts the clusters by (base, cnt) and keeps pair
    order within one (the card's kernel orders both by its atomics)."""
    base, cnt, cmax, m = _layout([5, 0, 9], [[2, 0, 1], [0, 2, 1]])
    work, n_work, slot, qrow = ivf_plan(base, cnt, m=m, n_block=8, rps=256, splits=1)
    assert slot.tolist() == [2, 0, 4, 1, 3, 5]          # cluster 0's pairs, then 2's, then dead
    assert qrow.tolist() == [0, 1, 0, 1, 0, 1]
    assert work[:int(n_work[0])].tolist() == [[0, 5, 0, 2, 0], [5, 14, 2, 2, 0]]
    assert ivf_scan.plan_sizes(2, 3, 1) == (6, 6, 16)
