"""The wgmma top-k scan's selection, binary dimension order, int8 score
steps, fp32 split scores and launch geometry
(`reverso_tpu_torch/csrc/topk_stream.cu`, `scan_wg`: K1, K2 on bf16 and
fp32 rows, K10, K9, K12), on the CPU.

The CUDA kernel runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it against its plain versions there). Here a numpy
emulation of its selection, the Python mirror of its geometry and its
binary query permutation are held against the JAX package's kernels (in
interpret mode or through their XLA references) and the port's plain
versions. Inputs are made with numpy from a seed.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reverso_tpu.ops import binary as jbin
from reverso_tpu.ops import topk as jtopk
from reverso_tpu.ops import topk_int8 as jtk
from reverso_tpu_torch import kernels
from reverso_tpu_torch.ops import binary as tbin
from reverso_tpu_torch.ops import topk as ttopk
from reverso_tpu_torch.ops import topk_int8 as ttk
from reverso_tpu_torch.ops.split import SPLIT_TERMS, split3
from test_topk import assert_topk_equiv, random_unit

SRC = os.path.join(os.path.dirname(kernels.__file__), "csrc", "topk_stream.cu")


# ---------------------------------------------------------------------------
# (a) the selection: gate, candidate slots, unordered inserts, splits, merge
# ---------------------------------------------------------------------------

def _better(sa, ia, sb, ib):
    return sa > sb or (sa == sb and ia < ib)


def emulate_scan(scores, k, n_valid, mask, n_splits, rng, rows=ttopk.WG_ROWS, cand=8):
    """The kernel's pass 1 and pass 2 on precomputed [Q, N] fp32 scores.

    Each split walks its rows in `rows`-row tiles. A tile's scores reach
    the gate in an arbitrary order (shuffled by `rng`, as the warps'
    atomics interleave): a score of a kept row at or above its query's
    k-th goes to the query's `cand` slots, or waits for the next round if
    they are full; each round ends with every query inserting its slots'
    candidates, in slot order, into its sorted list by (-score, idx) (the
    kernel's warp merge of three or more gives the same list). Then the
    splits' lists merge by (-score, idx). Returns (scores, idx) [Q, k]."""
    q = scores.shape[0]
    rps = -(-max(n_valid, 1) // n_splits)
    rps = -(-rps // rows) * rows
    parts = []
    for sp in range(n_splits):
        st_s = np.full((q, k), -np.inf, np.float32)
        st_i = np.full((q, k), -1, np.int64)
        r_end = min(n_valid, (sp + 1) * rps)
        for r0 in range(sp * rps, r_end, rows):
            rr = np.arange(r0, min(r0 + rows, r_end))
            if mask is not None:
                rr = rr[mask[rr]]
            arrivals = [(qq, r) for qq in range(q) for r in rr]
            order = rng.permutation(len(arrivals))
            waiting = [arrivals[j] for j in order]
            while waiting:
                slots = [[] for _ in range(q)]
                pending = []
                for qq, r in waiting:
                    if scores[qq, r] >= st_s[qq, k - 1]:      # the gate
                        (slots[qq] if len(slots[qq]) < cand else pending).append((qq, r))
                if not any(slots):
                    break
                for qq in range(q):
                    for _, r in slots[qq]:
                        s = scores[qq, r]
                        if not _better(s, r, st_s[qq, k - 1], st_i[qq, k - 1]):
                            continue
                        p = k - 1
                        while p > 0 and _better(s, r, st_s[qq, p - 1], st_i[qq, p - 1]):
                            st_s[qq, p], st_i[qq, p] = st_s[qq, p - 1], st_i[qq, p - 1]
                            p -= 1
                        st_s[qq, p], st_i[qq, p] = s, r
                waiting = pending
        parts.append((st_s, st_i))
    out_s = np.full((q, k), -np.inf, np.float32)
    out_i = np.full((q, k), -1, np.int64)
    for qq in range(q):          # pass 2: the heads of the sorted partials
        heads = [0] * n_splits
        for j in range(k):
            best = None
            for sp, (ps, pi) in enumerate(parts):
                h = heads[sp]
                if h >= k or pi[qq, h] < 0:
                    continue
                if best is None or _better(ps[qq, h], pi[qq, h], *best[1:]):
                    best = (sp, ps[qq, h], pi[qq, h])
            if best is None:
                break
            heads[best[0]] += 1
            out_s[qq, j], out_i[qq, j] = best[1], best[2]
    return out_s, out_i


def exact_topk(scores, k, n_valid, mask):
    """(-score, idx) order of the kept rows below n_valid by a stable sort."""
    s = scores.astype(np.float32).copy()
    s[:, n_valid:] = -np.inf
    if mask is not None:
        s[:, ~mask] = -np.inf
    out_s = np.full((s.shape[0], k), -np.inf, np.float32)
    out_i = np.full((s.shape[0], k), -1, np.int64)
    for qq in range(s.shape[0]):
        order = np.lexsort((np.arange(s.shape[1]), -s[qq]))[:k]
        keep = np.isfinite(s[qq, order])
        out_s[qq, :keep.sum()] = s[qq, order][keep]
        out_i[qq, :keep.sum()] = order[keep]
    return out_s, out_i


def _tie_data(seed, n, d, q, dups, n_top):
    """Unit rows with row 3 copied to `dups` (exact ties of query 0 = row
    3), and query 1 a noisy copy of row 40 with row 40 copied two rows past
    each of `dups` and `n_top` rows equal to the query itself, so that its
    k-th place falls inside the tied group when k = n_top + 2."""
    rng = np.random.default_rng(seed)
    db = random_unit(rng, n, d)
    qs = random_unit(rng, q, d)
    for r in dups:
        db[r] = db[3]
    qs[0] = db[3]
    q1 = db[40] + 0.3 * random_unit(rng, 1, d)[0]
    qs[1] = q1 / np.linalg.norm(q1)
    for r in dups:
        db[r + 2] = db[40]
    taken = {3, 40, *dups, *(r + 2 for r in dups)}
    top = rng.choice([r for r in range(n) if r not in taken], n_top, replace=False)
    db[top] = qs[1]
    return db, qs


def _scores(db, qs):
    """fp32 scores rounded once from fp64: equal rows score bit-equal."""
    return (qs.astype(np.float64) @ db.astype(np.float64).T).astype(np.float32)


def _tie_margin_equal(s, i, rs, ri, tol):
    """Scores within `tol`, the same -inf slots (idx -1), ids equal where
    the reference's ranked scores are more than `tol` from both neighbours."""
    fin = np.isfinite(rs)
    np.testing.assert_array_equal(fin, np.isfinite(s))
    np.testing.assert_array_equal(np.where(fin, 0, i), np.where(fin, 0, -1))
    np.testing.assert_allclose(np.where(fin, s, 0), np.where(fin, rs, 0), atol=tol)
    r = np.where(fin, rs, -1e9)
    pad = np.full((r.shape[0], 1), np.inf)
    gap_up = np.concatenate([pad, -np.diff(r, axis=1)], axis=1)
    gap_dn = np.concatenate([-np.diff(r, axis=1), pad], axis=1)
    clear = (gap_up > tol) & (gap_dn > tol)
    np.testing.assert_array_equal(np.where(clear, i, -2), np.where(clear, ri, -2))


# (n, d, q, k, n_valid, keep, n_splits): duplicates of row 3 (and of row
# 40) sit at rows 127/128 (a tile boundary) and at the split boundary
SEL_CASES = [
    (700, 32, 5, 1, None, None, 2),      # k = 1: the lowest of the tied rows
    (700, 32, 5, 4, None, None, 3),      # k-th place inside the tied groups
    (1000, 48, 6, 10, 777, 0.6, 2),      # ragged n_valid, a mask
    (400, 32, 4, 128, None, None, 2),    # k = 128
    (300, 32, 3, 20, 260, 0.0, 2),       # every row masked
    (900, 32, 4, 6, 513, None, 4),       # more splits than tiles past n_valid
]


@pytest.mark.parametrize("n,d,q,k,n_valid,keep,n_splits", SEL_CASES)
def test_emulated_selection_is_exact(n, d, q, k, n_valid, keep, n_splits):
    """The emulated gate + candidate slots + unordered inserts + merge give
    the exact (-score, idx) top-k of the same fp32 scores, bit for bit,
    under three arrival orders and slot counts (8, 32 and the launch's):
    ties at the k-th place go to the lower row although candidates reach
    the lists out of row order."""
    nv = n if n_valid is None else n_valid
    rps = -(-(-(-nv // n_splits)) // 128) * 128
    dups = [127, 128, rps - 1, rps] if rps < n - 3 else [127, 128]
    db, qs = _tie_data(n, n, d, q, dups, n_top=max(k - 2, 0))
    rng = np.random.default_rng(k)
    mask = None if keep is None else rng.random(n) < keep
    if mask is not None and keep > 0:
        mask[[3, 40] + dups + [r + 2 for r in dups]] = True
    sc = _scores(db, qs)
    want_s, want_i = exact_topk(sc, k, nv, mask)
    for seed, cand in ((0, 8), (1, 32), (2, ttopk.wg_cand(ttopk.wg_plan(q, k, False)[0]))):
        got_s, got_i = emulate_scan(sc, k, nv, mask, n_splits, np.random.default_rng(seed),
                                    cand=cand)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_s, want_s)
    if keep == 0.0:
        assert (want_i == -1).all()
    elif k >= 2:
        tied = sorted(r for r in [3] + dups if r < nv)
        assert list(want_i[0, :min(k, len(tied))]) == tied[:k]


@pytest.mark.parametrize("n,d,q,k,n_valid,keep,n_splits", SEL_CASES)
def test_emulated_selection_matches_jax_and_plain(n, d, q, k, n_valid, keep, n_splits):
    """The emulation against the JAX package's streaming kernel
    (`cosine_topk_pallas`, interpret mode, k <= 128) and the port's plain
    version on fp32 rows: scores within 1e-5 (the same fp32 products,
    summed in another order) and ids equal where the margins are clear."""
    nv = n if n_valid is None else n_valid
    db, qs = _tie_data(n, n, d, q, [127, 128], n_top=max(k - 2, 0))
    rng = np.random.default_rng(k + 1)
    mask = None if keep is None else rng.random(n) < keep
    got_s, got_i = emulate_scan(_scores(db, qs), k, nv, mask, n_splits,
                                np.random.default_rng(0))
    js, ji = (np.asarray(x) for x in jtopk.cosine_topk_pallas(
        jnp.asarray(db), jnp.asarray(qs), k, n_valid=n_valid, q_tile=8, db_tile=256,
        interpret=True, row_mask=None if mask is None else jnp.asarray(mask)))
    ps, pi = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), k,
                               n_valid=n_valid, row_mask=mask)   # the plain version on the CPU
    tol = 1e-5
    _tie_margin_equal(got_s, got_i, js, ji, tol)
    _tie_margin_equal(got_s, got_i, ps.numpy(), pi.numpy(), tol)


def test_gate_must_admit_equal_scores():
    """Why the gate is `s >= k-th`: with `s > k-th`, a lower row whose score
    equals the k-th place, reaching the gate after a higher row of the
    same score took that place, would be dropped."""
    sc = np.array([[0.5, 0.9, 0.5]], np.float32)   # rows 0 and 2 tie
    # the tile's arrivals: row 2 first, then 1, then 0
    st_s, st_i = [-np.inf], [-1]
    for r in (2, 1, 0):
        if sc[0, r] > st_s[0] or (sc[0, r] == st_s[0] and r < st_i[0]):
            st_s, st_i = [sc[0, r]], [r]
    assert st_i == [1]
    want_s, want_i = exact_topk(sc, 2, 3, None)
    got_s, got_i = emulate_scan(sc, 2, 3, None, 1, np.random.default_rng(5))
    np.testing.assert_array_equal(got_i, want_i)
    assert list(got_i[0]) == [1, 0]


# ---------------------------------------------------------------------------
# (b) the binary kernel's dimension order
# ---------------------------------------------------------------------------

def _kernel_rows(packed):
    """[N, W] packed rows -> [N, 8 W16] +-1 in the kernel's k order: byte p
    bit b at kappa (csrc/topk_stream.cu, scan_wg); padding bytes are 0
    bits, -1 (their query columns are 0)."""
    n, w = packed.shape
    w16 = -(-w // 16) * 16
    pad = np.zeros((n, w16), np.uint8)
    pad[:, :w] = packed
    p = np.repeat(np.arange(w16), 8)
    b = np.tile(np.arange(8), w16)
    kappa = 64 * (p // 8) + 32 * (p % 8 // 4) + 16 * (b >> 2) + 8 * ((b >> 1) & 1) \
        + 2 * (p % 4) + (b & 1)
    rows = np.empty((n, 8 * w16), np.float32)
    rows[:, kappa] = ((pad[:, p] >> b) & 1) * 2.0 - 1.0
    return rows


@pytest.mark.parametrize("w", [1, 12, 16, 25, 128, 1024])
def test_kernel_order_is_a_permutation(w):
    """Every planar dimension b W + p (p < W) appears once; the positions
    of the padding bytes (W up to a multiple of 16) hold -1."""
    order = tbin.kernel_order(w).numpy()
    w16 = -(-w // 16) * 16
    assert order.shape == (8 * w16,)
    np.testing.assert_array_equal(np.sort(order[order >= 0]), np.arange(8 * w))
    assert (order < 0).sum() == 8 * (w16 - w)


@pytest.mark.parametrize("n,d,q,k,n_valid", [(1500, 1024, 5, 30, None),
                                             (900, 200, 4, 10, 700),   # W = 25
                                             (600, 96, 3, 20, None)])  # W = 12
def test_binary_kernel_order_scores(n, d, q, k, n_valid):
    """The permuted query (`kernel_queries`) against the rows' bits in the
    kernel's order, selected by the emulated scan, against
    `binary_topk_ref` and the JAX package's `binary_topk_xla`: scores
    within 1e-4 (exact +-bf16(q_i) products, fp32 sums in another order)
    and ids equal where the margins are clear."""
    rng = np.random.default_rng(n + d)
    db = random_unit(rng, n, d)
    db[n // 2] = db[3]
    qs = random_unit(rng, q, d)
    qs[0] = db[3]
    packed = jbin.pack_signs(db - db.mean(0))
    w = packed.shape[1]
    qk = tbin.kernel_queries(torch.from_numpy(qs), w).float().numpy()
    sc = (qk.astype(np.float64) @ _kernel_rows(packed).T.astype(np.float64)).astype(np.float32)
    nv = n if n_valid is None else n_valid
    got_s, got_i = emulate_scan(sc, k, nv, None, 2, np.random.default_rng(1))
    rs, ri = tbin.binary_topk_ref(torch.from_numpy(packed), torch.from_numpy(qs), k, d,
                                  n_valid=n_valid)
    js, ji = (np.asarray(x) for x in jbin.binary_topk_xla(
        jnp.asarray(packed), jnp.asarray(qs), k, d, n_valid=n_valid))
    tol = 1e-4
    _tie_margin_equal(got_s, got_i, rs.numpy(), ri.numpy(), tol)
    _tie_margin_equal(got_s, got_i, js, ji, tol)
    assert list(got_i[0, :2]) == [3, n // 2]


# ---------------------------------------------------------------------------
# (c) the launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,k,binary,want", [
    (1, 10, False, (8, 1, 6)),         # Q = 1: an n8 product, a pure stream
    (64, 5, False, (64, 1, 4)),        # the direct-embed path's search_batch
    (64, 10, False, (64, 1, 4)),       # the capacity path's K2
    (64, 128, False, (64, 1, 3)),
    (100, 10, False, (128, 1, 5)),
    (128, 128, False, (128, 1, 2)),    # k at the cap: two stages
    (256, 10, False, (128, 2, 5)),     # the Q = 256 row: two query blocks
    (256, 128, False, (128, 2, 2)),
    (300, 10, False, (128, 3, 5)),     # Q above 256: three blocks of 100
    (64, 30, True, (64, 1, 8)),        # the capacity path's K10
    (256, 30, True, (128, 2, 8)),      # the K10 row
    (256, 128, True, (128, 2, 2)),
    (7, 30, True, (8, 1, 8)),
    # int8 (modes 2, K9, and 3, K12): 128 bytes of d a stage
    (1, 10, ttopk.WG_INT8, (8, 1, 6)),          # an n16 product (hi, lo), 256-row tiles
    (64, 10, ttopk.WG_INT8, (64, 1, 6)),        # the capacity path's K9: n128, 128-row tiles
    (256, 10, ttopk.WG_INT8, (64, 4, 6)),       # the K9 row: four blocks of 64
    (256, 128, ttopk.WG_INT8, (64, 4, 4)),
    (256, 40, ttopk.WG_INT8_ROWS, (64, 4, 4)),  # the two-stage search's K12: 256-row tiles
    (1, 10, ttopk.WG_INT8_ROWS, (8, 1, 6)),
    (1024, 40, ttopk.WG_INT8_ROWS, (64, 16, 4)),  # Q_RESIDENT queries a launch
    # fp32 rows (mode 4): 128 bytes (32 dims) of a row and the query's
    # three 64-byte parts a stage
    (1, 10, ttopk.WG_F32, (8, 1, 6)),           # n8 parts: 1.5 KB, a 2 KB slot
    (64, 10, ttopk.WG_F32, (64, 1, 4)),         # the float32 store's search_batch
    (64, 5, ttopk.WG_F32, (64, 1, 4)),          # the parity slice's search_batch
    (256, 10, ttopk.WG_F32, (128, 2, 4)),       # the Q = 256 row: two query blocks
    (256, 128, ttopk.WG_F32, (64, 4, 3)),       # k at the cap: 64-query blocks
])
def test_wg_plan(q, k, binary, want):
    """`binary` is the scan's mode (False / True: WG_BF16 / WG_BINARY)."""
    n_pad, q_blocks, stages = ttopk.wg_plan(q, k, binary)
    assert (n_pad, q_blocks, stages) == want
    assert n_pad * q_blocks >= q and n_pad in (8, 16, 32, 64, 128)
    assert ttopk.wg_smem(n_pad, k, binary, stages) <= ttopk.SMEM_MAX


@pytest.mark.parametrize("binary", [False, True, ttopk.WG_INT8, ttopk.WG_INT8_ROWS,
                                    ttopk.WG_F32])
def test_wg_plan_fits_every_k_and_q(binary):
    """Every k up to the cap and Q up to 1000, in each mode (`binary`
    False / True: WG_BF16 / WG_BINARY): the plan fits a CTA's shared
    memory, covers Q, takes one query block whenever Q fits the widest
    block (64 in the int8 modes), and no more blocks than needed."""
    cap = ttopk.WG_N_MAX_INT8 if binary in (ttopk.WG_INT8, ttopk.WG_INT8_ROWS) \
        else ttopk.WG_N_MAX
    for k in range(1, ttopk.K_CAP + 1):
        nmax = max(n for n in (8, 16, 32, 64, 128)
                   if n <= cap and ttopk.wg_smem(n, k, binary, 2) <= ttopk.SMEM_MAX)
        for q in (1, 2, 9, 64, 65, 129, 256, 257, 511, 1000):
            n_pad, q_blocks, stages = ttopk.wg_plan(q, k, binary)
            assert 2 <= stages <= ttopk.WG_MAX_STAGES
            assert ttopk.wg_smem(n_pad, k, binary, stages) <= ttopk.SMEM_MAX
            assert q_blocks == -(-q // nmax) and n_pad * q_blocks >= q
            assert n_pad < 2 * -(-q // q_blocks) or n_pad == 8


@pytest.mark.parametrize("mode", [ttopk.WG_INT8, ttopk.WG_INT8_ROWS])
@pytest.mark.parametrize("q", [1, 64, 70, 256, 300])
@pytest.mark.parametrize("k", [10, 40, 128])
def test_wg_plan_int8(mode, q, k):
    """The int8 modes' plans: blocks of at most 64 queries (K9's
    accumulator, 2N wide, stays at 128 columns; K12's select runs over
    fewer lists a CTA), equal blocks covering Q, at least two stages, and
    the CTA's shared memory (a stage: the rows [128 m][128 B] and the
    digits [width][128 B]; K12 adds N query scales) within SMEM_MAX."""
    n_pad, q_blocks, stages = ttopk.wg_plan(q, k, mode)
    cap = 64
    assert q_blocks == -(-q // cap)
    assert n_pad == max(8, 1 << (-(-q // q_blocks) - 1).bit_length())
    assert 2 <= stages <= ttopk.WG_MAX_STAGES
    w = ttopk.wg_width(n_pad, mode)
    assert w <= 128
    stage = ttopk.WG_ROWS * ttopk.wg_m_tiles(w) * 128 + w * 128
    lists = n_pad * (8 * (k | 1) + 8 * ttopk.wg_cand(n_pad) + 12)
    fixed = 1024 + lists + (4 * n_pad if mode == ttopk.WG_INT8_ROWS else 0) \
        + 8 * 8 * ttopk.K_CAP + 16 * (ttopk.WG_MAX_STAGES + 2)
    assert ttopk.wg_smem(n_pad, k, mode, stages) == fixed + stages * stage <= ttopk.SMEM_MAX
    assert stages == ttopk.WG_MAX_STAGES or fixed + (stages + 1) * stage > ttopk.SMEM_MAX


@pytest.mark.parametrize("q", [1, 64, 70, 256, 300])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_wg_plan_f32(q, k):
    """The fp32 mode's plans: equal blocks of at most 128 queries covering
    Q, and the CTA's shared memory (a stage: the rows, [128 m][128 B], and
    the query's three parts, [3][n][64 B] rounded up to 1 KB, so that every
    stage's rows stay 1 KB aligned for the 128-byte swizzle) within
    SMEM_MAX, with as many stages as fit."""
    n_pad, q_blocks, stages = ttopk.wg_plan(q, k, ttopk.WG_F32)
    assert n_pad * q_blocks >= q and q_blocks >= -(-q // 128) and 2 <= stages
    stage = ttopk.WG_ROWS * ttopk.wg_m_tiles(n_pad) * 128 + -(-3 * n_pad * 64 // 1024) * 1024
    assert stage % 1024 == 0 and ttopk.wg_query_bytes(n_pad, ttopk.WG_F32) == 3 * n_pad * 64
    fixed = 1024 + n_pad * (8 * (k | 1) + 8 * ttopk.wg_cand(n_pad) + 12) \
        + 8 * 8 * ttopk.K_CAP + 16 * (ttopk.WG_MAX_STAGES + 2)
    assert ttopk.wg_smem(n_pad, k, ttopk.WG_F32, stages) == fixed + stages * stage \
        <= ttopk.SMEM_MAX
    assert stages == ttopk.WG_MAX_STAGES or fixed + (stages + 1) * stage > ttopk.SMEM_MAX


@pytest.mark.parametrize("sms,q_blocks,n_valid,row_tile,want", [
    (132, 1, 1_000_000, 256, 264),     # two waves of one query block (Q <= 64)
    (132, 2, 1_000_000, 128, 132),     # Q = 256: two query blocks
    (132, 1, 256, 256, 1),             # the direct-embed store: one 256-row tile
    (132, 1, 0, 128, 1),
    (132, 4, 1_000_000, 64, 66),       # four query blocks, 64-row tiles
    (132, 4, 1_000_000, 128, 66),      # K9 at Q = 256: four blocks of 64, 128-row tiles
])
def test_split_count(sms, q_blocks, n_valid, row_tile, want):
    assert ttopk.split_count(sms, q_blocks, n_valid, row_tile) == want


def test_wg_m_tiles():
    """Two m64 tiles a warpgroup (256-row tiles) up to a 64-column
    accumulator: a 64-query block, or K9's 32 (its digits double the
    width)."""
    assert [ttopk.wg_m_tiles(n) for n in (8, 16, 32, 64, 128)] == [2, 2, 2, 2, 1]
    assert [ttopk.wg_m_tiles(ttopk.wg_width(n, ttopk.WG_INT8))
            for n in (8, 16, 32, 64)] == [2, 2, 2, 1]
    assert all(ttopk.wg_width(n, m) == n for n in (8, 128)
               for m in (ttopk.WG_BF16, ttopk.WG_BINARY, ttopk.WG_INT8_ROWS))


def test_wg_route():
    """Every `rv_topk_stream` launch takes the wgmma scan, in the mode of
    its rows: fp32 rows (at d = 1024, and at d % 4 != 0, where the producer
    copies them) the split mode, bf16 rows at any d (d % 8 != 0 copied
    too), packed and int8 rows theirs."""
    bf16, f32 = kernels.DTYPE_CODES[torch.bfloat16], kernels.DTYPE_CODES[torch.float32]
    assert ttopk.wg_mode(bf16) == ttopk.WG_BF16 and ttopk.wg_mode(f32) == ttopk.WG_F32
    assert ttopk.wg_mode(kernels.INT8) == ttopk.WG_INT8
    assert ttopk.wg_mode(kernels.BINARY_PACKED) == ttopk.WG_BINARY
    assert len({ttopk.WG_BF16, ttopk.WG_BINARY, ttopk.WG_INT8, ttopk.WG_INT8_ROWS,
                ttopk.WG_F32}) == 5


def test_geometry_constants_mirror_the_kernel():
    """The Python mirror of scan_wg's constants reads the same values as
    the CUDA source."""
    src = open(SRC).read()
    for name, value in (("kRows", ttopk.WG_ROWS), ("kSlotBytes", ttopk.WG_SLOT_BYTES),
                        ("kMaxStages", ttopk.WG_MAX_STAGES), ("kNMax", ttopk.WG_N_MAX),
                        ("kNMaxI8", ttopk.WG_N_MAX_INT8), ("kSmemMax", ttopk.SMEM_MAX),
                        ("kModeBf16", ttopk.WG_BF16), ("kModeBin", ttopk.WG_BINARY),
                        ("kModeI8", ttopk.WG_INT8), ("kModeI8Rows", ttopk.WG_INT8_ROWS),
                        ("kModeF32", ttopk.WG_F32)):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert "topk_scan_tc_kernel" not in src and "topk_scan_bin_kernel" not in src
    # every row dtype runs on the wgmma scan: the CUDA-core FMA scan is gone
    for gone in ("topk_scan_kernel", "launch_scan", "TOPK_QT", "TOPK_RT", "TOPK_BK",
                 "TOPK_THREADS"):
        assert gone not in src, gone
    assert not hasattr(ttopk, "scan_splits") and not hasattr(ttopk, "_QUERY_TILE")
    # the int8 modes run on the wgmma scan: the WMMA kernel and its helpers are gone
    for gone in ("topk_scan_i8_kernel", "i8_load_stage", "topk_i8_smem", "TC_LDS",
                 "SC_BYTES", "topk_tc_state_bytes", "cp_async16", "<mma.h>", "wmma::"):
        assert gone not in src, gone


# ---------------------------------------------------------------------------
# (d) the int8 modes: K9's stacked digits, K12's row scales
# ---------------------------------------------------------------------------

def _int8_case(seed, n, d, q, rows, n_splits, nv):
    """Unit rows with row 3 copied on both sides of a row tile's boundary
    (rows - 1, rows) and of the first row split's (rps - 1, rps), and query
    0 equal to row 3, so that its top entries are exact ties. Returns the
    rows, the queries and the sorted tied rows below nv."""
    rng = np.random.default_rng(seed)
    db = random_unit(rng, n, d)
    qs = random_unit(rng, q, d)
    rps = -(-(-(-nv // n_splits)) // rows) * rows
    copies = sorted({rows - 1, rows, rps - 1, rps} & set(range(4, n)))
    db[copies] = db[3]
    qs[0] = db[3]
    return db, qs, sorted(r for r in [3] + copies if r < nv)


def _k9_scores(v8, hi, lo):
    """K9's unscaled scores in numpy: exact digit dots, f32(hi) * 254, then
    + f32(lo), each rounded to float32."""
    rows = v8.astype(np.int64).T
    s_hi = (hi.astype(np.int64) @ rows).astype(np.float32)
    s_lo = (lo.astype(np.int64) @ rows).astype(np.float32)
    return (s_hi * np.float32(254)).astype(np.float32) + s_lo


def _k12_scores(r8, rsc, q8, qsc):
    """K12's scores in numpy: (f32(dot) * q_scale) * row_scale, each
    product rounded to float32."""
    dots = (q8.astype(np.int64) @ r8.astype(np.int64).T).astype(np.float32)
    return (dots * qsc[:, None]).astype(np.float32) * rsc[None, :]


def _tile_rows(q, k, mode):
    n_pad = ttopk.wg_plan(q, k, mode)[0]
    return n_pad, ttopk.WG_ROWS * ttopk.wg_m_tiles(ttopk.wg_width(n_pad, mode))


# (n, d, q, k, n_valid, keep, n_splits)
K9_CASES = [
    (700, 64, 5, 4, None, None, 2),     # N = 8: an n16 accumulator, 256-row tiles
    (600, 48, 40, 10, 560, 0.6, 3),     # N = 64: n128, 128-row tiles; a mask, ragged n_valid
    (400, 32, 3, 128, None, None, 2),   # k = 128
]


@pytest.mark.parametrize("n,d,q,k,n_valid,keep,n_splits", K9_CASES)
def test_emulated_int8_digits_scan(n, d, q, k, n_valid, keep, n_splits):
    """K9 on the wgmma scan: the emulated selection (the launch's tile rows
    and candidate slots) over the two-rounding combined scores, scaled by
    c2 * db_scale as the wrapper does, equals the port's plain version bit
    for bit (ids and scores; the copies of row 3 across a tile and a split
    boundary come back in ascending order) and the JAX package's kernel in
    interpret mode under the tie-margin rule at 3e-5 (on the CPU, XLA
    contracts the reference's combine into one FMA:
    tests/test_torch_capacity.py::test_int8_exact_matches_jax)."""
    nv = n if n_valid is None else n_valid
    n_pad, rows = _tile_rows(q, k, ttopk.WG_INT8)
    db, qs, tied = _int8_case(n + d, n, d, q, rows, n_splits, nv)
    rng = np.random.default_rng(k)
    mask = None if keep is None else rng.random(n) < keep
    if mask is not None:
        mask[tied] = True
    jv, jsc = jtopk.quantize_db_int8(jnp.asarray(db))
    v8, scale = torch.from_numpy(np.array(jv)), torch.tensor(np.float32(jsc))
    hi, lo, c2 = ttopk.int8_query_digits(torch.from_numpy(qs))
    got_s, got_i = emulate_scan(_k9_scores(v8.numpy(), hi.numpy(), lo.numpy()), k, nv, mask,
                                n_splits, np.random.default_rng(1), rows=rows,
                                cand=ttopk.wg_cand(n_pad))
    got_s = got_s * (c2 * scale).numpy()   # `_scale`: one float32 product
    ps, pi = ttopk.cosine_topk_int8_ref(v8, scale, torch.from_numpy(qs), k, n_valid=n_valid,
                                        row_mask=mask)
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_s, ps.numpy())
    js, ji = (np.asarray(x) for x in jtopk.cosine_topk_int8_exact(
        jv, jsc, jnp.asarray(qs), k, n_valid=n_valid, interpret=True,
        row_mask=None if mask is None else jnp.asarray(mask)))
    _tie_margin_equal(got_s, got_i, js, ji, 3e-5)
    m = min(k, len(tied))
    assert list(got_i[0, :m]) == tied[:m]


# (n, d, q, k, n_valid, n_splits)
K12_CASES = [
    (700, 64, 5, 4, None, 2),       # N = 8: 256-row tiles
    (600, 80, 70, 40, 560, 3),      # two blocks of 35 (N = 64), k_fetch = 40 (warp merges)
    (300, 32, 3, 128, 250, 2),      # k = 128, k > n_valid of the rows kept
]


@pytest.mark.parametrize("n,d,q,k,n_valid,n_splits", K12_CASES)
def test_emulated_int8_rows_scan(n, d, q, k, n_valid, n_splits):
    """K12 on the wgmma scan: the emulated selection over the scores of
    the kernel's score step equals the port's plain version
    (`topk_int8_rows_ref`) bit for bit, ties to the lower row across tile
    and split boundaries, and the JAX package's stage-1 kernel in interpret
    mode (`_topk_int8_jit`) under the tie-margin rule at 1e-6."""
    nv = n if n_valid is None else n_valid
    n_pad, rows = _tile_rows(q, k, ttopk.WG_INT8_ROWS)
    db, qs, tied = _int8_case(n + d, n, d, q, rows, n_splits, nv)
    r8, rsc = ttk.quantize_rows(db)
    q8, qsc = ttk.quantize_queries(torch.from_numpy(qs))
    got_s, got_i = emulate_scan(_k12_scores(r8.numpy(), rsc.numpy(), q8.numpy(), qsc.numpy()),
                                k, nv, None, n_splits, np.random.default_rng(2), rows=rows,
                                cand=ttopk.wg_cand(n_pad))
    ps, pi = ttk.topk_int8_rows_ref(r8, rsc, q8, qsc, k, n_valid=n_valid)
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_s, ps.numpy())
    js, ji = map(np.asarray, jtk._topk_int8_jit(
        jnp.asarray(r8.numpy()), jnp.asarray(rsc.numpy()), jnp.asarray(q8.numpy()),
        jnp.asarray(qsc.numpy()), nv, k=k, kpad=-(-k // 8) * 8, q_tile=-(-q // 8) * 8,
        db_tile=128, interpret=True, q_out=q, n_bufs=4))
    _tie_margin_equal(got_s, got_i, js, ji, 1e-6)
    m = min(k, len(tied))
    assert list(got_i[0, :m]) == tied[:m]


def _accumulator_layout(w):
    """The wgmma m64nW accumulator layout (PTX's wgmma D fragments): for
    each thread (warp, lane) and register r = 4 i + e, its row 16 warp +
    lane / 4 + 8 (e >= 2) and column 8 i + 2 (lane % 4) + (e & 1)."""
    out = []
    for warp in range(4):
        for lane in range(32):
            regs = [(16 * warp + lane // 4 + 8 * (e >= 2), 8 * i + 2 * (lane % 4) + (e & 1))
                    for i in range(w // 8) for e in range(4)]
            out.append(regs)
    return out


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_stacked_digits_combine_in_registers(n):
    """K9's B operand stacks the hi digits (columns 0 .. n-1) over the lo
    digits (n .. 2n-1) of an n(2n) product. In the accumulator layout
    every (t4, e, i) puts column c and column c + n in one thread,
    registers r and r + n/2, so the combine is thread-local; combining
    them there in float32 with separate roundings, as the kernel's score
    step does, equals `int8_combine` of the two dot matrices."""
    rng = np.random.default_rng(n)
    d = 1040                                     # the exactness cap: |dot| < 2^24
    rows = rng.integers(-127, 128, (64, d))
    hi = rng.integers(-127, 128, (n, d))
    lo = rng.integers(-127, 128, (n, d))
    acc = rows @ np.concatenate([hi, lo]).T     # [64, 2n] s32 accumulator
    combined = np.full((64, n), np.nan, np.float32)
    for regs in _accumulator_layout(2 * n):
        assert len(regs) == n                   # 2n / 2 registers a thread
        for r in range(n // 2):                 # the hi half: columns < n
            (row, c), (row2, c2) = regs[r], regs[r + n // 2]
            assert c < n and (row2, c2) == (row, c + n)
            combined[row, c] = np.float32(np.float32(acc[row, c]) * np.float32(254)) \
                + np.float32(acc[row, c + n])
    want = ttopk.int8_combine(torch.from_numpy(acc[:, :n].astype(np.int32)),
                              torch.from_numpy(acc[:, n:].astype(np.int32)))
    np.testing.assert_array_equal(combined, want.numpy())


def test_k12_roundings_in_order():
    """K12's score step rounds after each multiply, in the reference's
    order: (f32(dot) * q_scale) * row_scale in float32 equals the JAX
    package's stage-1 scores at its ids bit for bit, and the other grouping,
    f32(dot) * (q_scale * row_scale), differs from them in the last bits."""
    rng = np.random.default_rng(12)
    n, d, q, k = 2000, 200, 6, 40
    db = random_unit(rng, n, d) * rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    qs = random_unit(rng, q, d)
    r8, rsc = ttk.quantize_rows(db)
    q8, qsc = ttk.quantize_queries(torch.from_numpy(qs))
    js, ji = map(np.asarray, jtk._topk_int8_jit(
        jnp.asarray(r8.numpy()), jnp.asarray(rsc.numpy()), jnp.asarray(q8.numpy()),
        jnp.asarray(qsc.numpy()), n, k=k, kpad=k, q_tile=8, db_tile=256, interpret=True,
        q_out=q, n_bufs=4))
    ours = _k12_scores(r8.numpy(), rsc.numpy(), q8.numpy(), qsc.numpy())
    np.testing.assert_array_equal(np.take_along_axis(ours, ji.astype(np.int64), 1), js)
    dots = (q8.numpy().astype(np.int64) @ r8.numpy().astype(np.int64).T).astype(np.float32)
    other = dots * (qsc.numpy()[:, None] * rsc.numpy()[None, :]).astype(np.float32)
    assert (np.take_along_axis(other, ji.astype(np.int64), 1) != js).any()


# ---------------------------------------------------------------------------
# (e) the fp32 mode: three bf16 parts a value, six products a k16 step, a
#     fresh step sum every 32 dims
# ---------------------------------------------------------------------------

def _f32_split_scores(db, qs):
    """The fp32 mode's [Q, N] scores in numpy, in the kernel's order: rows
    and queries split into three bf16 parts (`ops/split.py::split3`); per
    32-dim ring stage, the six products of SPLIT_TERMS (row part, query
    part; the term outer, its two k16 steps inner), each k16 dot rounded to
    float32 and added to a fresh float32 step sum, and each step sum added
    to the score in float32."""
    d = db.shape[1]
    dp = -(-d // 32) * 32

    def parts(x):
        return [np.pad(p.numpy(), ((0, 0), (0, dp - d))).astype(np.float64)
                for p in split3(torch.from_numpy(x))]

    rp, qp = parts(db), parts(qs)
    score = np.zeros((len(qs), len(db)), np.float32)
    for s0 in range(0, dp, 32):
        step = np.zeros_like(score)
        for a, b in SPLIT_TERMS:
            for kk in (0, 16):
                sl = slice(s0 + kk, s0 + kk + 16)
                step = step + (qp[b][:, sl] @ rp[a][:, sl].T).astype(np.float32)
        score = score + step
    return score


# (n, d, q, k, n_valid, keep, n_splits)
F32_CASES = [
    (700, 64, 5, 1, None, None, 2),      # k = 1; N = 8: 256-row tiles
    (900, 100, 70, 10, 777, 0.6, 3),     # N = 128: 128-row tiles; a mask, ragged n_valid
    (600, 77, 3, 20, None, None, 2),     # d % 4 != 0: the producer copies the rows
    (300, 1021, 9, 128, 250, None, 2),   # k = 128 > the rows kept, d = 1021
    (300, 48, 4, 10, 260, 0.0, 2),       # every row masked
]


@pytest.mark.parametrize("n,d,q,k,n_valid,keep,n_splits", F32_CASES)
def test_emulated_f32_split_scan(n, d, q, k, n_valid, keep, n_splits):
    """K1 and K2 on fp32 rows: the emulated selection (the launch's tile
    rows and candidate slots) over the split mode's scores in the kernel's
    order, against the port's plain version (`cosine_topk_ref`, exact fp32)
    and the JAX package's `cosine_topk` on float32 rows (its Pallas kernel
    at Precision.HIGHEST, interpret mode) under the tie-margin rule, and
    against float64 truth over the rows kept (`assert_topk_equiv`): scores
    within 1e-5 (the split's dropped terms are below 2^-23 of a product;
    the sums run in another order), ids equal where the margins are
    clear, ties to the lower row."""
    nv = n if n_valid is None else n_valid
    n_pad, rows = _tile_rows(q, k, ttopk.WG_F32)
    db, qs, tied = _int8_case(n + d, n, d, q, rows, n_splits, nv)
    rng = np.random.default_rng(k + d)
    mask = None if keep is None else rng.random(n) < keep
    if mask is not None and keep > 0:
        mask[tied] = True
    got_s, got_i = emulate_scan(_f32_split_scores(db, qs), k, nv, mask, n_splits,
                                np.random.default_rng(3), rows=rows, cand=ttopk.wg_cand(n_pad))
    tol = 1e-5
    ps, pi = ttopk.cosine_topk(torch.from_numpy(db), torch.from_numpy(qs), k, n_valid=n_valid,
                               row_mask=mask)   # the plain version on the CPU
    _tie_margin_equal(got_s, got_i, ps.numpy(), pi.numpy(), tol)
    js, ji = (np.asarray(x) for x in jtopk.cosine_topk(
        jnp.asarray(db), jnp.asarray(qs), k, n_valid=n_valid, q_tile=8, db_tile=256,
        row_mask=None if mask is None else jnp.asarray(mask)))
    _tie_margin_equal(got_s, got_i, js, ji, tol)
    kept = np.arange(n) < nv
    if mask is not None:
        kept &= mask
    if not kept.any():
        assert (got_i == -1).all() and np.isneginf(got_s).all()
        return
    sub = np.flatnonzero(kept)
    pos = np.full(n, -1)
    pos[sub] = np.arange(len(sub))
    k_eff = min(k, len(sub))
    assert (got_i[:, k_eff:] == -1).all()
    assert_topk_equiv(db[sub], qs, got_s[:, :k_eff], pos[got_i[:, :k_eff]], k_eff, tol=tol)
    m = min(k, len(tied))
    assert list(got_i[0, :m]) == tied[:m]


def test_f32_fragments_read_the_swizzled_stage():
    """`split_frag`'s reads of a ring stage: TMA places 16-byte chunk j of
    row r of a [rows][32 fp32] box at chunk j ^ (r % 8) (the 128-byte
    swizzle; the producer's copies do the same). The kernel's address of
    element (r, c), r * 128 + ((c / 4) ^ (r % 8)) * 16 + (c % 4) * 4, read
    as float2 at the RS-form A fragment's places (rows r and r + 8 of each
    warp's 16, columns 2 (lane % 4) + {0, 1} and + 8 of each k16 step),
    gives every element of the stage exactly once, at its own place."""
    rows = 256
    rng = np.random.default_rng(0)
    tile = rng.standard_normal((rows, 32)).astype(np.float32)
    stage = np.empty(rows * 32, np.float32)
    for r in range(rows):
        for j in range(8):
            dst = r * 32 + 4 * (j ^ (r % 8))
            stage[dst:dst + 4] = tile[r, 4 * j:4 * j + 4]
    seen = np.zeros((rows, 32), int)
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                rr = wg * 64 * 2 + warp * 16 + lane // 4
                for mt in range(2):
                    for kk in range(2):
                        c = 16 * kk + 2 * (lane % 4)
                        for r, cc in ((rr + 64 * mt, c), (rr + 64 * mt + 8, c),
                                      (rr + 64 * mt, c + 8), (rr + 64 * mt + 8, c + 8)):
                            byte = r * 128 + (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4
                            got = stage[byte // 4:byte // 4 + 2]
                            np.testing.assert_array_equal(got, tile[r, cc:cc + 2])
                            seen[r, cc:cc + 2] += 1
    assert (seen == 1).all()


def test_launch_key_counts_fp32_rows_apart():
    """`kernels.shape_launches` keys: a launch on fp32 rows counts under
    "topk_stream_f32", masked or not, so that chip_smoke.py times each
    shape on rows of the dtype it ran on; bf16, int8 and packed rows count
    under their mode's counter."""
    shape = (64, 1_000_000, 1024, 10, True)
    plain = shape[:4] + (False,)
    assert ttopk.launch_key("topk_masked", torch.float32, shape) == ("topk_stream_f32", shape)
    assert ttopk.launch_key("topk_stream", torch.float32, plain) == ("topk_stream_f32", plain)
    assert ttopk.launch_key("topk_masked", torch.bfloat16, shape) == ("topk_masked", shape)
    assert ttopk.launch_key("topk_stream", torch.bfloat16, plain) == ("topk_stream", plain)
    assert ttopk.launch_key("topk_int8", torch.int8, shape) == ("topk_int8", shape)
    assert ttopk.launch_key("topk_binary", torch.uint8, plain) == ("topk_binary", plain)
