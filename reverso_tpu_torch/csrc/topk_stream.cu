// Exact dot-product top-k with a fused per-query k-select, in five modes.
//
// Replaces: reverso_tpu/ops/topk.py::_topk_stream_kernel in
//   * its plain mode (entry cosine_topk_pallas): bf16 rows, and fp32 rows
//     at Precision.HIGHEST (K1);
//   * its masked mode (cosine_topk_pallas(row_mask=)): K1 with a per-row
//     filter (K2);
//   * its int8 mode (entry cosine_topk_int8_exact): int8 rows, each query
//     split into two int8 digits, exact s32 dots (K9);
//   * its binary mode (entry ops/binary.py::binary_topk_pallas): planar
//     sign-packed uint8 rows scored as +-1 against the bf16 query (K10);
// and reverso_tpu/ops/topk_int8.py::_topk_int8_kernel (entry
// cosine_topk_int8): int8 rows with per-row f32 scales against one int8
// digit per query with a per-query scale, the candidate stage of the
// two-stage search (K12, `rv_topk_int8_rows`). The IVF probed scan (K11,
// csrc/ivf_scan.cu) runs the bf16, fp32 and int8 modes over a work table
// (`launch_ivf`).
// Every mode but K12 takes the optional [N] uint8 row mask.
//
// What bounds it on the H100 (published SXM peaks, 700 W), at 1M x 1024:
// bf16 reads 2.05 GB (0.61 ms at 3.35 TB/s) at any Q, against 2 Q N d
// operations: 0.002 ms at Q = 1, 0.136 at Q = 64, 0.53 at Q = 256 (989
// TFLOP/s), so bytes up to Q ~ 290; fp32 reads 4.1 GB (1.22 ms) for six
// bf16 products of split parts (the TPU's HIGHEST, 989 / 6 TFLOP/s): 0.80
// ms at Q = 64, 3.18 at Q = 256, so bytes up to Q ~ 98; binary reads 128
// MB (0.04 ms) for the same operations against the +-1 rows, so operations
// from Q ~ 20 on (0.136 ms at Q = 64, 0.53 at Q = 256); int8 reads 1.02 GB
// (0.31 ms) for 1.05 T int8 operations in two digits at Q = 256 (0.53 ms);
// K12 reads 1.02 GB of rows and 4 MB of row scales (0.31 ms) for 0.52 T
// (0.26 ms).
//
// What the design does about it:
//   * every mode (bf16 rows: K1, K2; fp32 rows: K1, K2 in the split mode;
//     packed rows: K10; int8 rows: K9, K12) runs one wgmma scan (scan_wg
//     below), templated on what it scores. A CTA scores each 256-row tile
//     (128 where the accumulator is wider than 64 columns) of its row slice
//     against a whole block of queries, so the rows are read from device
//     memory once per query block: bf16, fp32 and binary blocks of up to
//     128 queries (Q = 1 is an n8 product, a pure stream), int8 blocks of
//     up to 64: K9's two query digits are one B operand of 2N rows (an n128
//     accumulator at 64 queries), K12's k-select at k_fetch = 40 runs over
//     half the lists a CTA. A producer warp feeds a TMA ring (rows whose
//     stride or base TMA cannot take are copied by its lanes, in TMA's
//     swizzle); two consumer warpgroups own 128 rows (64 where the
//     accumulator is wider than 64) each on wgmma's M side with the
//     queries on N. Packed rows are unpacked straight into the RS-form A
//     registers, in a dimension order that makes one byte a thread's 8
//     fragment values; fp32 rows are split there, each value into three
//     bf16 parts, against the query block's three parts (made once per
//     launch by the split pass) in shared memory, six products a k16 step
//     (hopper.cuh::split_part), so no pass over the rows writes parts.
//     int8 rows and digits are K-major as they lie, 128 bytes of d a ring
//     stage (four k32 s8 products, exact s32 sums). The k-select gates the
//     scores against each query's k-th entry, so once the lists fill a tile
//     costs one compare per score and rarely an insert. Measured on the
//     H100 (scripts/topk_scan_probe.py): bf16 0.67 ms at Q = 1, 0.73 at
//     Q = 64, 1.61 at Q = 256 (k = 10); binary 0.95 at Q = 64 and 2.67 at
//     Q = 256 (k = 30), where the products are still 3.4x their bound and
//     the select at k = 30 half the time; K9 0.61 ms at Q = 64 (10% of the
//     rows kept) and 1.67 at Q = 256 (k = 10), where the four query blocks
//     read the rows from device memory four times; K12 1.88 at Q = 256,
//     k_fetch = 40, 58% of it the select; fp32 2.05 at Q = 64 and 5.50 at
//     Q = 256 (k = 10), 89% of it the products phase, at about 55% of the
//     tensor cores' rate (a 32-dim stage of 128 rows x 128 queries in 2.8k
//     cycles against 1.5k: each warpgroup splits, multiplies and sums a
//     stage in turn);
//   * fp32: a ring stage holds 128 bytes (32 dims) of each row and of each
//     of the query's three parts 64 bytes (64-byte swizzle, as the MLP's
//     split GEMMs). A stage's twelve products (six terms, two k16 steps)
//     land in a fresh accumulator that the CUDA cores add to the score in
//     fp32: the tensor cores' fp32 sums do not round to nearest, and over
//     one accumulator their error grows with the steps summed (PERF.md
//     section 6). The score, the step accumulator and the fragments need the
//     producer warpgroup's registers (threads_of);
//   * K9: the two exact s32 dots combine as f32(hi) * 254 + f32(lo) with
//     two roundings (__fmul_rn, __fadd_rn: nvcc would contract a*b+c into
//     one FMA, one rounding, and the scores would differ from the reference
//     in the last bit), in registers before the gate: the thread that holds
//     hi's column c holds lo's column c + N. The per-query scale is applied
//     outside;
//   * K12: the exact s32 dot, then (f32(dot) * q_scale) * row_scale with
//     __fmul_rn, the reference's two roundings in its order, in registers
//     (on the TPU the dot ran bf16 on upcast int8, exact for d <= 1040; the
//     s32 dot is exact for any d);
//   * rows at or past n_valid are never scored; masked rows never enter
//     the lists. Each CTA writes [n_splits, Q, k] partials;
//   * pass 2: one warp per query merges the n_splits sorted partials by
//     (-score, idx): deterministic, ties to the lower row;
//   * the [Q, N] score matrix never exists; slots still at -inf return -1.
// k is capped at TOPK_KMAX = 128 (the reference kernel's cap).
#include <type_traits>

#include "hopper.cuh"
#include "topk_select.cuh"

namespace rv {

constexpr int BIN_WMAX = 1024;  // packed plane width cap (d <= 8192)

// ---- the wgmma scan: every query of a block against each row tile ---------
//
// K1, K2 (bf16 rows; fp32 rows in the split mode), K10 (packed sign rows),
// K9 (int8 rows, two int8 query digits) and K12 (int8 rows with row
// scales, one digit): one kernel, its MODE a template parameter with a
// per-mode score step. A CTA owns one contiguous slice of rows (grid x)
// and one block of up to N queries (grid y), and walks the slice in tiles
// of 128 m_tiles(W) rows (W the accumulator's columns: N, or 2N for K9), so
// each row tile is read from device memory once per query block:
//   * a producer warp brings, per k step (128 bytes of d: 64 bf16, 32 fp32
//     or 128 int8 dims), the query block's columns (K9: the hi digits into
//     B rows 0 .. N-1, the lo digits into N .. 2N-1, two TMA loads; fp32:
//     its three bf16 parts, three loads) and, but for packed rows, the
//     tile's rows through TMA into a ring of `stages` stages with mbarrier
//     completion; packed rows come 128 bytes (1024 dims) a row at a time
//     into a two-slot chunk ring of their own. Rows whose stride or base
//     TMA cannot take (a row that is not a multiple of 16 bytes: bf16 D % 8
//     != 0, fp32 D % 4 != 0, packed W or int8 D % 16 != 0; or a base that
//     is not 16-byte aligned) are copied by the producer's lanes, but for
//     packed rows into the ring in TMA's 128-byte swizzle (zeros past D add
//     nothing to a dot). The query operand is re-read from L2 for every row
//     tile: loading it only once changes no time measurably
//     (scripts/topk_scan_probe.py "no_qstream_gate");
//   * two consumer warpgroups each own 64 m_tiles(W) of the tile's rows on
//     wgmma's M side (two m64 tiles at W <= 64: two independent chains of
//     products a warpgroup), the query block on its N side (N a power of
//     two, 8 .. 128), and accumulate in registers: bf16 rows by the SS-form
//     product (fp32), int8 rows by the s8 SS form (k32, exact s32), packed
//     rows unpacked (two bytes a row per k step, two instructions per pair
//     of +-1 bf16 values, sign_pairs) straight into the RS form's A
//     registers, double-buffered at N = 128 so that a step's unpack
//     overlaps the last step's products, fp32 rows read from the swizzled
//     stage and split into three RS-form fragments (split_frag) whose six
//     products a k16 step go to a step accumulator (above). A 128-register accumulator spills
//     (the probe's "n256"), so blocks stop at W = 128: bf16 reads the rows twice
//     at Q = 256, K9 and K12 (64-query blocks) four times: the four blocks
//     of a row slice run at once in the one wave, but L2 does not serve the
//     repeats (K9's products and loads take four reads' time). K9 in
//     128-query blocks, reading the rows twice, is 6% faster at Q = 256
//     with 360 bytes of spills; K12 in 128-query blocks is 31% slower, its
//     select over twice the lists (scripts/topk_scan_probe.py "i8_n128");
//   * int8 score steps, in registers after the tile's last product: K9
//     combines the s32 dots of hi's column c and lo's column c + N, which
//     the accumulator layout (column 8i + 2 (lane % 4) + (e & 1)) puts in
//     one thread, as __fadd_rn(__fmul_rn(f32(hi), 254), f32(lo)); K12
//     scales as __fmul_rn(__fmul_rn(f32(dot), q_scale), row_scale). The
//     f32 score replaces the s32 in hi's register;
//   * the k-select: each thread holds 2 m_tiles(W) rows x N/4 queries of
//     scores and compares them with the queries'
//     current k-th (score, idx) (the TPU kernel's gate, exact in the order
//     (-score, idx), so that an equal score from a lower row passes and
//     one from a higher row does not). Survivors take one of their query's
//     candidate slots (16 KB over the block: 16 a query at N = 128, 32 at
//     N <= 64; one shared-memory atomic per warp and query column). Then
//     query q's candidates enter its sorted list by (-score, idx) in any
//     arrival order: its own thread inserts them from the list's end when
//     that is at most kSerial shifts (nc k <= 48: short lists, as k = 10),
//     else warp q % 8 merges them in one pass (warp_merge), so that long
//     lists (k = 30, 40) and the first tiles' many candidates cost no serial
//     shifts. A candidate that found the slots full is gated again,
//     against the new k-th, in another round. Once the lists hold k rows a
//     tile rarely has a survivor, and the producer keeps loading meanwhile.
// The grid takes at most one wave of CTAs (the kernel's occupancy x SMs),
// so that each CTA fills its lists once over as many rows as possible.
// Binary dimension order: the k loop's position kappa of byte p (p = 8 s +
// 4 m + t, t = p % 4) and bit b is 64 s + 32 m + 16 (b >> 2) + 8 ((b >> 1)
// & 1) + 2 t + (b & 1), so that byte 4m + t of a row holds, for the
// consumer thread with lane % 4 == t, exactly its 8 A-fragment values of
// k16 chunks 2m and 2m + 1 of step s. The score is a sum over dimensions,
// so the host permutes the bf16 query to this order (dim b W + p -> kappa;
// bytes past W give zero query columns) and the products are unchanged;
// only the fp32 sums run in another order.
namespace scan_wg {

using namespace tc;

// per-CTA cycle counts of the products, the gate and the select rounds,
// printed by CTA 0 (scripts/topk_scan_probe.py "profile" defines this)
#ifdef RV_SCAN_PROFILE
#define RV_PROF(...) __VA_ARGS__
#else
#define RV_PROF(...)
#endif

// what a launch scores (ops/topk.py's WG_* modes mirror these)
constexpr int kModeBf16 = 0;     // bf16 rows (K1, K2)
constexpr int kModeBin = 1;      // packed sign rows (K10)
constexpr int kModeI8 = 2;       // int8 rows, two query digits (K9)
constexpr int kModeI8Rows = 3;   // int8 rows with row scales, one digit (K12)
constexpr int kModeF32 = 4;      // fp32 rows, split mode (K1, K2)

constexpr int kRows = 128;                     // rows of an m64 tile each for two warpgroups
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kThreads = kConsumers + 32;      // + the producer warp
constexpr int kF32ProducerRegs = 56;           // fp32: the producer warpgroup's registers
constexpr int kSlotBytes = 16384;              // the candidate slots of a query block
constexpr int kSerial = 48;                    // list shifts a thread takes on alone
constexpr int kMaxStages = 8;
constexpr int kNMax = 128;                     // queries of a block
constexpr int kNMaxI8 = 64;                    // the int8 modes' (see n_cap)
constexpr int kSmemMax = 232448;               // shared memory a CTA may use
constexpr int kChunk = 128;                    // packed bytes of a row per chunk
constexpr int kChunkSteps = kChunk / 8;        // 64-wide k steps per chunk

// the widest query block: 128, or 64 in the int8 modes. K9's accumulator
// is 2N wide, and an n256 one (128 registers) spills; K12's k-select at
// k_fetch = 40 costs less over half the lists a CTA, though its rows are
// then read four times at Q = 256 (PERF.md section 6)
__host__ __device__ constexpr int n_cap(int mode) {
    return mode == kModeI8 || mode == kModeI8Rows ? kNMaxI8 : kNMax;
}

// threads of a CTA: two consumer warpgroups and the producer warp, or in
// the fp32 mode a producer warpgroup, so that it can hand registers to the
// consumers (setmaxnreg): 224 a consumer thread, where the launch bound
// leaves 168 and the step accumulator and the split fragments spilled
__host__ __device__ constexpr int threads_of(int mode) {
    return mode == kModeF32 ? 3 * kWgThreads : kThreads;
}

// the accumulator's columns: the query block, twice over for K9's digits
__host__ __device__ constexpr int width(int n, int mode) { return mode == kModeI8 ? 2 * n : n; }

// m64 tiles a warpgroup: two (a 256-row tile) at an accumulator width
// w <= 64 (at most 32 registers), so that each warpgroup runs two
// independent chains of products and a tile's k-select covers twice the
// rows; one at w = 128
__host__ __device__ constexpr int m_tiles(int w) { return w <= 64 ? 2 : 1; }

// dims of d a ring stage holds: 128 bytes of a bf16, fp32 or int8 row; 64
// dims of the permuted binary query a k step
__host__ __device__ constexpr int k_dims(int mode) {
    return mode == kModeF32 ? 32 : mode == kModeI8 || mode == kModeI8Rows ? 128 : 64;
}

// bytes of the query block's B operand a stage: [width][128 B] swizzled, or
// fp32's three bf16 parts, [3][n][64 B] (64-byte swizzle)
__host__ __device__ constexpr int query_bytes(int n, int mode) {
    return mode == kModeF32 ? 3 * n * 64 : width(n, mode) * 128;
}

// bytes of one ring stage: but for binary (its rows live in the chunk
// ring) the tile's rows, [128 m_tiles][128 B], then the query operand,
// rounded up to 1 KB so that every stage's rows keep the 128-byte
// swizzle's 1 KB alignment (fp32 at n = 8: 1536 bytes of parts)
__host__ __device__ constexpr int stage_bytes(int n, int mode) {
    return (mode == kModeBin ? 0 : kRows * m_tiles(width(n, mode)) * 128) +
           (query_bytes(n, mode) + 1023) / 1024 * 1024;
}

// candidate slots per query: 16 KB of (score, row) pairs over the block,
// at most 32 a query (one per lane of a warp merge)
__host__ __device__ constexpr int cand_slots(int n) {
    return kSlotBytes / 8 / n < 8 ? 8 : kSlotBytes / 8 / n > 32 ? 32 : kSlotBytes / 8 / n;
}

// whether a CTA keeps a scale per query column: K12's query scales, and
// the IVF scan's int8 scales (one a (query, probe) pair)
__host__ __device__ constexpr bool q_scales(int mode, bool ivf) {
    return mode == kModeI8Rows || (ivf && mode == kModeI8);
}

// 1 KB of alignment, binary mode's chunk ring, the ring, the sorted lists
// ([N][k | 1]), the candidate slots, the k-th entries and counts, the
// query scales, the consumer warps' merge scratch ([8][128] pairs), the
// barriers
__host__ __device__ inline size_t smem_bytes(int n, int k, int mode, int stages,
                                             bool ivf = false) {
    return 1024 + (mode == kModeBin ? 2 * kRows * m_tiles(n) * kChunk : 0) +
           (size_t)stages * stage_bytes(n, mode) +
           (size_t)n * (8 * (k | 1) + 8 * cand_slots(n) + 12 + (q_scales(mode, ivf) ? 4 : 0)) +
           8 * 8 * TOPK_KMAX + 16 * (kMaxStages + 2);
}

// The launch geometry (ops/topk.py::wg_plan mirrors it): the widest query
// block N (up to n_cap) whose sorted lists fit beside a two-stage ring, Q
// split into q_blocks blocks of equal size, N the power of two >= a block,
// and as many stages (2 .. 8) as fit.
struct Plan {
    int n, q_blocks, stages;
};

// as many stages (2 .. 8) as fit beside query blocks of n
inline int stages_at(int n, int k, int mode, bool ivf) {
    int stages = 2;
    while (stages < kMaxStages && smem_bytes(n, k, mode, stages + 1, ivf) <= kSmemMax) ++stages;
    return stages;
}

inline Plan plan(int Q, int k, int mode) {
    int nmax = 8;
    for (int n = n_cap(mode); n >= 8; n /= 2)
        if (smem_bytes(n, k, mode, 2) <= kSmemMax) { nmax = n; break; }
    const int q_blocks = ceil_div(Q, nmax);
    const int per = ceil_div(Q, q_blocks);
    int n = 8;
    while (n < per) n *= 2;
    return {n, q_blocks, stages_at(n, k, mode, false)};
}

// bits 2p and 2p + 1 of the byte x as a bf16 pair of +-1 (bit 1 -> +1), low
// half first: with a second copy of x at bit 15, one shift puts bit 2p at
// bit 15 and bit 2p + 1 at bit 31, the two sign bits of -1 -1 (0xBF80BF80)
__device__ __forceinline__ uint32_t sign_pairs(uint32_t x, int p) {
    return 0xBF80BF80u ^ (((x | (x << 15)) << (15 - 2 * p)) & 0x80008000u);
}

// Merges nc <= 32 candidates (cs[e * stride], ci[e * stride], e < nc; row
// ids distinct from the list's) into the warp's sorted list S/I of length
// k <= 128 by (-score, idx), in one pass through the warp's scratch list
// XS/XI: each entry's new place is its old one plus the candidates that
// beat it, each candidate's the entries and candidates that beat it;
// places past k drop out.
__device__ __forceinline__ void warp_merge(float* S, int* I, int k, const float* cs,
                                           const int* ci, int stride, int nc, float* XS,
                                           int* XI, int lane) {
    const float c_s = lane < nc ? cs[lane * stride] : -CUDART_INF_F;
    const int c_i = lane < nc ? ci[lane * stride] : 0x7fffffff;
    int pos = 0;
    for (int j0 = 0; j0 < k; j0 += 32) {
        const int jj = j0 + lane;
        const float ls = jj < k ? S[jj] : -CUDART_INF_F;
        const int li = jj < k ? I[jj] : -1;
        int lpos = jj;
#pragma unroll 4
        for (int e = 0; e < nc; ++e) {
            const float s2 = __shfl_sync(0xffffffffu, c_s, e);   // every lane shuffles
            const int i2 = __shfl_sync(0xffffffffu, c_i, e);
            if (j0 == 0) pos += better(s2, i2, c_s, c_i) ? 1 : 0;
            const bool entry_wins = jj < k && better(ls, li, s2, i2);
            const unsigned b = __ballot_sync(0xffffffffu, entry_wins);
            if (lane == e) pos += __popc(b);
            lpos += entry_wins ? 0 : 1;
        }
        if (jj < k && lpos < k) {
            XS[lpos] = ls;
            XI[lpos] = li;
        }
    }
    if (lane < nc && pos < k) {
        XS[pos] = c_s;
        XI[pos] = c_i;
    }
    __syncwarp();
    for (int jj = lane; jj < k; jj += 32) {
        S[jj] = XS[jj];
        I[jj] = XI[jj];
    }
    __syncwarp();
}

// Bytes c0 .. c0 + 127 of rows r0 .. r0 + ROWS - 1 (row stride row_bytes),
// zero past the row or at r_end and beyond, copied by the producer warp's
// lanes into dst as [ROWS][128 B]; `swizzle` places 16-byte chunk j of row r
// at chunk j ^ (r % 8), as TMA's 128-byte swizzle does
template <int ROWS>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const unsigned char* rows, int row_bytes,
                                          int r0, int r_end, int c0, bool swizzle, int lane) {
    for (int r = lane; r < ROWS; r += 32) {
        const int row = r0 + r;
        for (int j = 0; j < 8; ++j) {
            uint32_t w4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int b = 0; b < 16; ++b) {
                const int c = c0 + 16 * j + b;
                const uint32_t v = (row < r_end && c < row_bytes) ? rows[(size_t)row * row_bytes + c] : 0u;
                w4[b / 4] |= v << (8 * (b % 4));
            }
            *reinterpret_cast<uint4*>(dst + r * 128 + 16 * (swizzle ? j ^ (r & 7) : j)) =
                make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
    }
}

// One k16 step's RS-form A fragment of fp32 rows, split into three bf16
// parts f[part][register] (0 hi, 1 mid, 2 lo): rows r and r + 8, columns c,
// c + 1 and c + 8, c + 9 (c even) of a stage's rows, [rows][32 fp32] in
// TMA's 128-byte swizzle (16-byte chunk j of row r at j ^ (r % 8))
__device__ __forceinline__ void split_frag(const uint8_t* tile, int r, int c,
                                           uint32_t (&f)[3][4]) {
    auto at = [&](int row, int col) {
        return *reinterpret_cast<const float2*>(tile + row * 128 +
                                                (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4);
    };
    const float2 x[4] = {at(r, c), at(r + 8, c), at(r, c + 8), at(r + 8, c + 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(x[e].x, x[e].y, f[0][e], f[1][e], f[2][e]);
}

// fp32 mode: a stage's step accumulators and operand fragments, fenced
// (fence_operand) before its products are issued and after they are done
template <int MT, int NW>
__device__ __forceinline__ void fence_step(float (&step)[MT][NW], uint32_t (&fr)[MT][2][3][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        fence_operand(step[mt]);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
            for (int p = 0; p < 3; ++p) fence_operand(fr[mt][kk][p]);
    }
}

__device__ __forceinline__ float score_of(float acc) { return acc; }
__device__ __forceinline__ float score_of(int acc) { return __int_as_float(acc); }   // int8 modes

// a CTA's slice of the scan: rows r_begin .. r_end - 1, query columns q0 ..
// q0 + nq - 1 of the query operand, and the split its partial lists go to
struct Slice {
    int r_begin, r_end, q0, nq, split;
};

// IVF: false, a CTA scans one (row split, query block) of the grid; true
// (K11), the CTAs walk the work table `work` ([items][5]: a Slice each;
// *n_work items, written by the plan on the card) at a stride of the grid,
// and int8 scores take the column's scale (q_scale, one a column of the
// query operand) before the gate
template <int N, int MODE, bool IVF>
__global__ void __launch_bounds__(threads_of(MODE), 1)
topk_scan_wg_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap qmap,
                    const unsigned char* __restrict__ rows, int row_bytes,
                    const unsigned char* __restrict__ mask, const float* __restrict__ q_scale,
                    const float* __restrict__ row_scale, int Q, int n_valid, int k,
                    int n_k, int rows_per_split, int stages,
                    const int* __restrict__ work, const int* __restrict__ n_work,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
    constexpr bool BIN = MODE == kModeBin;
    constexpr bool I8 = MODE == kModeI8 || MODE == kModeI8Rows;
    constexpr bool F32 = MODE == kModeF32;
    constexpr int W = width(N, MODE);                // accumulator columns
    constexpr int MT = m_tiles(W);
    constexpr int ROWS = kRows * MT;                 // rows of a tile
    constexpr int STAGE = stage_bytes(N, MODE);
    constexpr int A_BYTES = BIN ? 0 : ROWS * 128;    // the rows' part of a stage
    constexpr int QB = query_bytes(N, MODE);         // the query operand's
    constexpr int KS = k_dims(MODE);                 // dims of a k step
    constexpr int THREADS = threads_of(MODE);
    constexpr int NV = N / 2;                        // scores of one m64 tile a thread holds
    constexpr int NP = (MT * NV + 31) / 32;          // words of its pending bits
    constexpr int NC = cand_slots(N);                // candidate slots per query
    constexpr bool QSC = q_scales(MODE, IVF);        // a scale per query column
    constexpr unsigned FULL = 0xffffffffu;
    using Acc = std::conditional_t<I8, int, float>;  // s32 sums, or fp32
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* chunks = ring + stages * STAGE;                          // binary: [2][ROWS][128 B]
    float* st_s = reinterpret_cast<float*>(chunks + (BIN ? 2 * ROWS * kChunk : 0));
    const int kp = k | 1;   // the lists' row stride: odd, so one thread a query hits no bank twice
    int* st_i = reinterpret_cast<int*>(st_s + kp * N);                // [N][kp], [N][kp]
    float* cand_s = reinterpret_cast<float*>(st_i + kp * N);          // [NC][N]
    int* cand_i = reinterpret_cast<int*>(cand_s + NC * N);            // [NC][N]
    float* kth_s = reinterpret_cast<float*>(cand_i + NC * N);         // [N] the k-th entry
    int* kth_i = reinterpret_cast<int*>(kth_s + N);                   // [N]
    int* cnt = kth_i + N;                                             // [N] candidates
    float* qsc = reinterpret_cast<float*>(cnt + N);                   // QSC: [N] query scales
    float* xs = qsc + (QSC ? N : 0);                                  // [8][TOPK_KMAX] scratch
    int* xi = reinterpret_cast<int*>(xs + 8 * TOPK_KMAX);             // [8][TOPK_KMAX]
    uint64_t* full = reinterpret_cast<uint64_t*>(xi + 8 * TOPK_KMAX);
    uint64_t* empty = full + kMaxStages;
    uint64_t* cfull = empty + kMaxStages;                             // the chunk ring's
    uint64_t* cempty = cfull + 2;

    const int n_items = IVF ? *n_work : 1;
    const int item0 = IVF ? blockIdx.x : 0, item_step = IVF ? gridDim.x : 1;
    auto slice_of = [&](int item) {
        Slice out{0, 0, 0, 0, 0};
        if constexpr (IVF) {
            if (item < n_items) {
                const int* w = work + 5 * (size_t)item;
                out = Slice{w[0], w[1], w[2], w[3], w[4]};
            }
        } else {
            out.split = blockIdx.x;
            out.q0 = blockIdx.y * N;
            out.r_begin = out.split * rows_per_split;
            out.r_end = min(n_valid, out.r_begin + rows_per_split);
            out.nq = min(N, Q - out.q0);
        }
        return out;
    };
    auto n_tiles_of = [&](const Slice& sl) {
        return sl.r_end > sl.r_begin ? ceil_div(sl.r_end - sl.r_begin, ROWS) : 0;
    };
    // empty sorted lists, k-th entries at -inf, the slice's query scales
    auto init_lists = [&](const Slice& sl, int tid, int n_threads) {
        for (int idx = tid; idx < kp * N; idx += n_threads) {
            st_s[idx] = -CUDART_INF_F;
            st_i[idx] = -1;
        }
        for (int idx = tid; idx < N; idx += n_threads) {
            kth_s[idx] = -CUDART_INF_F;
            kth_i[idx] = -1;
            cnt[idx] = 0;
            if (QSC) qsc[idx] = idx < sl.nq ? q_scale[sl.q0 + idx] : 0.f;
        }
    };
    Slice sl = slice_of(item0);
    init_lists(sl, threadIdx.x, THREADS);
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 32);   // the producer warp's lanes
            mbar_init(&empty[s], 8);   // the consumers' warps
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(&cfull[s], 32);
            mbar_init(&cempty[s], 8);
        }
        fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / kWgThreads;
    const int lane = threadIdx.x % 32;
    if (wg == 2) {
        // ---- producer warp: lane 0 issues the TMA loads; rows without a map
        // (`rows` given) are copied by every lane, ROWS / 32 rows of 128 bytes
        // a chunk (binary) or a stage (the other modes); in the fp32 mode the
        // first warp of the producer warpgroup ----
        if constexpr (F32) {
            setmaxnreg_dec<kF32ProducerRegs>();
            if (threadIdx.x >= kConsumers + 32) return;
        }
        int jc = 0, j = 0;
        for (int item = item0; item < n_items; item += item_step) {
            const Slice ps = slice_of(item);
            const int r_end = ps.r_end, q0 = ps.q0, n_tiles = n_tiles_of(ps);
            for (int t = 0; t < n_tiles; ++t) {
                const int r0 = ps.r_begin + t * ROWS;
                for (int ks = 0; ks < n_k; ++ks, ++j) {
                    if (BIN && ks % kChunkSteps == 0) {
                        const int cs = jc % 2, c0 = (ks / kChunkSteps) * kChunk;
                        mbar_wait(&cempty[cs], ((jc / 2) & 1) ^ 1);
                        uint8_t* dst = chunks + cs * ROWS * kChunk;
                        if (rows != nullptr) {
                            copy_rows<ROWS>(dst, rows, row_bytes, r0, r_end, c0, false, lane);
                            mbar_arrive(&cfull[cs]);
                        } else if (lane == 0) {
                            mbar_expect_tx(&cfull[cs], ROWS * kChunk);
                            tma_load_2d(dst, &amap, &cfull[cs], c0, r0);
                        } else {
                            mbar_arrive(&cfull[cs]);
                        }
                        ++jc;
                    }
                    const int s = j % stages;
                    mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);
                    uint8_t* st = ring + s * STAGE;
                    const bool copy = !BIN && rows != nullptr;
                    if (copy) {   // wgmma reads them through the async proxy
                        copy_rows<ROWS>(st, rows, row_bytes, r0, r_end, ks * 128, true, lane);
                        fence_proxy_async();
                    }
                    if (lane == 0) {
                        mbar_expect_tx(&full[s], (copy ? 0 : A_BYTES) + QB);
                        if (!BIN && !copy) tma_load_2d(st, &amap, &full[s], ks * KS, r0);
                        if constexpr (F32) {   // the parts, [3][Q][pitch]: one load each
#pragma unroll
                            for (int p = 0; p < 3; ++p)
                                tma_load_3d(st + A_BYTES + p * N * 64, &qmap, &full[s], ks * KS, q0, p);
                        } else {
                            tma_load_2d(st + A_BYTES, &qmap, &full[s], ks * KS, q0);
                        }
                        if (MODE == kModeI8)   // the lo digits, rows Q .. 2Q - 1 of the map
                            tma_load_2d(st + A_BYTES + N * 128, &qmap, &full[s], ks * KS, Q + q0);
                    } else {
                        mbar_arrive(&full[s]);
                    }
                }
            }
        }
        return;
    }

    // ---- consumer warpgroups: rows r0 + 64 MT wg .. + 64 MT of each tile,
    // m64 tile mt at r0 + 64 (MT wg + mt) ----
    if constexpr (F32) setmaxnreg_inc<(65536 / THREADS / 8 * 8 * 3 - kF32ProducerRegs) / 2 / 8 * 8>();
    const int ctid = threadIdx.x;
    const int warp = (ctid % kWgThreads) / 32, t4 = lane % 4;
    const int rr = wg * 64 * MT + warp * 16 + lane / 4;   // rows rr + 64 mt and + 8
    const uint32_t ring_addr = smem_addr(ring);
    Acc acc[MT][W / 2];   // K9: the hi digit's dots in acc[.][0 .. NV), the lo digit's after
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[mt][i] = Acc(0);
    uint32_t pend[NP];
    int j = 0, jc = 0;

    auto release = [&](int jj) {   // this warp is done with stage jj
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[jj % stages]);
    };
    // binary: step ks (ring stage jj) unpacked into `a`, its products issued
    auto bin_issue = [&](uint32_t (&a)[MT][4][4], int ks, int jj) {
        if constexpr (BIN) {   // (the int8 modes' accumulator is s32)
            if (ks % kChunkSteps == 0) mbar_wait(&cfull[jc % 2], (jc / 2) & 1);
            uint2 va[MT], vb[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const uint8_t* pk = chunks + (jc % 2) * ROWS * kChunk + (rr + 64 * mt) * kChunk +
                                    (ks % kChunkSteps) * 8;
                va[mt] = *reinterpret_cast<const uint2*>(pk);
                vb[mt] = *reinterpret_cast<const uint2*>(pk + 8 * kChunk);
            }
            if (ks % kChunkSteps == kChunkSteps - 1 || ks == n_k - 1) {   // the chunk is read
                __syncwarp();
                if (lane == 0) mbar_arrive(&cempty[jc % 2]);
                ++jc;
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const uint32_t wa[2] = {va[mt].x, va[mt].y}, wb[2] = {vb[mt].x, vb[mt].y};
#pragma unroll
                for (int m = 0; m < 2; ++m) {   // byte t4 of word m: k16 chunks 2m and 2m + 1
                    const uint32_t xa = (wa[m] >> (8 * t4)) & 0xffu, xb = (wb[m] >> (8 * t4)) & 0xffu;
                    a[mt][2 * m][0] = sign_pairs(xa, 0);
                    a[mt][2 * m][1] = sign_pairs(xb, 0);
                    a[mt][2 * m][2] = sign_pairs(xa, 1);
                    a[mt][2 * m][3] = sign_pairs(xb, 1);
                    a[mt][2 * m + 1][0] = sign_pairs(xa, 2);
                    a[mt][2 * m + 1][1] = sign_pairs(xb, 2);
                    a[mt][2 * m + 1][2] = sign_pairs(xa, 3);
                    a[mt][2 * m + 1][3] = sign_pairs(xb, 3);
                }
            }
            const int s = jj % stages;
            mbar_wait(&full[s], (jj / stages) & 1);
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                    WgmmaRSK<N>::run(acc[mt], a[mt][c],
                                     gmma_desc(ring_addr + s * STAGE + c * 32, 16, 1024, 1),
                                     (ks > 0 || c > 0) ? 1 : 0);
            wgmma_commit();
        }
    };
    auto fence_frag = [](uint32_t (&a)[MT][4][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int c = 0; c < 4; ++c) fence_operand(a[mt][c]);
    };
    // a passing score takes one of its query's slots; one atomic per warp
    // and query column (the 8 lanes of equal lane % 4 share the columns)
    // (returns whether the slots were full: the score waits for a round)
    auto offer = [&](bool pass, int c, float v, int row, bool& active) {
        const unsigned m = __ballot_sync(FULL, pass);
        if (m == 0u) return false;
        const unsigned grp = m & (0x11111111u << t4);
        const int leader = grp ? __ffs(grp) - 1 : lane;
        int base = 0;
        if (pass && lane == leader) base = atomicAdd(&cnt[c], __popc(grp));
        base = __shfl_sync(FULL, base, leader);
        if (!pass) return false;
        active = true;
        const int pos = base + __popc(grp & ((1u << lane) - 1u));
        if (pos >= NC) return true;
        cand_s[pos * N + c] = v;
        cand_i[pos * N + c] = row;
        return false;
    };

    RV_PROF(long long p_mma = 0, p_gate = 0, p_flush = 0, p_early = 0, p_wait = 0;
            int p_rounds = 0;)
    for (int item = item0; item < n_items; item += item_step) {
        if (item != item0) {   // the IVF scan's next item: the last one's lists are written out
            sl = slice_of(item);
            named_bar_sync(1, kConsumers);
            init_lists(sl, ctid, kConsumers);
            named_bar_sync(1, kConsumers);
        }
        const int r_end = sl.r_end, nq = sl.nq, n_tiles = n_tiles_of(sl);
        for (int t = 0; t < n_tiles; ++t) {
            RV_PROF(const long long c0 = clock64();)
            const int r0 = sl.r_begin + t * ROWS;
            int row_a[MT], row_b[MT];
            bool ok_a[MT], ok_b[MT];
            float rs_a[MT], rs_b[MT];   // K12's row scales
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                row_a[mt] = r0 + rr + 64 * mt;
                row_b[mt] = row_a[mt] + 8;
                ok_a[mt] = row_a[mt] < r_end && (mask == nullptr || mask[row_a[mt]] != 0);
                ok_b[mt] = row_b[mt] < r_end && (mask == nullptr || mask[row_b[mt]] != 0);
                if (MODE == kModeI8Rows) {   // read as the mask is: the tile's rows of this thread
                    rs_a[mt] = row_a[mt] < r_end ? row_scale[row_a[mt]] : 0.f;
                    rs_b[mt] = row_b[mt] < r_end ? row_scale[row_b[mt]] : 0.f;
                }
            }
            if constexpr (BIN) {
                uint32_t fa[MT][4][4], fb[MT][4][4];
                // two fragment buffers at N = 128: a step's unpack beside the last step's products
                if constexpr (MT == 1 && N <= 128) {
                    for (int ks = 0; ks < n_k; ks += 2) {
                        bin_issue(fa, ks, j + ks);
                        if (ks > 0) {
                            wgmma_wait<1>();
                            fence_frag(fb);
                            release(j + ks - 1);
                        }
                        if (ks + 1 < n_k) {
                            bin_issue(fb, ks + 1, j + ks + 1);
                            wgmma_wait<1>();
                            fence_frag(fa);
                            release(j + ks);
                        }
                    }
                } else {   // one buffer: two m64 tiles (N <= 64) or N = 256 fill the registers
                    for (int ks = 0; ks < n_k; ++ks) {
                        if (ks > 0) {
                            wgmma_wait<0>();
                            fence_frag(fa);
                            release(j + ks - 1);
                        }
                        bin_issue(fa, ks, j + ks);
                    }
                }
                wgmma_wait<0>();
                fence_frag(fa);
                fence_frag(fb);
                j += n_k;
                release(j - 1);
            } else if constexpr (F32) {
                // a stage: 32 dims, two k16 steps; its twelve products an m64
                // tile in `step`, added to the score on the CUDA cores once they
                // are done. (Splitting the next stage into a second fragment
                // buffer while a stage's products run spilled at N = 128 and was
                // slower: scripts/topk_scan_probe.py, PERF.md section 6.)
                float step[MT][W / 2];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int i = 0; i < W / 2; ++i) step[mt][i] = 0.f;
                for (int ks = 0; ks < n_k; ++ks, ++j) {
                    const int s = j % stages;
                    const uint32_t qp = ring_addr + s * STAGE + A_BYTES;   // the query's parts
                    mbar_wait(&full[s], (j / stages) & 1);
                    uint32_t fr[MT][2][3][4];   // [m64 tile][k16 step][part][register]
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int kk = 0; kk < 2; ++kk)
                            split_frag(ring + s * STAGE, rr + 64 * mt, 16 * kk + 2 * t4, fr[mt][kk]);
                    // the fragments and the step accumulator are written before
                    // wgmma.fence, as PTX requires of an asynchronous product's
                    // registers (fence_operand keeps the compiler from sinking
                    // the split past it)
                    fence_step(step, fr);
                    wgmma_fence();
#pragma unroll
                    for (int t = 0; t < kSplitTerms; ++t)
#pragma unroll
                        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt)
                                WgmmaRSK<N>::run(
                                    step[mt], fr[mt][kk][split_part(t, 0)],
                                    gmma_desc(qp + split_part(t, 1) * N * 64 + kk * 32, 16, 512, 2),
                                    t > 0 || kk > 0);
                    wgmma_commit();
                    wgmma_wait<0>();
                    fence_step(step, fr);
                    release(j);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int i = 0; i < W / 2; ++i)
                            acc[mt][i] = ks > 0 ? __fadd_rn(acc[mt][i], step[mt][i]) : step[mt][i];
                }
            } else {
                for (int ks = 0; ks < n_k; ++ks, ++j) {
                    const int s = j % stages;
                    const uint32_t st = ring_addr + s * STAGE;
                    mbar_wait(&full[s], (j / stages) & 1);
                    wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)   // k16 (bf16) or k32 (s8) steps: 32 bytes each
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) {
                            const uint64_t da =
                                gmma_desc(st + (wg * MT + mt) * 64 * 128 + kk * 32, 16, 1024, 1);
                            const uint64_t db = gmma_desc(st + A_BYTES + kk * 32, 16, 1024, 1);
                            if constexpr (I8)
                                WgmmaSS8<W>::run(acc[mt], da, db, (ks > 0 || kk > 0) ? 1 : 0);
                            else
                                WgmmaSS<N>::run(acc[mt], da, db, (ks > 0 || kk > 0) ? 1 : 0);
                        }
                    wgmma_commit();
                    wgmma_wait<1>();   // step j - 1's products are done: release its stage
                    if (ks > 0) release(j - 1);
                }
                wgmma_wait<0>();
                release(j - 1);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_operand(acc[mt]);

            // ---- the int8 score steps, in registers: the f32 score replaces the
            // s32 dot of the query's (hi) column; acc[mt][r + NV] is column + N ----
            if constexpr (MODE == kModeI8) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int r = 0; r < NV; ++r) {
                        float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][r]), 254.f),
                                            __int2float_rn(acc[mt][r + NV]));
                        if constexpr (IVF)   // the column's scale, before the gate (as the reference)
                            v = __fmul_rn(v, qsc[8 * (r / 4) + 2 * t4 + (r & 1)]);
                        acc[mt][r] = __float_as_int(v);
                    }
            } else if constexpr (MODE == kModeI8Rows) {
#pragma unroll
                for (int i = 0; i < N / 8; ++i) {
                    const float2 qs = *reinterpret_cast<const float2*>(qsc + 8 * i + 2 * t4);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[mt][4 * i + e] = __float_as_int(__fmul_rn(
                                __fmul_rn(__int2float_rn(acc[mt][4 * i + e]), (e & 1) ? qs.y : qs.x),
                                e < 2 ? rs_a[mt] : rs_b[mt]));
                }
            }
            RV_PROF(const long long c1 = clock64(); p_mma += c1 - c0;)

            // ---- IVF: an item's lists start empty, so on its first tile every
            // score would pass the gate. Each column's k-th entry starts at a
            // lower bound of the item's k-th best score instead: the k-th
            // largest of the tile's 32 row groups' maxima (k <= 32; a group:
            // one warp's 8 rows of one m64 tile and half at MT = 2, 4 rows of
            // its one at MT = 1). A score equal to it passes ----
            if constexpr (IVF) {
                if (t == 0 && k <= 32) {
                    float* gmax = cand_s;   // [32][N]: the candidate slots are empty
                    const int w8 = ctid / 32;
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                        for (int i = 0; i < N / 8; ++i)
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const int col = 8 * i + 2 * t4 + (e & 1);
                                float v = (e < 2 ? ok_a[mt] : ok_b[mt]) && col < nq
                                              ? score_of(acc[mt][4 * i + e]) : -CUDART_INF_F;
                                v = fmaxf(v, __shfl_xor_sync(FULL, v, 4));
                                v = fmaxf(v, __shfl_xor_sync(FULL, v, 8));
                                if (MT == 2) v = fmaxf(v, __shfl_xor_sync(FULL, v, 16));
                                const int grp = (w8 * 2 + (MT == 2 ? mt : lane >> 4)) * 2 + (e >> 1);
                                if ((lane & (MT == 2 ? 28 : 12)) == 0) gmax[grp * N + col] = v;
                            }
                    named_bar_sync(1, kConsumers);
                    for (int c = w8; c < nq; c += 8) {   // warp w8's columns: a group a lane
                        const float v = gmax[lane * N + c];
                        int rank = 0;
                        for (int o = 0; o < 32; ++o) {
                            const float u = __shfl_sync(FULL, v, o);
                            rank += (u > v || (u == v && o < lane)) ? 1 : 0;
                        }
                        if (rank == k - 1 && v != -CUDART_INF_F) {
                            kth_s[c] = v;
                            kth_i[c] = 0x7fffffff;
                        }
                    }
                    named_bar_sync(1, kConsumers);
                }
            }

            // ---- gate: acc[mt][4 i + e] is row (e < 2 ? row_a : row_b)[mt],
            // query column 8 i + 2 t4 + (e & 1); its pending bit mt NV + 4 i + e ----
            bool active = false;
#pragma unroll
            for (int w = 0; w < NP; ++w) pend[w] = 0u;
#pragma unroll
            for (int i = 0; i < N / 8; ++i) {
                const int col = 8 * i + 2 * t4;
                const float2 ts = *reinterpret_cast<const float2*>(kth_s + col);
                const int2 ti = *reinterpret_cast<const int2*>(kth_i + col);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    bool p[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        p[e] = (e < 2 ? ok_a[mt] : ok_b[mt]) && col + (e & 1) < nq &&
                               better(score_of(acc[mt][4 * i + e]), e < 2 ? row_a[mt] : row_b[mt],
                                      (e & 1) ? ts.y : ts.x, (e & 1) ? ti.y : ti.x);
                    if (__ballot_sync(FULL, p[0] || p[1] || p[2] || p[3]) == 0u) continue;
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int idx = mt * NV + 4 * i + e;
                        if (offer(p[e], col + (e & 1), score_of(acc[mt][4 * i + e]),
                                  e < 2 ? row_a[mt] : row_b[mt], active))
                            pend[idx / 32] |= 1u << (idx % 32);
                    }
                }
            }
            RV_PROF(const long long c2 = clock64(); p_gate += c2 - c1;)
            // ---- select rounds: each query's thread inserts its candidates;
            // then the scores that found the slots full are gated again ----
            for (;;) {
                RV_PROF(const long long b0 = clock64();)
                const bool any = named_bar_or(1, kConsumers, active);
                RV_PROF(p_wait += clock64() - b0;)
                if (!any) break;
                RV_PROF(++p_rounds;)
                // a query whose candidates need few shifts (nc k <= kSerial):
                // its own thread inserts them from the list's end; the others,
                // warp q % 8 merges in one pass
                const int q = ctid;
                const int nc = q < nq ? min(cnt[q], NC) : 0;
                if (nc > 0 && nc * k <= kSerial) {
                    float* S = st_s + q * kp;
                    int* I = st_i + q * kp;
                    for (int e = 0; e < nc; ++e) {
                        const float sv = cand_s[e * N + q];
                        const int iv = cand_i[e * N + q];
                        if (!better(sv, iv, S[k - 1], I[k - 1])) continue;
                        int pp = k - 1;
                        while (pp > 0 && better(sv, iv, S[pp - 1], I[pp - 1])) {
                            S[pp] = S[pp - 1];
                            I[pp] = I[pp - 1];
                            --pp;
                        }
                        S[pp] = sv;
                        I[pp] = iv;
                    }
                    kth_s[q] = S[k - 1];
                    kth_i[q] = I[k - 1];
                    cnt[q] = 0;
                }
                {
                    const int w8 = ctid / 32, qq = w8 + 8 * lane;   // lane's query (N / 8 <= 32)
                    const int nh = lane < N / 8 && qq < nq ? min(cnt[qq], NC) : 0;
                    for (unsigned h = __ballot_sync(FULL, nh * k > kSerial); h != 0u; h &= h - 1u) {
                        const int src = __ffs(h) - 1, qh = w8 + 8 * src;
                        float* S = st_s + qh * kp;
                        int* I = st_i + qh * kp;
                        warp_merge(S, I, k, cand_s + qh, cand_i + qh, N, __shfl_sync(FULL, nh, src),
                                   xs + w8 * TOPK_KMAX, xi + w8 * TOPK_KMAX, lane);
                        if (lane == src) {
                            kth_s[qh] = S[k - 1];
                            kth_i[qh] = I[k - 1];
                            cnt[qh] = 0;
                        }
                    }
                }
                RV_PROF(const long long b1 = clock64();)
                named_bar_sync(1, kConsumers);
                RV_PROF(p_wait += clock64() - b1;)
                active = false;
                bool any_pend = false;
#pragma unroll
                for (int w = 0; w < NP; ++w) any_pend = any_pend || pend[w] != 0u;
                if (!__any_sync(FULL, any_pend)) continue;
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int i = 0; i < N / 8; ++i) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int idx = mt * NV + 4 * i + e, c = 8 * i + 2 * t4 + (e & 1);
                        const int row = e < 2 ? row_a[mt] : row_b[mt];
                        const float v = score_of(acc[mt][4 * i + e]);
                        const uint32_t bit = 1u << (idx % 32);
                        const bool was = (pend[idx / 32] & bit) != 0u;
                        pend[idx / 32] &= ~bit;
                        if (offer(was && better(v, row, kth_s[c], kth_i[c]), c, v, row, active))
                            pend[idx / 32] |= bit;
                    }
                }
            }
            RV_PROF(p_flush += clock64() - c2; if (t < 4) p_early += clock64() - c1;)
        }
        named_bar_sync(1, kConsumers);
        RV_PROF(if (ctid == 0 && blockIdx.x == 0 && blockIdx.y == 0) printf(
            "scan_wg Q=%d N=%d mode=%d masked=%d k=%d tiles=%d cycles: products %lld gate %lld "
            "select %lld (barrier waits %lld; gate and select of tiles 0-3: %lld); rounds %d\n", Q,
            N, MODE, (int)(mask != nullptr), k,
            n_tiles, p_mma, p_gate, p_flush, p_wait, p_early, p_rounds);)
        for (int idx = ctid; idx < nq * k; idx += kConsumers) {
            const int q = idx / k, jj = idx % k;
            const size_t o = ((size_t)sl.split * Q + sl.q0 + q) * k + jj;
            part_s[o] = st_s[q * kp + jj];
            part_i[o] = st_i[q * kp + jj];
        }
    }
}

// a 2-D map over [rows][cols] (cols contiguous), box [box_rows][box_cols];
// out-of-bounds elements read zero
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr,
                     int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * esize};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// launches one instantiation; *n_splits comes in as the caller's cap and
// goes out as the splits launched: at most one wave (occupancy x SMs). The
// IVF scan's cap is its work table's length, and its CTAs walk the table
template <int N, int MODE, bool IVF>
static int launch_n(const CUtensorMap& am, const CUtensorMap& qm, const unsigned char* rows,
                    int row_bytes, const unsigned char* mask, const float* q_scale,
                    const float* row_scale, int Q, int n_valid, int k, int n_k, const Plan& p,
                    int* n_splits, const int* work, const int* n_work, float* part_s,
                    int* part_i, cudaStream_t stream) {
    auto kernel = topk_scan_wg_kernel<N, MODE, IVF>;
    const size_t smem = smem_bytes(N, k, MODE, p.stages, IVF);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 1, occ = 1;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads_of(MODE),
                                                             smem)) !=
            cudaSuccess)
        return (int)err;
    *n_splits = max(1, min(*n_splits, ceil_div(max(occ, 1) * sms, p.q_blocks)));
    constexpr int ROWS = kRows * m_tiles(width(N, MODE));
    int rows_per_split = ceil_div(n_valid, *n_splits);
    rows_per_split = ceil_div(rows_per_split, ROWS) * ROWS;
    kernel<<<dim3(*n_splits, p.q_blocks), threads_of(MODE), smem, stream>>>(
        am, qm, rows, row_bytes, mask, q_scale, row_scale, Q, n_valid, k, n_k, rows_per_split,
        p.stages, work, n_work, part_s, part_i);
    return (int)cudaGetLastError();
}

static inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// MODE's rows db [n_valid.., D] against its queries q:
//   * kModeBf16: bf16 rows, q [Q, D8] bf16 (D8: D rounded up to 8, zero
//     past D);
//   * kModeF32: fp32 rows, q the query's three bf16 parts [3, Q, D8] (the
//     split pass's layout, zero past D);
//   * kModeBin: packed rows (W = D bytes a row), q the query permuted to the
//     k loop's order, [Q, 8 W16] bf16 (W16: W rounded up to 16);
//   * kModeI8: int8 rows, q the digits [2, Q, D16] int8 (D16: D rounded up
//     to 16, zero past D); kModeI8Rows: int8 rows with row_scale [n_valid..],
//     q [Q, D16] int8 with q_scale [Q].
// Rows that TMA cannot take (a row stride that is not a multiple of 16
// bytes, or an unaligned base) are copied by the producer warp.
// IVF: the work table `work` of *n_work slices (at most *n_splits) in query
// blocks of n_block over the Q columns of q; n_valid is the matrix's rows.
template <int MODE, bool IVF = false>
static int launch_wg(const void* db, const void* q, const unsigned char* mask,
                     const float* q_scale, const float* row_scale, int D, int Q, int n_valid,
                     int k, int* n_splits, float* part_s, int* part_i, cudaStream_t stream,
                     const int* work = nullptr, const int* n_work = nullptr, int n_block = 0) {
    constexpr bool I8 = MODE == kModeI8 || MODE == kModeI8Rows;
    constexpr int esize = MODE == kModeF32 ? 4 : MODE == kModeBf16 ? 2 : 1;   // row bytes a dim
    if (IVF && (n_block < 8 || n_block > n_cap(MODE) || (n_block & (n_block - 1)) != 0 ||
                smem_bytes(n_block, k, MODE, 2, true) > kSmemMax))
        return kUnsupported;
    const Plan p = IVF ? Plan{n_block, 1, stages_at(n_block, k, MODE, true)} : plan(Q, k, MODE);
    const int rows = kRows * m_tiles(width(p.n, MODE));   // the tile's rows: the rows' TMA box
    const int w16 = ceil_div(D, 16) * 16, d8 = ceil_div(D, 8) * 8;
    const int qcols = MODE == kModeBin ? 8 * w16 : I8 ? w16 : d8;
    const int qrows = MODE == kModeI8 ? 2 * Q : Q;
    const int n_k = ceil_div(qcols, k_dims(MODE));
    CUtensorMap am, qm;
    const unsigned char* copy = nullptr;
    const bool qmap_ok =
        MODE == kModeF32 ? make_map_parts(&qm, q, qcols, Q, p.n)
        : I8 ? make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, qcols, qrows, 128, p.n,
                        CU_TENSOR_MAP_SWIZZLE_128B)
             : make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, qcols, qrows, 64, p.n,
                        CU_TENSOR_MAP_SWIZZLE_128B);
    if (!aligned16(q) || !qmap_ok) return kMapError;
    if ((D * esize) % 16 != 0 || !aligned16(db)) {
        copy = static_cast<const unsigned char*>(db);   // the producer copies the rows
        am = qm;                                        // unused
    } else if (MODE == kModeBin ? !make_map(&am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, db, D, n_valid,
                                            kChunk, rows, CU_TENSOR_MAP_SWIZZLE_NONE)
               : I8 ? !make_map(&am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, db, D, n_valid, 128, rows,
                                CU_TENSOR_MAP_SWIZZLE_128B)
               : MODE == kModeF32
                    ? !make_map(&am, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, db, D, n_valid, 32, rows,
                                CU_TENSOR_MAP_SWIZZLE_128B)
                    : !make_map(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, db, D, n_valid, 64,
                                rows, CU_TENSOR_MAP_SWIZZLE_128B)) {
        return kMapError;
    }
    switch (p.n) {
#define RV_WG_CASE(NN)                                                                        \
    case NN:                                                                                  \
        if constexpr (NN <= n_cap(MODE))                                                      \
            return launch_n<NN, MODE, IVF>(am, qm, copy, D * esize, mask, q_scale, row_scale, \
                                           Q, n_valid, k, n_k, p, n_splits, work, n_work,     \
                                           part_s, part_i, stream);                           \
        break;
        RV_WG_CASE(8) RV_WG_CASE(16) RV_WG_CASE(32) RV_WG_CASE(64) RV_WG_CASE(128)
#undef RV_WG_CASE
    }
    return kUnsupported;
}

}  // namespace scan_wg

// K11's scan (csrc/ivf_scan.cu, which declares it): MODE's rows mat [M, D]
// (kBFloat16, kFloat32 or kInt8) against the query operand of the P
// (query, probe) pairs in cluster-major order (bf16 [P, D8]; fp32 its three
// bf16 parts [3, P, D8]; int8 the digits [2, P, D16] with the pairs' scales
// q_scale [P]), over the *n_work slices of `work` (at most n_work_max) in
// query blocks of n; writes the slices' sorted lists to part_s / part_i
// [splits][P][k] (slice (r_begin, r_end, q0, nq, split): rows [q0 + j,
// split]).
int launch_ivf_scan_wg(int mode, const void* mat, const void* q, const unsigned char* mask,
                       const float* q_scale, const int* work, const int* n_work,
                       int n_work_max, int D, int P, int M, int k, int n, float* part_s,
                       int* part_i, cudaStream_t stream) {
    using namespace scan_wg;
    int ctas = n_work_max;
    if (mode == kBFloat16)
        return launch_wg<kModeBf16, true>(mat, q, mask, nullptr, nullptr, D, P, M, k, &ctas,
                                          part_s, part_i, stream, work, n_work, n);
    if (mode == kFloat32)
        return launch_wg<kModeF32, true>(mat, q, mask, nullptr, nullptr, D, P, M, k, &ctas,
                                         part_s, part_i, stream, work, n_work, n);
    if (mode == kInt8)
        return launch_wg<kModeI8, true>(mat, q, mask, q_scale, nullptr, D, P, M, k, &ctas,
                                        part_s, part_i, stream, work, n_work, n);
    return kUnsupported;
}

// One warp per query: k-way merge of the n_splits sorted partial lists.
__global__ void topk_merge_kernel(const float* __restrict__ part_s,
                                  const int* __restrict__ part_i, int Q, int k,
                                  int n_splits, float* __restrict__ out_s,
                                  int* __restrict__ out_i) {
    extern __shared__ int heads[];   // [n_splits]
    const int qi = blockIdx.x;
    const int lane = threadIdx.x;
    for (int sp = lane; sp < n_splits; sp += 32) heads[sp] = 0;
    __syncwarp();
    for (int r = 0; r < k; ++r) {
        float bs = -CUDART_INF_F;
        int bi = 0x7fffffff;
        int bsp = -1;
        for (int sp = lane; sp < n_splits; sp += 32) {
            const int hd = heads[sp];
            if (hd >= k) continue;
            const size_t o = ((size_t)sp * Q + qi) * k + hd;
            const float s = part_s[o];
            const int i = part_i[o];
            if (i < 0) continue;   // an empty (-inf) slot ends that list
            if (bsp < 0 || better(s, i, bs, bi)) { bs = s; bi = i; bsp = sp; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float os = __shfl_xor_sync(0xffffffffu, bs, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            const int osp = __shfl_xor_sync(0xffffffffu, bsp, off);
            const bool take = osp >= 0 && (bsp < 0 || better(os, oi, bs, bi));
            if (take) { bs = os; bi = oi; bsp = osp; }
        }
        if (lane == 0) {
            out_s[(size_t)qi * k + r] = (bsp < 0) ? -CUDART_INF_F : bs;
            out_i[(size_t)qi * k + r] = (bsp < 0) ? -1 : bi;
        }
        if (bsp >= 0 && lane == (bsp % 32)) heads[bsp] += 1;
        __syncwarp();
    }
}

static int launch_merge(const float* part_s, const int* part_i, int Q, int k,
                        int n_splits, void* out_s, void* out_i, cudaStream_t stream) {
    topk_merge_kernel<<<Q, 32, n_splits * sizeof(int), stream>>>(
        part_s, part_i, Q, k, n_splits, static_cast<float*>(out_s),
        static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

// mode: kFloat32 (q the query's three bf16 parts [3, Q, D8]), kBFloat16
// (q [Q, D8] bf16), kInt8 (q the digits [2, Q, D16] int8), kBinaryPacked
// (D = W packed bytes per row, q [Q, 8 W16] bf16). mask: [n_valid] uint8 or
// null.
static int launch_topk(const void* db, const void* q, const void* mask_v, int D,
                       int Q, int n_valid, int k, int n_splits, void* part_s_v,
                       void* part_i_v, void* out_s, void* out_i, int mode,
                       cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || n_splits < 1 || D < 1) return kUnsupported;
    const auto* mask = static_cast<const unsigned char*>(mask_v);
    auto* part_s = static_cast<float*>(part_s_v);
    auto* part_i = static_cast<int*>(part_i_v);
    int status;
    if (n_valid <= 0)   // no row scores: every slot (-inf, -1)
        return launch_merge(part_s, part_i, Q, k, 0, out_s, out_i, stream);
    if (mode == kBFloat16)
        status = scan_wg::launch_wg<scan_wg::kModeBf16>(db, q, mask, nullptr, nullptr, D, Q,
                                                        n_valid, k, &n_splits, part_s, part_i,
                                                        stream);
    else if (mode == kFloat32)
        status = scan_wg::launch_wg<scan_wg::kModeF32>(db, q, mask, nullptr, nullptr, D, Q,
                                                       n_valid, k, &n_splits, part_s, part_i,
                                                       stream);
    else if (mode == kInt8)
        status = scan_wg::launch_wg<scan_wg::kModeI8>(db, q, mask, nullptr, nullptr, D, Q, n_valid,
                                                      k, &n_splits, part_s, part_i, stream);
    else if (mode == kBinaryPacked && D <= BIN_WMAX)
        status = scan_wg::launch_wg<scan_wg::kModeBin>(db, q, mask, nullptr, nullptr, D, Q,
                                                       n_valid, k, &n_splits, part_s, part_i,
                                                       stream);
    else
        return kUnsupported;
    if (status != 0) return status;
    return launch_merge(part_s, part_i, Q, k, n_splits, out_s, out_i, stream);
}

// K12's stage 1: int8 rows [n_valid.., D] with per-row f32 scales against
// one int8 digit per query [Q, D16] (zero past D) with per-query f32 scales.
static int launch_topk_int8_rows(const void* db, const void* q, const void* q_scale,
                                 const void* row_scale, int D, int Q, int n_valid, int k,
                                 int n_splits, void* part_s_v, void* part_i_v, void* out_s,
                                 void* out_i, cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || n_splits < 1 || D < 1) return kUnsupported;
    auto* part_s = static_cast<float*>(part_s_v);
    auto* part_i = static_cast<int*>(part_i_v);
    if (n_valid <= 0)   // no row scores: every slot (-inf, -1)
        return launch_merge(part_s, part_i, Q, k, 0, out_s, out_i, stream);
    const int status = scan_wg::launch_wg<scan_wg::kModeI8Rows>(
        db, q, nullptr, static_cast<const float*>(q_scale), static_cast<const float*>(row_scale),
        D, Q, n_valid, k, &n_splits, part_s, part_i, stream);
    if (status != 0) return status;
    return launch_merge(part_s, part_i, Q, k, n_splits, out_s, out_i, stream);
}

}  // namespace rv

extern "C" int rv_topk_stream(const void* db, const void* q, const void* mask,
                              int D, int Q, int n_valid, int k, int n_splits,
                              void* part_s, void* part_i, void* out_s, void* out_i,
                              int mode, void* stream) {
    return rv::launch_topk(db, q, mask, D, Q, n_valid, k, n_splits, part_s, part_i,
                           out_s, out_i, mode, static_cast<cudaStream_t>(stream));
}

extern "C" int rv_topk_int8_rows(const void* db, const void* q, const void* q_scale,
                                 const void* row_scale, int D, int Q, int n_valid, int k,
                                 int n_splits, void* part_s, void* part_i, void* out_s,
                                 void* out_i, void* stream) {
    return rv::launch_topk_int8_rows(db, q, q_scale, row_scale, D, Q, n_valid, k, n_splits,
                                     part_s, part_i, out_s, out_i,
                                     static_cast<cudaStream_t>(stream));
}
