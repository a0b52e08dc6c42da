// Exact dot-product top-k with a fused per-query k-select, in four modes.
//
// Replaces: reverso_tpu/ops/topk.py::_topk_stream_kernel in
//   * its plain mode (entry cosine_topk_pallas): bf16/fp32 rows (K1);
//   * its masked mode (cosine_topk_pallas(row_mask=)): K1 with a per-row
//     filter (K2);
//   * its int8 mode (entry cosine_topk_int8_exact): int8 rows, each query
//     split into two int8 digits, exact s32 dots (K9);
//   * its binary mode (entry ops/binary.py::binary_topk_pallas): planar
//     sign-packed uint8 rows unpacked to +-1 and scored against the bf16
//     query (K10);
// and reverso_tpu/ops/topk_int8.py::_topk_int8_kernel (entry
// cosine_topk_int8): int8 rows with per-row f32 scales against one int8
// digit per query with a per-query scale, the candidate stage of the
// two-stage search (K12, `rv_topk_int8_rows`).
// Every mode but K12 takes the optional [N] uint8 row mask.
//
// What bounds it on the H100 (published SXM peaks, 700 W), at 1M x 1024,
// Q = 256: bf16 reads 2.05 GB (0.61 ms at 3.35 TB/s) for 524 GFLOP (0.53 ms
// at 989 TFLOP/s); int8 reads 1.02 GB (0.31 ms) for 1.05 T int8 operations
// in two digits (0.53 ms at 1979 TOP/s); K12 reads 1.02 GB of rows and
// 4 MB of row scales (0.31 ms) for 0.52 T int8 operations in one digit
// (0.26 ms), so bytes; binary reads 128 MB (0.04 ms) for
// 524 GFLOP against the unpacked +-1 rows (0.53 ms). The database is read
// once per 64-query tile, and the per-tile k-select is serial work on the
// CUDA cores.
//
// What the design does about it:
//   * pass 1: each CTA holds one tile of QT queries and streams its own
//     contiguous slice of database rows in RT-row tiles; CTAs of one row
//     slice are launched next to each other, so their reads share L2. The
//     [QT, RT] score tile comes from warp-level tensor-core products (bf16
//     WMMA with fp32 accumulate; s8 WMMA with s32 accumulate for the two
//     int8 digits) or, for fp32 stores, a register-tiled FMA product, and
//     lands in shared memory; then each warp updates the sorted top-k
//     lists of its queries, inserting by (-score, idx). Rows arrive in
//     ascending order, so a candidate equal to the current k-th score
//     loses the tie and is skipped. Rows at or past n_valid are never
//     scored; masked rows (their mask slice is staged in shared memory
//     once per row tile) never enter the lists. The CTA writes
//     [n_splits, Q, k] partials;
//   * int8: the two exact s32 dots combine as f32(hi) * 254 + f32(lo) with
//     two roundings (__fmul_rn, __fadd_rn: nvcc would contract a*b+c into
//     one FMA, one rounding, and the scores would differ from the
//     reference in the last bit). The per-query scale is applied outside;
//   * K12: the exact s32 dot on the same s8 tensor-core path, then
//     (f32(dot) * q_scale) * row_scale with __fmul_rn, the reference's two
//     roundings in its order (on the TPU the dot ran bf16 on upcast int8,
//     exact for d <= 1040; the s32 dot is exact for any d);
//   * binary: the packed [RT, W] row tile is staged once, and each d step
//     unpacks its [RT, 64] slice to +-1 bf16 (plane j of dim t = j*W + b
//     is bit j of byte b, so no interleave) for the bf16 WMMA path;
//   * pass 2: one warp per query merges the n_splits sorted partials by
//     (-score, idx): deterministic, ties to the lower row;
//   * the [Q, N] score matrix never exists; slots still at -inf return -1.
// k is capped at TOPK_KMAX = 128 (the reference kernel's cap): the sorted
// state of a 64-query tile is then 64 KB of shared memory.
#include <mma.h>

#include "topk_select.cuh"

namespace rv {

constexpr int TOPK_THREADS = 256;
constexpr int TOPK_QT = 64;     // queries per CTA
constexpr int TOPK_RT = 64;     // database rows per tile
constexpr int TOPK_BK = 32;     // reduction step over d (FMA kernel)
constexpr int BIN_WMAX = 1024;  // packed plane width cap (d <= 8192)

// k-select over one [QT, RT] score tile `sc` (row stride lds): warp w owns
// queries w*8 .. w*8+7 of the tile and inserts every row that beats the
// query's current k-th score. Rows arrive in ascending order. `msk` (the
// tile's mask slice in shared memory, or nullptr) drops filtered rows.
__device__ __forceinline__ void kselect_tile(const float* sc, int lds,
                                             float* st_s, int* st_i, int k,
                                             int nr, int r0, int q0, int Q,
                                             int warp, int lane,
                                             const unsigned char* msk) {
    for (int qq = warp * (TOPK_QT / 8); qq < (warp + 1) * (TOPK_QT / 8); ++qq) {
        if (q0 + qq >= Q) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = lane + 32 * half;
            const bool real = j < nr && (msk == nullptr || msk[j] != 0);
            warp_insert_batch(st_s + qq * k, st_i + qq * k, k, sc[qq * lds + j],
                              real, r0 + 32 * half, lane);
        }
    }
}

__device__ __forceinline__ void init_state(float* st_s, int* st_i, int k, int tid) {
    for (int idx = tid; idx < TOPK_QT * k; idx += TOPK_THREADS) {
        st_s[idx] = -CUDART_INF_F;
        st_i[idx] = -1;
    }
}

// the tile's mask slice -> shared memory (rows past nr read as masked)
__device__ __forceinline__ void load_mask(unsigned char* msk,
                                          const unsigned char* mask, int r0,
                                          int nr, int tid) {
    if (mask != nullptr && tid < TOPK_RT) msk[tid] = (tid < nr) ? mask[r0 + tid] : 0;
}

__device__ __forceinline__ void write_partials(const float* st_s, const int* st_i,
                                               int k, int split, int q0, int Q,
                                               int tid, float* part_s,
                                               int* part_i) {
    const int nq = min(TOPK_QT, Q - q0);
    for (int idx = tid; idx < nq * k; idx += TOPK_THREADS) {
        const int qq = idx / k, j = idx % k;
        const size_t o = ((size_t)split * Q + q0 + qq) * k + j;
        part_s[o] = st_s[idx];
        part_i[o] = st_i[idx];
    }
}

template <typename T>
__global__ void __launch_bounds__(TOPK_THREADS)
topk_scan_kernel(const T* __restrict__ db, const T* __restrict__ q,
                 const unsigned char* __restrict__ mask, int D, int Q,
                 int n_valid, int k, int rows_per_split,
                 float* __restrict__ part_s, int* __restrict__ part_i) {
    extern __shared__ float smem[];
    float* st_s = smem;                                       // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);   // [QT][k]
    float* qs = reinterpret_cast<float*>(st_i + TOPK_QT * k); // [QT][BK+1]
    float* ds = qs + TOPK_QT * (TOPK_BK + 1);                 // [RT][BK+1]
    float* sc = ds + TOPK_RT * (TOPK_BK + 1);                 // [QT][RT+1]
    unsigned char* msk = reinterpret_cast<unsigned char*>(sc + TOPK_QT * (TOPK_RT + 1));

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * TOPK_QT;
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n_valid, r_begin + rows_per_split);
    const int tq = tid / 16, tr = tid % 16;   // 4 queries x 4 rows per thread

    init_state(st_s, st_i, k, tid);

    for (int r0 = r_begin; r0 < r_end; r0 += TOPK_RT) {
        const int nr = min(TOPK_RT, r_end - r0);
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
        for (int k0 = 0; k0 < D; k0 += TOPK_BK) {
            __syncthreads();
            if (k0 == 0) load_mask(msk, mask, r0, nr, tid);
            for (int idx = tid; idx < TOPK_QT * TOPK_BK; idx += TOPK_THREADS) {
                const int r = idx / TOPK_BK, kk = idx % TOPK_BK;
                const int gq = q0 + r, gk = k0 + kk;
                qs[r * (TOPK_BK + 1) + kk] =
                    (gq < Q && gk < D) ? to_f<T>(q[(size_t)gq * D + gk]) : 0.f;
            }
            for (int idx = tid; idx < TOPK_RT * TOPK_BK; idx += TOPK_THREADS) {
                const int r = idx / TOPK_BK, kk = idx % TOPK_BK;
                const int gk = k0 + kk;
                ds[r * (TOPK_BK + 1) + kk] =
                    (r < nr && gk < D) ? to_f<T>(db[(size_t)(r0 + r) * D + gk]) : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < TOPK_BK; ++kk) {
                float qa[4], da[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) qa[i] = qs[(tq * 4 + i) * (TOPK_BK + 1) + kk];
#pragma unroll
                for (int j = 0; j < 4; ++j) da[j] = ds[(tr + 16 * j) * (TOPK_BK + 1) + kk];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) a[i][j] = fmaf(qa[i], da[j], a[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[(tq * 4 + i) * (TOPK_RT + 1) + tr + 16 * j] = a[i][j];
        __syncthreads();

        kselect_tile(sc, TOPK_RT + 1, st_s, st_i, k, nr, r0, q0, Q, warp, lane,
                     mask ? msk : nullptr);
        // the next tile's first __syncthreads orders these updates before
        // sc and msk are overwritten
    }
    __syncthreads();
    write_partials(st_s, st_i, k, split, q0, Q, tid, part_s, part_i);
}

// bf16 variant: the score tile comes from warp-level tensor-core products
// (WMMA 16x16x16, bf16 in, fp32 accumulate). The (row tile, d step) operand
// tiles stream in order through a two-stage cp.async ring, so the next
// copy overlaps the current products and the k-select.
constexpr int TC_BK = 64;            // reduction step over d
constexpr int TC_LDK = TC_BK + 8;    // bf16 row stride of the q / db tiles
constexpr int TC_LDS = TOPK_RT + 4;  // fp32 row stride of the score tile
constexpr int TC_STAGE = (TOPK_QT + TOPK_RT) * TC_LDK;   // bf16 per stage
constexpr size_t SC_BYTES = (size_t)TOPK_QT * TC_LDS * sizeof(float);

__host__ __device__ inline size_t topk_tc_state_bytes(int k) {
    return ((size_t)TOPK_QT * k * 8 + 127) / 128 * 128;
}

__host__ __device__ inline size_t topk_tc_smem(int k) {
    return topk_tc_state_bytes(k) + 2 * (size_t)TC_STAGE * 2 + SC_BYTES + TOPK_RT;
}

// 16-byte asynchronous global->shared copy; `ok == false` zero-fills the
// destination without reading (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(n));
}

// queries [q0, q0+QT) and rows [r0, r0+nr), columns [k0, k0+BK) -> one stage
__device__ __forceinline__ void tc_load_stage(__nv_bfloat16* stage,
                                              const __nv_bfloat16* q,
                                              const __nv_bfloat16* db, int q0,
                                              int Q, int r0, int nr, int k0,
                                              int D, int tid) {
    __nv_bfloat16* qs = stage;
    __nv_bfloat16* ds = stage + TOPK_QT * TC_LDK;
    for (int v = tid; v < TOPK_QT * TC_BK / 8; v += TOPK_THREADS) {
        const int r = v / (TC_BK / 8), k8 = (v % (TC_BK / 8)) * 8;
        const int gq = q0 + r, gk = k0 + k8;
        const bool ok = gq < Q && gk < D;
        cp_async16(qs + r * TC_LDK + k8, ok ? q + (size_t)gq * D + gk : q, ok);
    }
    for (int v = tid; v < TOPK_RT * TC_BK / 8; v += TOPK_THREADS) {
        const int r = v / (TC_BK / 8), k8 = (v % (TC_BK / 8)) * 8;
        const int gk = k0 + k8;
        const bool ok = r < nr && gk < D;
        cp_async16(ds + r * TC_LDK + k8, ok ? db + (size_t)(r0 + r) * D + gk : db, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// One bf16 d step of the warp's 16 queries x 32 rows: qs [QT][TC_LDK],
// ds [RT][TC_LDK].
__device__ __forceinline__ void tc_step(
        nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>* acc,
        const __nv_bfloat16* qs, const __nv_bfloat16* ds, int fq, int fr0) {
    using namespace nvcuda;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
        wmma::load_matrix_sync(afr, qs + fq * 16 * TC_LDK + kk, TC_LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
            wmma::load_matrix_sync(bfr, ds + (fr0 + j) * 16 * TC_LDK + kk, TC_LDK);
            wmma::mma_sync(acc[j], afr, bfr, acc[j]);
        }
    }
}

__global__ void __launch_bounds__(TOPK_THREADS)
topk_scan_tc_kernel(const __nv_bfloat16* __restrict__ db,
                    const __nv_bfloat16* __restrict__ q,
                    const unsigned char* __restrict__ mask, int D, int Q,
                    int n_valid, int k, int rows_per_split,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* st_s = reinterpret_cast<float*>(smem_raw);                    // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);              // [QT][k]
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + topk_tc_state_bytes(k));
    float* sc = reinterpret_cast<float*>(ring + 2 * TC_STAGE);            // [QT][LDS]
    unsigned char* msk = reinterpret_cast<unsigned char*>(sc + TOPK_QT * TC_LDS);

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * TOPK_QT;
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n_valid, r_begin + rows_per_split);
    const int fq = warp / 2, fr0 = (warp % 2) * 2;   // 16 queries x 32 rows per warp
    const int nK = ceil_div(D, TC_BK);
    const int n_tiles = r_end > r_begin ? ceil_div(r_end - r_begin, TOPK_RT) : 0;
    const int steps = n_tiles * nK;

    init_state(st_s, st_i, k, tid);
    if (steps > 0)
        tc_load_stage(ring, q, db, q0, Q, r_begin, min(TOPK_RT, r_end - r_begin), 0, D, tid);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    for (int g = 0; g < steps; ++g) {
        const int t = g / nK, s = g % nK;
        const int r0 = r_begin + t * TOPK_RT;
        const int nr = min(TOPK_RT, r_end - r0);
        if (s == 0) {
            wmma::fill_fragment(acc[0], 0.f);
            wmma::fill_fragment(acc[1], 0.f);
            load_mask(msk, mask, r0, nr, tid);
        }
        if (g + 1 < steps) {
            const int t1 = (g + 1) / nK, s1 = (g + 1) % nK;
            const int r1 = r_begin + t1 * TOPK_RT;
            tc_load_stage(ring + ((g + 1) & 1) * TC_STAGE, q, db, q0, Q, r1,
                          min(TOPK_RT, r_end - r1), s1 * TC_BK, D, tid);
            asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        const __nv_bfloat16* qs = ring + (g & 1) * TC_STAGE;
        tc_step(acc, qs, qs + TOPK_QT * TC_LDK, fq, fr0);
        if (s == nK - 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::store_matrix_sync(sc + fq * 16 * TC_LDS + (fr0 + j) * 16, acc[j],
                                        TC_LDS, wmma::mem_row_major);
            __syncthreads();
            kselect_tile(sc, TC_LDS, st_s, st_i, k, nr, r0, q0, Q, warp, lane,
                         mask ? msk : nullptr);
        }
        __syncthreads();   // this stage is refilled two steps later; sc consumed
    }
    __syncthreads();
    write_partials(st_s, st_i, k, split, q0, Q, tid, part_s, part_i);
}

// int8 mode: int8 rows and the two int8 query digits [2, Q, D], WMMA s8
// (16x16x16, s32 accumulate) per digit. A stage holds, for one 64-byte d
// step, the hi digits, the lo digits and the rows as [chunk][row][16 B]
// blocks, so every 16x16 operand tile starts 256-byte aligned.
constexpr int I8_BK = 64;                               // bytes of d per step
constexpr int I8_CH = I8_BK / 16;                       // 16-byte chunks per step
constexpr int I8_STAGE = 3 * I8_CH * TOPK_RT * 16;      // bytes; QT == RT == 64
static_assert(TOPK_QT == TOPK_RT, "int8 stage layout assumes QT == RT");

__host__ __device__ inline size_t topk_i8_smem(int k) {
    return topk_tc_state_bytes(k) + 2 * (size_t)I8_STAGE + 2 * SC_BYTES + TOPK_RT;
}

// ops 0 .. ND-1: query digit planes, op ND: rows. `vec` (D % 16 == 0 and
// 16-byte aligned bases) copies with cp.async; otherwise byte by byte, zero
// past D.
template <int ND>
__device__ __forceinline__ void i8_load_stage(signed char* stage,
                                              const signed char* qd,
                                              const signed char* db, int q0,
                                              int Q, int r0, int nr, int k0,
                                              int D, bool vec, int tid) {
    for (int v = tid; v < (ND + 1) * TOPK_RT * I8_CH; v += TOPK_THREADS) {
        const int op = v / (TOPK_RT * I8_CH), rem = v % (TOPK_RT * I8_CH);
        const int r = rem / I8_CH, kc = rem % I8_CH;
        signed char* dst = stage + ((op * I8_CH + kc) * TOPK_RT + r) * 16;
        const int gk = k0 + kc * 16;
        const bool row_ok = op < ND ? q0 + r < Q : r < nr;
        const signed char* src = op < ND ? qd + ((size_t)op * Q + q0 + r) * D + gk
                                         : db + (size_t)(r0 + r) * D + gk;
        if (vec) {
            const bool ok = row_ok && gk < D;
            cp_async16(dst, ok ? src : db, ok);
        } else {
            for (int b = 0; b < 16; ++b) dst[b] = (row_ok && gk + b < D) ? src[b] : 0;
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// ND = 2: K9, two query digits, scored f32(hi) * 254 + f32(lo) (the caller
// scales); ND = 1: K12, one query digit against rows with their own scales,
// scored (f32(dot) * q_scale[q]) * row_scale[r], rounded after each multiply.
template <int ND>
__global__ void __launch_bounds__(TOPK_THREADS)
topk_scan_i8_kernel(const signed char* __restrict__ db,
                    const signed char* __restrict__ qd,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ row_scale,
                    const unsigned char* __restrict__ mask, int D, int Q,
                    int n_valid, int k, int rows_per_split, bool vec,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* st_s = reinterpret_cast<float*>(smem_raw);                    // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);              // [QT][k]
    signed char* ring = reinterpret_cast<signed char*>(smem_raw + topk_tc_state_bytes(k));
    int* dot_hi = reinterpret_cast<int*>(ring + 2 * I8_STAGE);           // [QT][LDS]
    int* dot_lo = dot_hi + TOPK_QT * TC_LDS;                             // [QT][LDS]
    unsigned char* msk = reinterpret_cast<unsigned char*>(dot_lo + TOPK_QT * TC_LDS);
    float* sc = reinterpret_cast<float*>(dot_hi);   // the combined scores, in place

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * TOPK_QT;
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n_valid, r_begin + rows_per_split);
    const int fq = warp / 2, fr0 = (warp % 2) * 2;   // 16 queries x 32 rows per warp
    const int nK = ceil_div(D, I8_BK);
    const int n_tiles = r_end > r_begin ? ceil_div(r_end - r_begin, TOPK_RT) : 0;
    const int steps = n_tiles * nK;

    init_state(st_s, st_i, k, tid);
    if (steps > 0)
        i8_load_stage<ND>(ring, qd, db, q0, Q, r_begin, min(TOPK_RT, r_end - r_begin), 0,
                          D, vec, tid);

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc_hi[2], acc_lo[2];
    for (int g = 0; g < steps; ++g) {
        const int t = g / nK, s = g % nK;
        const int r0 = r_begin + t * TOPK_RT;
        const int nr = min(TOPK_RT, r_end - r0);
        if (s == 0) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fill_fragment(acc_hi[j], 0);
                wmma::fill_fragment(acc_lo[j], 0);
            }
            load_mask(msk, mask, r0, nr, tid);
        }
        if (g + 1 < steps) {
            const int t1 = (g + 1) / nK, s1 = (g + 1) % nK;
            const int r1 = r_begin + t1 * TOPK_RT;
            i8_load_stage<ND>(ring + ((g + 1) & 1) * I8_STAGE, qd, db, q0, Q, r1,
                              min(TOPK_RT, r_end - r1), s1 * I8_BK, D, vec, tid);
            asm volatile("cp.async.wait_group 1;\n" ::);
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        const signed char* st = ring + (g & 1) * I8_STAGE;
#pragma unroll
        for (int kc = 0; kc < I8_CH; ++kc) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a_hi, a_lo;
            wmma::load_matrix_sync(a_hi, st + ((0 * I8_CH + kc) * TOPK_RT + fq * 16) * 16, 16);
            if (ND == 2)
                wmma::load_matrix_sync(a_lo, st + ((1 * I8_CH + kc) * TOPK_RT + fq * 16) * 16, 16);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr;
                wmma::load_matrix_sync(
                    bfr, st + ((ND * I8_CH + kc) * TOPK_RT + (fr0 + j) * 16) * 16, 16);
                wmma::mma_sync(acc_hi[j], a_hi, bfr, acc_hi[j]);
                if (ND == 2) wmma::mma_sync(acc_lo[j], a_lo, bfr, acc_lo[j]);
            }
        }
        if (s == nK - 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int o = fq * 16 * TC_LDS + (fr0 + j) * 16;
                wmma::store_matrix_sync(dot_hi + o, acc_hi[j], TC_LDS, wmma::mem_row_major);
                if (ND == 2)
                    wmma::store_matrix_sync(dot_lo + o, acc_lo[j], TC_LDS, wmma::mem_row_major);
            }
            __syncwarp();
            // the warp's own 16 x 32 block: exact s32 dots -> one f32 score,
            // rounded after each multiply and add
            for (int e = lane; e < 16 * 32; e += 32) {
                const int qq = fq * 16 + e / 32, rr = fr0 * 16 + e % 32;
                const int o = qq * TC_LDS + rr;
                const float hi = __int2float_rn(dot_hi[o]);
                if (ND == 2) {
                    sc[o] = __fadd_rn(__fmul_rn(hi, 254.f), __int2float_rn(dot_lo[o]));
                } else {
                    const float qsc = q0 + qq < Q ? q_scale[q0 + qq] : 0.f;
                    const float rsc = rr < nr ? row_scale[r0 + rr] : 0.f;
                    sc[o] = __fmul_rn(__fmul_rn(hi, qsc), rsc);
                }
            }
            __syncthreads();
            kselect_tile(sc, TC_LDS, st_s, st_i, k, nr, r0, q0, Q, warp, lane,
                         mask ? msk : nullptr);
        }
        __syncthreads();   // this stage is refilled two steps later; sc consumed
    }
    __syncthreads();
    write_partials(st_s, st_i, k, split, q0, Q, tid, part_s, part_i);
}

// binary mode: packed rows [N, W] uint8 (dims D = 8W), bf16 queries
// [Q, 8W]. Each row tile's packed bytes are staged once; each d step
// unpacks its [RT, 64] slice to +-1 bf16 beside the query slice.
constexpr int BIN_STAGE = (TOPK_QT + TOPK_RT) * TC_LDK;   // bf16

__host__ __device__ inline size_t topk_bin_smem(int k, int W) {
    return topk_tc_state_bytes(k) + (size_t)BIN_STAGE * 2 + SC_BYTES +
           (size_t)TOPK_RT * W + TOPK_RT;
}

__global__ void __launch_bounds__(TOPK_THREADS)
topk_scan_bin_kernel(const unsigned char* __restrict__ db,
                     const __nv_bfloat16* __restrict__ q,
                     const unsigned char* __restrict__ mask, int W, int Q,
                     int n_valid, int k, int rows_per_split,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* st_s = reinterpret_cast<float*>(smem_raw);                    // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);              // [QT][k]
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + topk_tc_state_bytes(k));
    __nv_bfloat16* ds = qs + TOPK_QT * TC_LDK;                            // [RT][LDK]
    float* sc = reinterpret_cast<float*>(ds + TOPK_RT * TC_LDK);          // [QT][LDS]
    unsigned char* pk = reinterpret_cast<unsigned char*>(sc + TOPK_QT * TC_LDS);  // [RT][W]
    unsigned char* msk = pk + TOPK_RT * W;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int q0 = blockIdx.x * TOPK_QT;
    const int split = blockIdx.y;
    const int r_begin = split * rows_per_split;
    const int r_end = min(n_valid, r_begin + rows_per_split);
    const int fq = warp / 2, fr0 = (warp % 2) * 2;
    const int D = 8 * W;
    const int nK = ceil_div(D, TC_BK);

    init_state(st_s, st_i, k, tid);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    for (int r0 = r_begin; r0 < r_end; r0 += TOPK_RT) {
        const int nr = min(TOPK_RT, r_end - r0);
        __syncthreads();   // the last tile's k-select is done with sc, pk, msk
        const unsigned char* rows = db + (size_t)r0 * W;   // rows are contiguous
        for (int idx = tid; idx < TOPK_RT * W; idx += TOPK_THREADS)
            pk[idx] = (idx / W < nr) ? rows[idx] : 0;
        load_mask(msk, mask, r0, nr, tid);
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
        for (int s = 0; s < nK; ++s) {
            const int k0 = s * TC_BK;
            __syncthreads();   // pk staged; the last step's products are done
            for (int v = tid; v < TOPK_QT * TC_BK / 8; v += TOPK_THREADS) {
                const int r = v / (TC_BK / 8), k8 = (v % (TC_BK / 8)) * 8;
                const int gq = q0 + r, gk = k0 + k8;
                uint4 val = make_uint4(0u, 0u, 0u, 0u);
                if (gq < Q && gk < D)
                    val = *reinterpret_cast<const uint4*>(q + (size_t)gq * D + gk);
                *reinterpret_cast<uint4*>(qs + r * TC_LDK + k8) = val;
            }
            for (int v = tid; v < TOPK_RT * TC_BK; v += TOPK_THREADS) {
                const int r = v / TC_BK, kk = v % TC_BK;
                const int gk = k0 + kk;
                float x = 0.f;
                if (gk < D) x = ((pk[r * W + gk % W] >> (gk / W)) & 1) ? 1.f : -1.f;
                ds[r * TC_LDK + kk] = __float2bfloat16(x);
            }
            __syncthreads();
            tc_step(acc, qs, ds, fq, fr0);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(sc + fq * 16 * TC_LDS + (fr0 + j) * 16, acc[j],
                                    TC_LDS, wmma::mem_row_major);
        __syncthreads();
        kselect_tile(sc, TC_LDS, st_s, st_i, k, nr, r0, q0, Q, warp, lane,
                     mask ? msk : nullptr);
    }
    __syncthreads();
    write_partials(st_s, st_i, k, split, q0, Q, tid, part_s, part_i);
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

template <typename Kernel, typename... Args>
static int launch_smem(Kernel kernel, size_t smem, int Q, int n_splits,
                       cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(Q, TOPK_QT), n_splits);
    kernel<<<grid, TOPK_THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_scan(const void* db, const void* q, const unsigned char* mask,
                       int D, int Q, int n_valid, int k, int n_splits,
                       int rows_per_split, float* part_s, int* part_i,
                       cudaStream_t stream) {
    const size_t smem = ((size_t)TOPK_QT * k * 2 + TOPK_QT * (TOPK_BK + 1) +
                         TOPK_RT * (TOPK_BK + 1) + TOPK_QT * (TOPK_RT + 1)) *
                            sizeof(float) + TOPK_RT;
    return launch_smem(topk_scan_kernel<T>, smem, Q, n_splits, stream,
                       static_cast<const T*>(db), static_cast<const T*>(q), mask,
                       D, Q, n_valid, k, rows_per_split, part_s, part_i);
}

// mode: kFloat32 / kBFloat16 (q [Q, D] in the rows' dtype), kInt8 (q the
// digits [2, Q, D] int8), kBinaryPacked (D = W packed bytes per row, q
// [Q, 8W] bf16). mask: [n_valid] uint8 or null.
static int launch_topk(const void* db, const void* q, const void* mask_v, int D,
                       int Q, int n_valid, int k, int n_splits, void* part_s_v,
                       void* part_i_v, void* out_s, void* out_i, int mode,
                       cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || n_splits < 1 || D < 1) return kUnsupported;
    const auto* mask = static_cast<const unsigned char*>(mask_v);
    auto* part_s = static_cast<float*>(part_s_v);
    auto* part_i = static_cast<int*>(part_i_v);
    // whole row tiles per split, so every split but the last is full
    int rows_per_split = ceil_div(max(n_valid, 1), n_splits);
    rows_per_split = ceil_div(rows_per_split, TOPK_RT) * TOPK_RT;
    int status;
    if (mode == kBFloat16 && D % 8 == 0)
        status = launch_smem(topk_scan_tc_kernel, topk_tc_smem(k), Q, n_splits, stream,
                             static_cast<const __nv_bfloat16*>(db),
                             static_cast<const __nv_bfloat16*>(q), mask, D, Q, n_valid,
                             k, rows_per_split, part_s, part_i);
    else if (mode == kBFloat16)
        status = launch_scan<__nv_bfloat16>(db, q, mask, D, Q, n_valid, k, n_splits,
                                            rows_per_split, part_s, part_i, stream);
    else if (mode == kFloat32)
        status = launch_scan<float>(db, q, mask, D, Q, n_valid, k, n_splits,
                                    rows_per_split, part_s, part_i, stream);
    else if (mode == kInt8) {
        const bool vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(q) % 16 == 0;
        status = launch_smem(topk_scan_i8_kernel<2>, topk_i8_smem(k), Q, n_splits, stream,
                             static_cast<const signed char*>(db),
                             static_cast<const signed char*>(q), nullptr, nullptr, mask,
                             D, Q, n_valid, k, rows_per_split, vec, part_s, part_i);
    }
    else if (mode == kBinaryPacked && D <= BIN_WMAX)
        status = launch_smem(topk_scan_bin_kernel, topk_bin_smem(k, D), Q, n_splits,
                             stream, static_cast<const unsigned char*>(db),
                             static_cast<const __nv_bfloat16*>(q), mask, D, Q, n_valid,
                             k, rows_per_split, part_s, part_i);
    else
        return kUnsupported;
    if (status != 0) return status;
    return launch_merge(part_s, part_i, Q, k, n_splits, out_s, out_i, stream);
}

// K12's stage 1: int8 rows [n_valid.., D] with per-row f32 scales against
// one int8 digit per query [Q, D] with per-query f32 scales.
static int launch_topk_int8_rows(const void* db, const void* q, const void* q_scale,
                                 const void* row_scale, int D, int Q, int n_valid, int k,
                                 int n_splits, void* part_s_v, void* part_i_v, void* out_s,
                                 void* out_i, cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || n_splits < 1 || D < 1) return kUnsupported;
    auto* part_s = static_cast<float*>(part_s_v);
    auto* part_i = static_cast<int*>(part_i_v);
    int rows_per_split = ceil_div(max(n_valid, 1), n_splits);
    rows_per_split = ceil_div(rows_per_split, TOPK_RT) * TOPK_RT;
    const bool vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const int status = launch_smem(
        topk_scan_i8_kernel<1>, topk_i8_smem(k), Q, n_splits, stream,
        static_cast<const signed char*>(db), static_cast<const signed char*>(q),
        static_cast<const float*>(q_scale), static_cast<const float*>(row_scale),
        static_cast<const unsigned char*>(nullptr), D, Q, n_valid, k, rows_per_split, vec,
        part_s, part_i);
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
