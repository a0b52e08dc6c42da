// Exact dot-product top-k with a fused per-query k-select.
//
// Replaces: reverso_tpu/ops/topk.py::_topk_stream_kernel in its plain mode
// (entry cosine_topk_pallas), the exact search of DeviceIndex.
//
// What bounds it on the H100: one pass over the [N, d] database (2 GiB at
// 1M x 1024 bf16, 0.6 ms at the published H100 SXM peak of 3.35 TB/s, 700 W)
// against 2 * Q * N * d FLOPs (537 GFLOP at Q = 256, 0.5 ms at the published
// bf16 tensor-core peak of 989 TFLOP/s, 700 W). The database is
// read once per 64-query tile, and the per-tile k-select is serial work on
// the CUDA cores.
//
// What the design does about it:
//   * pass 1: each CTA holds one tile of QT queries and streams its own
//     contiguous slice of database rows in RT-row tiles; CTAs of one row
//     slice are launched next to each other, so their reads share L2. The
//     [QT, RT] score tile comes from warp-level tensor-core products (bf16,
//     WMMA, fp32 accumulate) or, for fp32 stores, a register-tiled FMA
//     product, and lands in shared memory; then each warp updates the
//     sorted top-k lists of its queries, inserting by (-score, idx). Rows
//     arrive in ascending order, so a candidate equal to the current k-th
//     score loses the tie and is skipped. Rows at or past n_valid are never
//     scored. The CTA writes [n_splits, Q, k] partials;
//   * pass 2: one warp per query merges the n_splits sorted partials by
//     (-score, idx): deterministic, ties to the lower row;
//   * the [Q, N] score matrix never exists; slots still at -inf return -1.
// k is capped at TOPK_KMAX = 128 (the reference kernel's cap): the sorted
// state of a 64-query tile is then 64 KB of shared memory.
#include <mma.h>

#include "common.cuh"

namespace rv {

constexpr int TOPK_THREADS = 256;
constexpr int TOPK_QT = 64;     // queries per CTA
constexpr int TOPK_RT = 64;     // database rows per tile
constexpr int TOPK_BK = 32;     // reduction step over d
constexpr int TOPK_KMAX = 128;  // k cap

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
    return sa > sb || (sa == sb && ia < ib);
}

// Warp-cooperative insert of (s, i) into the sorted list S/I of length k.
// The caller guarantees s > S[k - 1], so the insert position is < k.
__device__ __forceinline__ void warp_insert(float* S, int* I, int k, float s,
                                            int i, int lane) {
    int cnt = 0;
    for (int j = lane; j < k; j += 32) cnt += (S[j] >= s) ? 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    const int pos = cnt;
    float ns[TOPK_KMAX / 32];
    int ni[TOPK_KMAX / 32];
#pragma unroll
    for (int t = 0; t < TOPK_KMAX / 32; ++t) {
        const int j = lane + 32 * t;
        ns[t] = 0.f;
        ni[t] = 0;
        if (j < k && j > pos) { ns[t] = S[j - 1]; ni[t] = I[j - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < TOPK_KMAX / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { S[j] = ns[t]; I[j] = ni[t]; }
        if (j == pos) { S[j] = s; I[j] = i; }
    }
    __syncwarp();
}

// k-select over one [QT, RT] score tile `sc` (row stride lds): warp w owns
// queries w*8 .. w*8+7 of the tile and inserts every row that beats the
// query's current k-th score. Rows arrive in ascending order.
__device__ __forceinline__ void kselect_tile(const float* sc, int lds,
                                             float* st_s, int* st_i, int k,
                                             int nr, int r0, int q0, int Q,
                                             int warp, int lane) {
    for (int qq = warp * (TOPK_QT / 8); qq < (warp + 1) * (TOPK_QT / 8); ++qq) {
        if (q0 + qq >= Q) break;
        float* S = st_s + qq * k;
        int* I = st_i + qq * k;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = lane + 32 * half;
            const float s = sc[qq * lds + j];
            const bool real = j < nr;
            unsigned mask = __ballot_sync(0xffffffffu, real && s > S[k - 1]);
            while (mask) {
                const int src = __ffs(mask) - 1;
                const float s_c = __shfl_sync(0xffffffffu, s, src);
                warp_insert(S, I, k, s_c, r0 + 32 * half + src, lane);
                const unsigned later = (src == 31) ? 0u : (0xffffffffu << (src + 1));
                mask = __ballot_sync(0xffffffffu, real && s > S[k - 1]) & later;
            }
        }
    }
}

__device__ __forceinline__ void init_state(float* st_s, int* st_i, int k, int tid) {
    for (int idx = tid; idx < TOPK_QT * k; idx += TOPK_THREADS) {
        st_s[idx] = -CUDART_INF_F;
        st_i[idx] = -1;
    }
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
topk_scan_kernel(const T* __restrict__ db, const T* __restrict__ q, int D,
                 int Q, int n_valid, int k, int rows_per_split,
                 float* __restrict__ part_s, int* __restrict__ part_i) {
    extern __shared__ float smem[];
    float* st_s = smem;                                       // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);   // [QT][k]
    float* qs = reinterpret_cast<float*>(st_i + TOPK_QT * k); // [QT][BK+1]
    float* ds = qs + TOPK_QT * (TOPK_BK + 1);                 // [RT][BK+1]
    float* sc = ds + TOPK_RT * (TOPK_BK + 1);                 // [QT][RT+1]

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

        kselect_tile(sc, TOPK_RT + 1, st_s, st_i, k, nr, r0, q0, Q, warp, lane);
        // the next tile's first __syncthreads orders these updates before
        // sc is overwritten
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

__host__ __device__ inline size_t topk_tc_state_bytes(int k) {
    return ((size_t)TOPK_QT * k * 8 + 127) / 128 * 128;
}

__host__ __device__ inline size_t topk_tc_smem(int k) {
    return topk_tc_state_bytes(k) + 2 * (size_t)TC_STAGE * 2 +
           (size_t)TOPK_QT * TC_LDS * sizeof(float);
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

__global__ void __launch_bounds__(TOPK_THREADS)
topk_scan_tc_kernel(const __nv_bfloat16* __restrict__ db,
                    const __nv_bfloat16* __restrict__ q, int D, int Q,
                    int n_valid, int k, int rows_per_split,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    float* st_s = reinterpret_cast<float*>(smem_raw);                    // [QT][k]
    int* st_i = reinterpret_cast<int*>(st_s + TOPK_QT * k);              // [QT][k]
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + topk_tc_state_bytes(k));
    float* sc = reinterpret_cast<float*>(ring + 2 * TC_STAGE);            // [QT][LDS]

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
        const __nv_bfloat16* ds = qs + TOPK_QT * TC_LDK;
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
        if (s == nK - 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::store_matrix_sync(sc + fq * 16 * TC_LDS + (fr0 + j) * 16, acc[j],
                                        TC_LDS, wmma::mem_row_major);
            __syncthreads();
            kselect_tile(sc, TC_LDS, st_s, st_i, k, nr, r0, q0, Q, warp, lane);
        }
        __syncthreads();   // this stage is refilled two steps later; sc consumed
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

template <typename T>
static int launch_scan(const void* db, const void* q, int D, int Q, int n_valid,
                       int k, int n_splits, int rows_per_split, void* part_s,
                       void* part_i, cudaStream_t stream) {
    const size_t smem = ((size_t)TOPK_QT * k * 2 + TOPK_QT * (TOPK_BK + 1) +
                         TOPK_RT * (TOPK_BK + 1) + TOPK_QT * (TOPK_RT + 1)) *
                        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        topk_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(Q, TOPK_QT), n_splits);
    topk_scan_kernel<T><<<grid, TOPK_THREADS, smem, stream>>>(
        static_cast<const T*>(db), static_cast<const T*>(q), D, Q, n_valid, k,
        rows_per_split, static_cast<float*>(part_s), static_cast<int*>(part_i));
    return (int)cudaGetLastError();
}

static int launch_scan_tc(const void* db, const void* q, int D, int Q,
                          int n_valid, int k, int n_splits, int rows_per_split,
                          void* part_s, void* part_i, cudaStream_t stream) {
    const size_t smem = topk_tc_smem(k);
    cudaError_t err = cudaFuncSetAttribute(
        topk_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(Q, TOPK_QT), n_splits);
    topk_scan_tc_kernel<<<grid, TOPK_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(db), static_cast<const __nv_bfloat16*>(q),
        D, Q, n_valid, k, rows_per_split, static_cast<float*>(part_s),
        static_cast<int*>(part_i));
    return (int)cudaGetLastError();
}

static int launch_topk(const void* db, const void* q, int D, int Q,
                       int n_valid, int k, int n_splits, void* part_s,
                       void* part_i, void* out_s, void* out_i, int dtype,
                       cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || n_splits < 1) return kUnsupported;
    // whole row tiles per split, so every split but the last is full
    int rows_per_split = ceil_div(max(n_valid, 1), n_splits);
    rows_per_split = ceil_div(rows_per_split, TOPK_RT) * TOPK_RT;
    int status;
    if (dtype == kBFloat16 && D % 8 == 0)
        status = launch_scan_tc(db, q, D, Q, n_valid, k, n_splits, rows_per_split, part_s, part_i, stream);
    else if (dtype == kBFloat16)
        status = launch_scan<__nv_bfloat16>(db, q, D, Q, n_valid, k, n_splits, rows_per_split, part_s, part_i, stream);
    else if (dtype == kFloat32)
        status = launch_scan<float>(db, q, D, Q, n_valid, k, n_splits, rows_per_split, part_s, part_i, stream);
    else
        return kUnsupported;
    if (status != 0) return status;
    topk_merge_kernel<<<Q, 32, n_splits * sizeof(int), stream>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i), Q,
        k, n_splits, static_cast<float*>(out_s), static_cast<int*>(out_i));
    return (int)cudaGetLastError();
}

}  // namespace rv

extern "C" int rv_topk_stream(const void* db, const void* q, int D, int Q,
                              int n_valid, int k, int n_splits, void* part_s,
                              void* part_i, void* out_s, void* out_i,
                              int dtype, void* stream) {
    return rv::launch_topk(db, q, D, Q, n_valid, k, n_splits, part_s, part_i,
                           out_s, out_i, dtype, static_cast<cudaStream_t>(stream));
}
