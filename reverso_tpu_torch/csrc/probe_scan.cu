// Hardware probe P3: the top-k scan's pipeline without its k-select.
//
// Replaces: scripts/bench_scan_overlap.py's kernel (its pl.pallas_call at
// :144): Q bf16 queries against [N, d] bf16 rows through a ring of row
// tiles, scores q . row in fp32, in three of its variants:
//   * unroll: out[q, c] = the max over tiles t of q . row[t TILE + c], out
//     [Q, TILE] with this port's TILE = 128 (the rows of K1's tile);
//   * stage: each tile's scores written to shared memory, two tiles at a
//     time, then reduced to each query's max (what a select reads): out [Q];
//   * wide: stage plus the TPU kernel's three extraction passes over the two
//     tiles' scores (the max, the lowest column holding it, the count above
//     the running max), added in at zero weight: out [Q], as stage.
// The TPU's `dyn` variant (a ring slot indexed at run time, which Mosaic
// could not prove disjoint from the next copy) has no meaning here: a ring
// stage is always indexed at run time.
//
// What bounds it on the H100: at 1M x 1024 and Q = 256, the 2 GiB of rows
// (0.64 ms at 3.35 TB/s) against 2 Q N d operations (0.54 ms at 989
// TFLOP/s): the bytes. K1 at the same shape takes this pipeline plus its
// select, so the difference of the two times is the select's cost.
//
// What the design does about it: K1's own geometry (csrc/topk_stream.cu,
// scan_wg at a 128-query block): the grid is one wave of row splits x
// ceil(Q / 128) query blocks; a producer warp keeps TMA loads of 128 rows x
// 64 dims and the block's 128 queries x 64 dims (128-byte swizzle) in a ring
// of `stages` stages (K1's five at k = 10 for unroll; three beside stage's
// and wide's 128 KB of staged scores); two consumer warpgroups each run
// m64n128k16 SS products over 64 of the tile's rows and keep the scores in
// registers. unroll folds them into a running max per register; stage and
// wide write them to [2][128 queries][128 rows] fp32 and, every second
// tile, reduce: a pair of lanes per query (one per tile), rows read at a
// rotation by lane so that a warp hits 32 banks, the two halves combined by
// a shuffle. The CTAs combine by an atomic max on the fp32 bits.
#include "hopper.cuh"

namespace rv {
namespace probe_scan {

using namespace tc;

constexpr int kUnroll = 0, kStage = 1, kWide = 2;   // probes/bench_scan_overlap.py::VARIANTS
constexpr int kN = 128;                  // queries of a block
constexpr int kRows = 128;               // rows of a tile
constexpr int kKs = 64;                  // dims of a k step: 128 bytes of bf16
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kThreads = kConsumers + 32;
constexpr int kStageBytes = kRows * 128 + kN * 128;  // bytes of a ring stage
constexpr int kStaged = 2 * kN * kRows * 4;          // two tiles' scores
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr size_t smem_bytes(int variant, int stages) {
    return 1024 + (size_t)stages * kStageBytes + (variant == kUnroll ? 0 : kStaged) + 16 * kMaxStages;
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads, 1)
scan_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap qmap,
            int Q, int n, int n_k, int rows_per_split, int stages, float* __restrict__ out) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    float* sp = reinterpret_cast<float*>(ring + stages * kStageBytes);     // [2][kN][kRows]
    uint64_t* full = reinterpret_cast<uint64_t*>(
        reinterpret_cast<uint8_t*>(sp) + (VARIANT == kUnroll ? 0 : kStaged));
    uint64_t* empty = full + kMaxStages;
    const int r_begin = blockIdx.x * rows_per_split;
    const int r_end = min(n, r_begin + rows_per_split);
    const int q0 = blockIdx.y * kN, nq = min(kN, Q - q0);
    const int n_tiles = r_end > r_begin ? ceil_div(r_end - r_begin, kRows) : 0;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers / 32);
        }
        fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / kWgThreads;
    const int lane = threadIdx.x % 32;
    if (wg == 2) {   // ---- producer: lane 0 issues the loads ----
        if (lane != 0) return;
        for (int t = 0, j = 0; t < n_tiles; ++t) {
            const int r0 = r_begin + t * kRows;
            for (int ks = 0; ks < n_k; ++ks, ++j) {
                const int s = j % stages;
                mbar_wait(&empty[s], ((j / stages) & 1) ^ 1);
                uint8_t* st = ring + s * kStageBytes;
                mbar_expect_tx(&full[s], kStageBytes);
                tma_load_2d(st, &amap, &full[s], ks * kKs, r0);
                tma_load_2d(st + kRows * 128, &qmap, &full[s], ks * kKs, q0);
            }
        }
        return;
    }

    // ---- consumers: rows rr and rr + 8 of each tile, query columns
    // 8 i + 2 t4 + (e & 1) of register 4 i + e ----
    const int warp = (threadIdx.x % kWgThreads) / 32, t4 = lane % 4;
    const int rr = wg * 64 + warp * 16 + lane / 4;
    const uint32_t ring_addr = smem_addr(ring);
    float acc[kN / 2];
    float mx[VARIANT == kUnroll ? kN / 2 : 1];   // unroll: the running max of each register
#pragma unroll
    for (int i = 0; i < (VARIANT == kUnroll ? kN / 2 : 1); ++i) mx[i] = -CUDART_INF_F;
    // stage, wide: thread (c, h) = (tid / 2, tid % 2) reduces query column c
    // of the pair's tile h; `run` is the column's running max
    const int col = threadIdx.x / 2, half = threadIdx.x % 2;
    float run = -CUDART_INF_F;
    float zero = 0.f;
    asm volatile("" : "+f"(zero));   // a zero the compiler cannot fold (the TPU's `* 0.0`)
    int j = 0;
    for (int t = 0; t < n_tiles; ++t) {
        const int r0 = r_begin + t * kRows;
        for (int ks = 0; ks < n_k; ++ks, ++j) {
            const int s = j % stages;
            const uint32_t st = ring_addr + s * kStageBytes;
            mbar_wait(&full[s], (j / stages) & 1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                WgmmaSS<kN>::run(acc, gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024, 1),
                                 gmma_desc(st + kRows * 128 + kk * 32, 16, 1024, 1),
                                 (ks > 0 || kk > 0) ? 1 : 0);
            wgmma_commit();
            wgmma_wait<1>();
            if (ks > 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
            }
        }
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
        fence_operand(acc);
        const bool ok_a = r0 + rr < r_end, ok_b = r0 + rr + 8 < r_end;
        if constexpr (VARIANT == kUnroll) {
#pragma unroll
            for (int i = 0; i < kN / 2; ++i)
                mx[i] = fmaxf(mx[i], ((i >> 1) & 1 ? ok_b : ok_a) ? acc[i] : -CUDART_INF_F);
        } else {
            float* g = sp + (t % 2) * kN * kRows;
#pragma unroll
            for (int i = 0; i < kN / 2; ++i) {
                const int c = 8 * (i / 4) + 2 * t4 + (i & 1), r = rr + 8 * ((i >> 1) & 1);
                g[c * kRows + r] = ((i >> 1) & 1 ? ok_b : ok_a) ? acc[i] : -CUDART_INF_F;
            }
            if (t % 2 == 1 || t == n_tiles - 1) {   // a pair (or the last tile alone)
                named_bar_sync(1, kConsumers);
                const bool has = half == 0 || t % 2 == 1;
                const float* h = sp + half * kN * kRows + col * kRows;
                float pmax = -CUDART_INF_F;
                if (has)
                    for (int r = 0; r < kRows; ++r) pmax = fmaxf(pmax, h[(r + lane) % kRows]);
                if constexpr (VARIANT == kStage) {
                    run = fmaxf(run, pmax);
                } else {
                    const float m0 = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 1));
                    int psel = 1 << 30, pcnt = 0;
                    if (has) {
                        for (int r = 0; r < kRows; ++r) {
                            const int rot = (r + lane) % kRows;
                            if (h[rot] == m0) psel = min(psel, half * kRows + rot);
                        }
                        for (int r = 0; r < kRows; ++r) pcnt += h[(r + lane) % kRows] > run ? 1 : 0;
                    }
                    const int sel = min(psel, __shfl_xor_sync(0xffffffffu, psel, 1));
                    const int cnt = pcnt + __shfl_xor_sync(0xffffffffu, pcnt, 1);
                    run = fmaxf(run, m0 + (float)sel * zero + (float)cnt * zero);
                }
                named_bar_sync(1, kConsumers);
            }
        }
    }
    if constexpr (VARIANT == kUnroll) {
        if (n_tiles > 0) {
#pragma unroll
            for (int i = 0; i < kN / 2; ++i) {
                const int c = 8 * (i / 4) + 2 * t4 + (i & 1), r = rr + 8 * ((i >> 1) & 1);
                if (c < nq) atomic_max_f32(out + (size_t)(q0 + c) * kRows + r, mx[i]);
            }
        }
    } else {
        run = fmaxf(run, __shfl_xor_sync(0xffffffffu, run, 1));
        if (n_tiles > 0 && half == 0 && col < nq) atomic_max_f32(out + q0 + col, run);
    }
}

template <int VARIANT>
static int launch_variant(const CUtensorMap& am, const CUtensorMap& qm, int Q, int n, int d,
                          int stages, float* out, cudaStream_t stream) {
    auto kernel = scan_kernel<VARIANT>;
    const size_t smem = smem_bytes(VARIANT, stages);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 1;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    const int q_blocks = ceil_div(Q, kN);
    const int splits = max(1, min(ceil_div(sms, q_blocks), ceil_div(n, kRows)));
    const int rows_per_split = ceil_div(ceil_div(n, splits), kRows) * kRows;
    kernel<<<dim3(ceil_div(n, rows_per_split), q_blocks), kThreads, smem, stream>>>(
        am, qm, Q, n, ceil_div(d, kKs), rows_per_split, stages, out);
    return (int)cudaGetLastError();
}

// db [n, d] bf16 and q [Q, d] bf16 (d % 8 == 0, 16-byte aligned bases);
// out: unroll [Q, 128], stage and wide [Q], fp32, filled with -inf;
// stages 0 takes as many as fit (at most 8)
static int launch(const void* db, const void* q, int n, int d, int Q, int variant, int stages,
                  void* out, cudaStream_t stream) {
    if (n < 1 || Q < 1 || d < 8 || d % 8 != 0 || variant < kUnroll || variant > kWide ||
        stages < 0 || stages == 1 || stages > kMaxStages ||
        reinterpret_cast<uintptr_t>(db) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
        return kUnsupported;
    if (stages == 0) {
        stages = 2;
        while (stages < kMaxStages && smem_bytes(variant, stages + 1) <= kSmemMax) ++stages;
    }
    if (smem_bytes(variant, stages) > kSmemMax) return kUnsupported;
    CUtensorMap am, qm;
    if (!make_map_tiled(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, db, d, n, kKs, kRows,
                        CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_tiled(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, d, Q, kKs, kN,
                        CU_TENSOR_MAP_SWIZZLE_128B))
        return kMapError;
    float* o = static_cast<float*>(out);
    if (variant == kUnroll) return launch_variant<kUnroll>(am, qm, Q, n, d, stages, o, stream);
    if (variant == kStage) return launch_variant<kStage>(am, qm, Q, n, d, stages, o, stream);
    return launch_variant<kWide>(am, qm, Q, n, d, stages, o, stream);
}

}  // namespace probe_scan
}  // namespace rv

extern "C" int rv_probe_scan(const void* db, const void* q, int n, int d, int Q, int variant,
                             int stages, void* out, void* stream) {
    return rv::probe_scan::launch(db, q, n, d, Q, variant, stages, out,
                                  static_cast<cudaStream_t>(stream));
}
