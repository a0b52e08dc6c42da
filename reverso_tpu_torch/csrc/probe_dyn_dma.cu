// Hardware probe P4: a load at a data-dependent row, then one product.
//
// Replaces: scripts/proto_dyn_dma.py's kernel (its pl.pallas_call at :58):
// `reps` times, one copy of rows = 512 rows of an [n, d] matrix (int8 or
// bf16) at an offset read from an int32 array, then their scores against 8
// resident query rows, out [8, rows] fp32 (int8: exact s32 sums). The
// TPU kernel keeps the last rep's scores; this one writes every rep's,
// out [reps, 8, rows], so that each load is checked.
//
// What bounds it on the H100: the bytes, rows x d x itemsize a rep (1 MB
// in bf16 at d = 1024, 0.31 us at 3.35 TB/s); 2 x 8 x rows x d operations
// a rep are nothing beside them.
//
// What the design does about it: the offset is a TMA coordinate. One 2-D
// map over the matrix (128-byte swizzle) takes any row origin (only the
// base and the row pitch need 16-byte alignment), so a rep's rows come as
// 128-byte k steps of two 256-row boxes each, with the 8 query rows beside
// them, through a ring of 3 stages (65 KB each); a producer lane reads the
// offset from device memory. Two consumer warpgroups each own 256 of the
// rows on wgmma's M side (four m64 tiles) with the queries on N = 8
// (m64n8k16 bf16, m64n8k32 s8), so no query padding is loaded. Two forms:
// one CTA walks the reps in order (the TPU's form: one core, each load
// then its product; the ring here overlaps the next rep's loads with this
// rep's products, which the TPU kernel did not), or a grid of one CTA an
// SM takes the reps in turn (the rate).
#include <type_traits>

#include "hopper.cuh"

namespace rv {
namespace probe_dyn_dma {

using namespace tc;

constexpr int kRows = 512;                   // rows of a rep: two 256-row boxes
constexpr int kQ = 8;                        // query rows
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kThreads = kConsumers + 32;
constexpr int kStages = 3;
constexpr int kStageBytes = kRows * 128 + 1024;   // rows, then the queries' 1 KB
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes + 16 * kStages * 2;

template <bool I8>
__global__ void __launch_bounds__(kThreads, 1)
dyn_dma_kernel(const __grid_constant__ CUtensorMap mmap, const __grid_constant__ CUtensorMap qmap,
               const int* __restrict__ offs, int reps, int n_k, float* __restrict__ out) {
    using Acc = std::conditional_t<I8, int, float>;
    constexpr int KS = I8 ? 128 : 64;   // elements of a k step
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    uint64_t* empty = full + kStages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers / 32);
        }
        fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / kWgThreads;
    const int lane = threadIdx.x % 32;
    if (wg == 2) {   // ---- producer: lane 0 ----
        if (lane != 0) return;
        for (int rep = blockIdx.x, j = 0; rep < reps; rep += gridDim.x) {
            const int off = offs[rep];
            for (int ks = 0; ks < n_k; ++ks, ++j) {
                const int s = j % kStages;
                mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                uint8_t* st = ring + s * kStageBytes;
                mbar_expect_tx(&full[s], kRows * 128 + kQ * 128);
                tma_load_2d(st, &mmap, &full[s], ks * KS, off);
                tma_load_2d(st + 256 * 128, &mmap, &full[s], ks * KS, off + 256);
                tma_load_2d(st + kRows * 128, &qmap, &full[s], ks * KS, 0);
            }
        }
        return;
    }

    // ---- consumers: m64 tile mt of warpgroup wg covers rows 256 wg + 64 mt
    // .. + 63; a thread holds rows rr, rr + 8 and query columns 2 t4, + 1 ----
    const int warp = (threadIdx.x % kWgThreads) / 32, t4 = lane % 4;
    const uint32_t ring_addr = smem_addr(ring);
    Acc acc[4][4];
    int j = 0;
    for (int rep = blockIdx.x; rep < reps; rep += gridDim.x) {
        for (int ks = 0; ks < n_k; ++ks, ++j) {
            const int s = j % kStages;
            const uint32_t st = ring_addr + s * kStageBytes;
            mbar_wait(&full[s], (j / kStages) & 1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    const uint64_t da =
                        gmma_desc(st + (wg * 256 + mt * 64) * 128 + kk * 32, 16, 1024, 1);
                    const uint64_t db = gmma_desc(st + kRows * 128 + kk * 32, 16, 1024, 1);
                    if constexpr (I8)
                        WgmmaSS8<8>::run(acc[mt], da, db, (ks > 0 || kk > 0) ? 1 : 0);
                    else
                        WgmmaSS<8>::run(acc[mt], da, db, (ks > 0 || kk > 0) ? 1 : 0);
                }
            wgmma_commit();
            wgmma_wait<1>();
            if (ks > 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
            }
        }
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            fence_operand(acc[mt]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = wg * 256 + mt * 64 + warp * 16 + lane / 4 + 8 * (e >> 1);
                const int q = 2 * t4 + (e & 1);
                float v;
                if constexpr (I8) v = __int2float_rn(acc[mt][e]);
                else v = acc[mt][e];
                out[((size_t)rep * kQ + q) * kRows + row] = v;
            }
        }
    }
}

// mat [n, d] and q [8, d], both int8 (dtype kInt8) or bf16 (kBFloat16),
// d x itemsize % 16 == 0, 16-byte aligned; offs [reps] int32 device, each
// in [0, n - 512]; out [reps, 8, 512] fp32; grid 0: one CTA an SM, else
// that many CTAs
static int launch(const void* mat, const void* q, const void* offs, int n, int d, int reps,
                  int dtype, int grid, void* out, cudaStream_t stream) {
    const bool i8 = dtype == kInt8;
    if ((dtype != kInt8 && dtype != kBFloat16) || n < kRows || d < 1 || reps < 1 || grid < 0 ||
        (d * (i8 ? 1 : 2)) % 16 != 0 || reinterpret_cast<uintptr_t>(mat) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(q) % 16 != 0)
        return kUnsupported;
    const int esize = i8 ? 1 : 2;
    const CUtensorMapDataType type =
        i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap mm, qm;
    if (!make_map_tiled(&mm, type, esize, mat, d, n, 128 / esize, 256, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map_tiled(&qm, type, esize, q, d, kQ, 128 / esize, kQ, CU_TENSOR_MAP_SWIZZLE_128B))
        return kMapError;
    auto kernel = i8 ? dyn_dma_kernel<true> : dyn_dma_kernel<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    int dev = 0, sms = 1;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    if (grid == 0) grid = sms;
    if (grid > reps) grid = reps;
    const int n_k = ceil_div(d * (i8 ? 1 : 2), 128);
    kernel<<<grid, kThreads, kSmem, stream>>>(mm, qm, static_cast<const int*>(offs), reps, n_k,
                                              static_cast<float*>(out));
    return (int)cudaGetLastError();
}

}  // namespace probe_dyn_dma
}  // namespace rv

extern "C" int rv_probe_dyn_dma(const void* mat, const void* q, const void* offs, int n, int d,
                                int reps, int dtype, int grid, void* out, void* stream) {
    return rv::probe_dyn_dma::launch(mat, q, offs, n, d, reps, dtype, grid, out,
                                     static_cast<cudaStream_t>(stream));
}
