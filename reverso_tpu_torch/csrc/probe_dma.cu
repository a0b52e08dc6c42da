// Hardware probe P1: the device-memory read rate of a TMA ring.
//
// Replaces: scripts/bench_dma.py's kernel (its pl.pallas_call at :57): a
// [N, 1024] bf16 array streamed through a ring of `n_bufs` buffers, each
// tile of `tile` rows fetched as `streams` copies of `sub` = tile /
// streams rows; out [min(8, sub), d] f32 = the max over every sub-tile of
// its first 8 rows (a reduction that keeps the reads alive and costs
// nothing). Rows past the last whole tile are not read.
//
// What bounds it on the H100: the bytes, 2 GiB at 1M x 1024 (0.64 ms at
// the published 3.35 TB/s); the maxima are ~1/64 of an operation a byte.
//
// What the design does about it: a persistent grid of `ctas_per_sm` CTAs
// an SM, each streaming a contiguous run of tiles. A producer lane issues
// TMA loads into a ring of `n_bufs` shared-memory stages of `tile` rows
// (a stage is `streams` boxes of one 3-D map over [rows][d / 256][256], so
// a box carries whole 1024-wide rows: a TMA box has at most 256 elements a
// dimension), with mbarrier completion. A consumer warpgroup reads the
// first rows of each box (16 bytes a thread a row) into a running max and
// releases the stage. The CTAs combine by an atomic max on the fp32 bits
// (common.cuh::atomic_max_f32) into an output the wrapper fills with -inf. The TPU's tiles (1024-4096 rows, 2-8 MB) do not
// fit in 227 KB: the sweep maps them onto stages of 8-64 rows (16-128 KB).
#include "hopper.cuh"

namespace rv {
namespace probe_dma {

using namespace tc;

constexpr int kCols = 256;           // elements of d a box dimension holds
constexpr int kMaxBufs = 8;
constexpr int kConsumers = kWgThreads;
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr int kSmemMax = 232448;

__host__ __device__ inline size_t smem_bytes(int tile, int d, int n_bufs) {
    return 1024 + (size_t)n_bufs * tile * d * 2 + 16 * kMaxBufs;
}

__global__ void __launch_bounds__(kThreads)
stream_max_kernel(const __grid_constant__ CUtensorMap map, int n_tiles, int tile, int n_bufs,
                  int streams, int d, float* __restrict__ out) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const size_t stage_bytes = (size_t)tile * d * 2;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + n_bufs * stage_bytes);
    uint64_t* empty = full + kMaxBufs;
    const int sub = tile / streams;
    const int t0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
    const int t1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
    if (threadIdx.x == 0) {
        for (int s = 0; s < n_bufs; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers / 32);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumers) {   // ---- producer: lane 0 issues the loads ----
        if (threadIdx.x != kConsumers) return;
        for (int t = t0, j = 0; t < t1; ++t, ++j) {
            const int s = j % n_bufs;
            mbar_wait(&empty[s], ((j / n_bufs) & 1) ^ 1);
            mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
            for (int b = 0; b < streams; ++b)
                tma_load_3d(ring + s * stage_bytes + (size_t)b * sub * d * 2, &map, &full[s], 0, 0,
                            t * tile + b * sub);
        }
        return;
    }

    // ---- consumers: thread c owns columns 8c .. 8c + 7 of the first rows ----
    const int rows = sub < 8 ? sub : 8;
    const int c0 = 8 * threadIdx.x;
    const bool active = c0 < d;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = -CUDART_INF_F;
    const int lane = threadIdx.x % 32;
    for (int t = t0, j = 0; t < t1; ++t, ++j) {
        const int s = j % n_bufs;
        mbar_wait(&full[s], (j / n_bufs) & 1);
        if (active) {
            for (int b = 0; b < streams; ++b) {
                const __nv_bfloat16* box = reinterpret_cast<const __nv_bfloat16*>(
                    ring + s * stage_bytes + (size_t)b * sub * d * 2);
#pragma unroll
                for (int r = 0; r < 8; ++r) {
                    if (r >= rows) break;
                    const uint4 v = *reinterpret_cast<const uint4*>(box + (size_t)r * d + c0);
                    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
                    for (int e = 0; e < 8; ++e) acc[r][e] = fmaxf(acc[r][e], __bfloat162float(h[e]));
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (active && t1 > t0) {
        for (int r = 0; r < rows; ++r)
#pragma unroll
            for (int e = 0; e < 8; ++e) atomic_max_f32(out + (size_t)r * d + c0 + e, acc[r][e]);
    }
}

// db [n_tiles * tile.., d] bf16 (d % 256 == 0, d <= 1024, a 16-byte aligned
// base), out [min(8, sub), d] fp32 filled with -inf by the caller
static int launch(const void* db, int n_tiles, int tile, int n_bufs, int streams, int d,
                  int ctas_per_sm, void* out, cudaStream_t stream) {
    if (n_tiles < 1 || tile < 1 || streams < 1 || tile % streams != 0 || tile / streams > 256 ||
        n_bufs < 2 || n_bufs > kMaxBufs || d % kCols != 0 || d > 8 * kConsumers ||
        ctas_per_sm < 1 || reinterpret_cast<uintptr_t>(db) % 16 != 0)
        return kUnsupported;
    const size_t smem = smem_bytes(tile, d, n_bufs);
    if (smem > kSmemMax) return kUnsupported;
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return kMapError;
    CUtensorMap map;
    const long long rows = (long long)n_tiles * tile;
    const cuuint64_t dims[3] = {(cuuint64_t)kCols, (cuuint64_t)(d / kCols), (cuuint64_t)rows};
    const cuuint64_t strides[2] = {(cuuint64_t)kCols * 2, (cuuint64_t)d * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)(d / kCols),
                               (cuuint32_t)(tile / streams)};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(db), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return kMapError;
    cudaError_t err = cudaFuncSetAttribute(stream_max_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 1, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, stream_max_kernel, kThreads,
                                                             smem)) != cudaSuccess)
        return (int)err;
    if (occ < ctas_per_sm) return kUnsupported;   // the CTAs asked for do not fit on an SM
    const int grid = (int)(n_tiles < (long long)ctas_per_sm * sms ? n_tiles : ctas_per_sm * sms);
    stream_max_kernel<<<grid, kThreads, smem, stream>>>(map, n_tiles, tile, n_bufs, streams, d,
                                                        static_cast<float*>(out));
    return (int)cudaGetLastError();
}

}  // namespace probe_dma
}  // namespace rv

extern "C" int rv_probe_dma(const void* db, int n_tiles, int tile, int n_bufs, int streams, int d,
                            int ctas_per_sm, void* out, void* stream) {
    return rv::probe_dma::launch(db, n_tiles, tile, n_bufs, streams, d, ctas_per_sm, out,
                                 static_cast<cudaStream_t>(stream));
}
