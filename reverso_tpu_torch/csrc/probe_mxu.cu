// Hardware probe P2: the tensor cores' sustained rate.
//
// Replaces: scripts/bench_mxu.py's kernel (its pl.pallas_call at :46):
// sum over `iters` steps of A_i B, A_i changed every step, out = the first
// 8 rows of the sum, at M, K, N = 256, 1024, 1024 in bf16 -> fp32, s8 ->
// s32 and f32 -> f32. Here A alternates between two copies, a (even steps)
// and a' (odd steps): a xor 1 in int8 (the TPU kernel's own change, which
// alternates too), a + 1 rounded to the operand type otherwise (the TPU
// kernel adds 1 every step). The TPU's f32 case becomes the port's fp32
// contract: the split mode's six bf16 products of three-part operands
// (csrc/hopper.cuh::split_part), a, a' and B split by the split pass.
//
// What bounds it on the H100: the operations, 2 M K N iters (0.56 s at
// iters = 1024 in bf16 at 989 TFLOP/s; int8 at 1,979; fp32 six bf16
// products, 989 / 6 useful TFLOP/s); the operands are read once (5 MB).
//
// What the design does about it: one CTA an SM, two warpgroups, each
// issuing m64n256 SS-form wgmma products (both operands K-major in
// shared memory, 128-byte swizzle; the split mode's parts 64-byte) into
// 128 accumulator registers, one commit group in flight behind the next.
// The work is (128-row tile of A, 256-column tile of B, one 128-byte K
// chunk: 64 bf16, 128 int8 or 32 split values) x step units, spread evenly
// over the CTAs, so every SM runs; a CTA loads the operands of at most two
// tiles by TMA (a' made from a in shared memory but in the split mode),
// and adds the partial sums of rows 0 .. 7 into the output with device
// atomics (int8: s32 sums wrap modulo 2^32 in any order).
#include <type_traits>

#include "hopper.cuh"

namespace rv {
namespace probe_mxu {

using namespace tc;

constexpr int kModeBf16 = 0, kModeI8 = 1, kModeSplit = 2;   // probes/bench_mxu.py::MODES
constexpr int kThreads = 2 * kWgThreads;
constexpr int kBM = 128, kBN = 256;

// elements of K a tile holds: 128 bytes of bf16 or int8, 64 bytes of each split part
__host__ __device__ constexpr int k_chunk(int mode) {
    return mode == kModeI8 ? 128 : mode == kModeBf16 ? 64 : 32;
}
// bytes of a tile of A (one copy; the split mode's three parts) and of B
__host__ __device__ constexpr int a_bytes(int mode) { return mode == kModeSplit ? 3 * kBM * 64 : kBM * 128; }
__host__ __device__ constexpr int b_bytes(int mode) { return mode == kModeSplit ? 3 * kBN * 64 : kBN * 128; }
__host__ __device__ constexpr int smem_bytes(int mode) {
    return 1024 + 2 * a_bytes(mode) + b_bytes(mode) + 16;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
mxu_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap a2map,
           const __grid_constant__ CUtensorMap bmap, int n_tiles, int k_chunks, long long tiles,
           int iters, int n, void* __restrict__ out_v) {
    constexpr bool I8 = MODE == kModeI8;
    constexpr bool SPLIT = MODE == kModeSplit;
    constexpr int AB = a_bytes(MODE), BB = b_bytes(MODE), KC = k_chunk(MODE);
    using Acc = std::conditional_t<I8, int, float>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* a0 = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* a1 = a0 + AB;
    uint8_t* bt = a1 + AB;
    uint64_t* bar = reinterpret_cast<uint64_t*>(bt + BB);
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / kWgThreads, warp = (threadIdx.x % kWgThreads) / 32;
    const int lane = threadIdx.x % 32, t4 = lane % 4;
    const long long total = tiles * iters;
    const long long u1 = (blockIdx.x + 1) * total / gridDim.x;
    long long u = blockIdx.x * total / gridDim.x;
    const uint32_t a0_addr = smem_addr(a0), a1_addr = smem_addr(a1), b_addr = smem_addr(bt);
    Acc acc[kBN / 2];
    uint32_t phase = 0;
    while (u < u1) {
        const long long tile = u / iters;
        const int it0 = (int)(u % iters);
        const long long ue = min(u1, (tile + 1) * iters);
        const int kc = (int)(tile % k_chunks), ni = (int)(tile / k_chunks % n_tiles);
        const int mi = (int)(tile / k_chunks / n_tiles);
        __syncthreads();   // the last tile's products are done with shared memory
        if (threadIdx.x == 0) {
            mbar_expect_tx(bar, (SPLIT ? 2 * AB : AB) + BB);
            if constexpr (SPLIT) {
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    tma_load_3d(a0 + p * kBM * 64, &amap, bar, kc * KC, mi * kBM, p);
                    tma_load_3d(a1 + p * kBM * 64, &a2map, bar, kc * KC, mi * kBM, p);
                    tma_load_3d(bt + p * kBN * 64, &bmap, bar, kc * KC, ni * kBN, p);
                }
            } else {
                tma_load_2d(a0, &amap, bar, kc * KC, mi * kBM);
                tma_load_2d(bt, &bmap, bar, kc * KC, ni * kBN);
            }
        }
        mbar_wait(bar, phase);
        phase ^= 1;
        if constexpr (!SPLIT) {   // a' from a, element by element (the swizzle moves both alike)
            for (int i = threadIdx.x; i < AB / 16; i += kThreads) {
                uint4 v = reinterpret_cast<const uint4*>(a0)[i];
                uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if constexpr (I8) {
                        w[e] ^= 0x01010101u;
                    } else {
                        __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w[e]);
                        w[e] = pack_bf16(__low2float(h) + 1.f, __high2float(h) + 1.f);
                    }
                }
                reinterpret_cast<uint4*>(a1)[i] = make_uint4(w[0], w[1], w[2], w[3]);
            }
            fence_proxy_async();
        }
        __syncthreads();
        bool first = true;
        for (int it = it0; it < it0 + (int)(ue - u); ++it) {
            const uint32_t abase = (it & 1) ? a1_addr : a0_addr;
            fence_operand(acc);
            wgmma_fence();
            if constexpr (SPLIT) {
#pragma unroll
                for (int t = 0; t < kSplitTerms; ++t)
#pragma unroll
                    for (int kk = 0; kk < 2; ++kk)
                        WgmmaSS<kBN>::run(
                            acc,
                            gmma_desc(abase + split_part(t, 0) * kBM * 64 + wg * 64 * 64 + kk * 32,
                                      16, 512, 2),
                            gmma_desc(b_addr + split_part(t, 1) * kBN * 64 + kk * 32, 16, 512, 2),
                            first && t == 0 && kk == 0 ? 0 : 1);
            } else {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t da = gmma_desc(abase + wg * 64 * 128 + kk * 32, 16, 1024, 1);
                    const uint64_t db = gmma_desc(b_addr + kk * 32, 16, 1024, 1);
                    if constexpr (I8)
                        WgmmaSS8<kBN>::run(acc, da, db, first && kk == 0 ? 0 : 1);
                    else
                        WgmmaSS<kBN>::run(acc, da, db, first && kk == 0 ? 0 : 1);
                }
            }
            wgmma_commit();
            fence_operand(acc);
            wgmma_wait<1>();
            first = false;
        }
        wgmma_wait<0>();
        fence_operand(acc);
        // rows 0 .. 7 of the output: warp 0 of warpgroup 0, registers j with
        // (j >> 1) & 1 == 0 (row lane / 4), column 8 (j / 4) + 2 t4 + (j & 1)
        if (mi == 0 && wg == 0 && warp == 0) {
#pragma unroll
            for (int j = 0; j < kBN / 2; ++j) {
                if ((j >> 1) & 1) continue;
                const size_t o = (size_t)(lane / 4) * n + ni * kBN + 8 * (j / 4) + 2 * t4 + (j & 1);
                atomicAdd(static_cast<Acc*>(out_v) + o, acc[j]);
            }
        }
        u = ue;
    }
}

template <int MODE>
static int launch_mode(const void* a, const void* a2, const void* bt, int M, int K, int N,
                       int iters, void* out, cudaStream_t stream) {
    constexpr int kEsize = MODE == kModeI8 ? 1 : 2;
    constexpr CUtensorMapDataType kType =
        MODE == kModeI8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    CUtensorMap am, a2m, bm;
    bool ok;
    if (MODE == kModeSplit)
        ok = make_map_parts(&am, a, K, M, kBM) && make_map_parts(&a2m, a2, K, M, kBM) &&
             make_map_parts(&bm, bt, K, N, kBN);
    else
        ok = make_map_tiled(&am, kType, kEsize, a, K, M, 128 / kEsize, kBM,
                            CU_TENSOR_MAP_SWIZZLE_128B) &&
             make_map_tiled(&bm, kType, kEsize, bt, K, N, 128 / kEsize, kBN,
                            CU_TENSOR_MAP_SWIZZLE_128B);
    if (!ok) return kMapError;
    if (MODE != kModeSplit) a2m = am;   // unused
    auto kernel = mxu_kernel<MODE>;
    constexpr int smem = smem_bytes(MODE);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 1;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    const int n_tiles = N / kBN, k_chunks = K / k_chunk(MODE);
    const long long tiles = (long long)(M / kBM) * n_tiles * k_chunks;
    const long long units = tiles * iters;
    const int grid = (int)(units < sms ? units : sms);
    kernel<<<grid, kThreads, smem, stream>>>(am, a2m, bm, n_tiles, k_chunks, tiles, iters, N, out);
    return (int)cudaGetLastError();
}

// bf16 / int8: a [M, K], bt = B^T [N, K], a2 unused; split: a, a2 = a' and
// bt the split pass's parts [3, M | N, K] (K the pitch). out [8, N], fp32
// (s32 in int8) and zero. M % 128, N % 256 and K % (the mode's chunk) == 0.
static int launch(const void* a, const void* a2, const void* bt, int M, int K, int N, int iters,
                  int mode, void* out, cudaStream_t stream) {
    if (mode < kModeBf16 || mode > kModeSplit || M < kBM || M % kBM != 0 || N % kBN != 0 ||
        N < kBN || K < k_chunk(mode) || K % k_chunk(mode) != 0 || iters < 1 ||
        (mode == kModeSplit && a2 == nullptr))
        return kUnsupported;
    if (mode == kModeBf16) return launch_mode<kModeBf16>(a, a2, bt, M, K, N, iters, out, stream);
    if (mode == kModeI8) return launch_mode<kModeI8>(a, a2, bt, M, K, N, iters, out, stream);
    return launch_mode<kModeSplit>(a, a2, bt, M, K, N, iters, out, stream);
}

}  // namespace probe_mxu
}  // namespace rv

extern "C" int rv_probe_mxu(const void* a, const void* a2, const void* bt, int M, int K, int N,
                            int iters, int mode, void* out, void* stream) {
    return rv::probe_mxu::launch(a, a2, bt, M, K, N, iters, mode, out,
                                 static_cast<cudaStream_t>(stream));
}
