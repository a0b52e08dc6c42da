// Fused transformer MLP: y = act(x @ W1^T + b1) @ W2^T + b2.
//
// Replaces: reverso_tpu/ops/fused_mlp.py::_fused_mlp_kernel (entry
// fused_mlp), the MLP of every ViT block. Weights come in PyTorch Linear
// layout: W1 [H, W], W2 [W, H].
//
// What bounds it on the H100: 4 * T * W * H FLOPs (77.4 GFLOP at T = 4616,
// PE-L14's 1024 -> 4096 -> 1024: 0.078 ms at 989 TFLOP/s) against 2 * T * W
// activation elements and 2 * W * H weight elements (27.6 MB, 0.008 ms at
// 3.35 TB/s). So it is compute-bound, and the rate comes from the tensor
// cores.
//
// Three kernels, chosen by dtype and shape (ops/fused_mlp.py::mlp_route):
//   * bf16 with W % 8 == 0 and H % 8 == 0 (every preset): two launches of
//     one wgmma + TMA GEMM kernel with fused epilogues (rv_fused_mlp_tc,
//     below), h = bf16(act(x W1^T + b1)) written to a bf16 scratch and read
//     back by the second product;
//   * fp32 (the parity mode) and bf16 at other widths (rv_fused_mlp): one
//     CTA owns BM = 32 rows (16 at wider W) and the full output width in
//     an fp32 accumulator in shared memory (128 KB at W = 1024); the hidden
//     dimension streams in 64-wide chunks, each computing h = act(x_tile @
//     W1[c]^T + b1[c]) with fp32 FMAs on the CUDA cores, rounded to T like
//     the reference, and adding h @ W2[:, c]^T into the accumulator, so the
//     [T, H] hidden tensor never reaches HBM;
//   * the int8 mode (K5, rv_fused_mlp_int8), further below.
// gelu is the exact erf form (erff); the reference kernel's A&S polynomial
// differs from it by at most 1.5e-7 in erf.
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace rv {

constexpr int MLP_THREADS = 256;
constexpr int MLP_BH = 64;    // hidden chunk
constexpr int MLP_BK = 32;    // reduction step of the first product
constexpr int MLP_BN = 128;   // output-column block of the second product

constexpr int kGelu = 0;
constexpr int kQuickGelu = 1;

__device__ __forceinline__ float mlp_act(float x, int act) {
    if (act == kGelu) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    return x / (1.f + expf(-1.702f * x));   // quick_gelu: x * sigmoid(1.702 x)
}

template <int BM>
constexpr size_t mlp_smem_floats_fixed() {
    return (size_t)BM * MLP_BH + (size_t)BM * (MLP_BK + 1) +
           (size_t)MLP_BH * (MLP_BK + 1) + (size_t)MLP_BH * (MLP_BN + 1);
}

template <typename T, int BM>
__global__ void __launch_bounds__(MLP_THREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int T_rows,
                 int W, int H, int act) {
    constexpr int RM1 = BM / 16;   // rows per thread, first product
    constexpr int RM2 = BM / 8;    // rows per thread, second product
    extern __shared__ float smem[];
    float* acc = smem;                              // [BM][W]
    float* hs = acc + (size_t)BM * W;               // [BM][BH]
    float* xs = hs + BM * MLP_BH;                   // [BM][BK+1]
    float* w1s = xs + BM * (MLP_BK + 1);            // [BH][BK+1]
    float* w2s = w1s + MLP_BH * (MLP_BK + 1);       // [BH][BN+1]

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * BM;
    const int tr1 = tid / 16, tc1 = tid % 16;
    const int tr2 = tid / 32, tc2 = tid % 32;

    for (int idx = tid; idx < BM * W; idx += MLP_THREADS) acc[idx] = 0.f;

    for (int c0 = 0; c0 < H; c0 += MLP_BH) {
        // ---- h = act(x_tile @ W1[c0:c0+BH]^T + b1) -------------------------
        float hacc[RM1][4];
#pragma unroll
        for (int i = 0; i < RM1; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) hacc[i][j] = 0.f;
        for (int k0 = 0; k0 < W; k0 += MLP_BK) {
            __syncthreads();
            for (int idx = tid; idx < BM * MLP_BK; idx += MLP_THREADS) {
                const int r = idx / MLP_BK, kk = idx % MLP_BK;
                const int gr = row0 + r, gk = k0 + kk;
                xs[r * (MLP_BK + 1) + kk] =
                    (gr < T_rows && gk < W) ? to_f<T>(x[(size_t)gr * W + gk]) : 0.f;
            }
            for (int idx = tid; idx < MLP_BH * MLP_BK; idx += MLP_THREADS) {
                const int c = idx / MLP_BK, kk = idx % MLP_BK;
                const int gc = c0 + c, gk = k0 + kk;
                w1s[c * (MLP_BK + 1) + kk] =
                    (gc < H && gk < W) ? to_f<T>(w1[(size_t)gc * W + gk]) : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < MLP_BK; ++kk) {
                float a[RM1], bcol[4];
#pragma unroll
                for (int i = 0; i < RM1; ++i) a[i] = xs[(tr1 * RM1 + i) * (MLP_BK + 1) + kk];
#pragma unroll
                for (int j = 0; j < 4; ++j) bcol[j] = w1s[(tc1 + 16 * j) * (MLP_BK + 1) + kk];
#pragma unroll
                for (int i = 0; i < RM1; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) hacc[i][j] = fmaf(a[i], bcol[j], hacc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < RM1; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tc1 + 16 * j;
                const int gc = c0 + c;
                float hv = 0.f;
                if (gc < H) hv = round_t<T>(mlp_act(hacc[i][j] + to_f<T>(b1[gc]), act));
                hs[(tr1 * RM1 + i) * MLP_BH + c] = hv;
            }

        // ---- acc += h @ W2[:, c0:c0+BH]^T ----------------------------------
        for (int nb = 0; nb < W; nb += MLP_BN) {
            __syncthreads();   // hs written / previous w2s consumed
            for (int idx = tid; idx < MLP_BN * MLP_BH; idx += MLP_THREADS) {
                const int n = idx / MLP_BH, c = idx % MLP_BH;
                const int gn = nb + n, gc = c0 + c;
                w2s[c * (MLP_BN + 1) + n] =
                    (gn < W && gc < H) ? to_f<T>(w2[(size_t)gn * H + gc]) : 0.f;
            }
            __syncthreads();
            float pacc[RM2][4];
#pragma unroll
            for (int i = 0; i < RM2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) pacc[i][j] = 0.f;
#pragma unroll 8
            for (int c = 0; c < MLP_BH; ++c) {
                float a[RM2], bcol[4];
#pragma unroll
                for (int i = 0; i < RM2; ++i) a[i] = hs[(tr2 * RM2 + i) * MLP_BH + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) bcol[j] = w2s[c * (MLP_BN + 1) + tc2 + 32 * j];
#pragma unroll
                for (int i = 0; i < RM2; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) pacc[i][j] = fmaf(a[i], bcol[j], pacc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < RM2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int gn = nb + tc2 + 32 * j;
                    if (gn < W) acc[(size_t)(tr2 * RM2 + i) * W + gn] += pacc[i][j];
                }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < BM * W; idx += MLP_THREADS) {
        const int r = idx / W, n = idx % W;
        const int gr = row0 + r;
        if (gr < T_rows) out[(size_t)gr * W + n] = from_f<T>(acc[idx] + to_f<T>(b2[n]));
    }
}

template <typename T, int BM>
static int launch_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int T_rows, int W, int H, int act,
                            cudaStream_t stream) {
    const size_t smem = ((size_t)BM * W + mlp_smem_floats_fixed<BM>()) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel<T, BM><<<ceil_div(T_rows, BM), MLP_THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(out), T_rows, W, H, act);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_bm(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int T_rows,
                       int W, int H, int act, cudaStream_t stream) {
    // the widest row tile whose accumulator fits the 227 KB a block may use
    constexpr size_t kMaxSmem = 232448;
    if (((size_t)32 * W + mlp_smem_floats_fixed<32>()) * sizeof(float) <= kMaxSmem)
        return launch_fused_mlp<T, 32>(x, w1, b1, w2, b2, out, T_rows, W, H, act, stream);
    if (((size_t)16 * W + mlp_smem_floats_fixed<16>()) * sizeof(float) <= kMaxSmem)
        return launch_fused_mlp<T, 16>(x, w1, b1, w2, b2, out, T_rows, W, H, act, stream);
    return kUnsupported;
}

// ---- bf16 on the tensor cores: two wgmma GEMMs -------------------------------
//
// The MLP as two launches of one hand-written GEMM kernel, C = epilogue(A
// B^T), A [M, K] and B [N, K] bf16 row-major, so both operands are K-major
// (PyTorch's Linear layout: no transposes):
//   GEMM 1: h = bf16(act(x W1^T + b1)), [T, H], scratch the wrapper allocates;
//   GEMM 2: y = bf16(h W2^T + b2), [T, W].
// The reference rounds h to bf16 before the second product too
// (reverso_tpu/ops/fused_mlp.py:81), so its round trip through device
// memory changes no result; it costs 2 * T * H * 2 bytes (75.6 MB at
// T = 4616, H = 4096: 0.023 ms at 3.35 TB/s against the products' 0.078 ms
// at 989 TFLOP/s), and the products, not the bytes, bound the MLP.
//
// Design of one CTA (one 128 x BN tile of C):
//   * a producer warp, one thread of which brings 128 x 64 A tiles and
//     BN x 64 B tiles through TMA (2-D tensor maps, 128-byte swizzle,
//     mbarrier completion) into a ring of STAGES stages; rows past M (T =
//     4616 = 36 * 128 + 8), columns past N and a K past the last whole
//     step read zeros from the hardware, so nothing is padded in memory;
//   * two consumer warpgroups of 64 rows each run wgmma m64nBNk16 (bf16 in,
//     fp32 accumulate, both operands from shared memory) over the ring,
//     with one product group in flight while the stage before it is
//     released to the producer;
//   * a consumer's accumulator takes BN / 2 registers a thread (ptxas: 154
//     registers a thread at BN = 256, 90 at BN = 128, no spills);
//   * the epilogue parks the fp32 tile in the ring's shared memory, then
//     each thread adds the fp32 bias to 8 adjacent columns of a row,
//     applies the activation (GEMM 1), rounds to bf16 and stores 16 bytes;
//     rows past M and columns past N are masked. (Applying the activation
//     straight from the accumulator fragments unrolled erff over all 128
//     registers of a thread: GEMM 1 took 0.227 ms at T = 4616 against 0.101
//     without the activation, scripts/mlp_tc_probe.py on the H100.)
namespace mlp_tc {

using namespace tc;

constexpr int kBM = 128;     // rows of a CTA tile: two consumer warpgroups of 64
constexpr int kBK = 64;      // reduction step: one 128-byte swizzle atom of bf16
constexpr int kNoAct = -1;   // GEMM 2: the bias only

constexpr int kThreads = 2 * kWgThreads + 32;   // two consumer warpgroups, one producer warp

// A tile shape: BN output columns, a ring of STAGES stages
template <int BN, int STAGES>
struct GemmCfg {
    static constexpr int kBN = BN, kStages = STAGES;
    static constexpr int A_BYTES = kBM * kBK * 2;
    static constexpr int B_BYTES = BN * kBK * 2;
    static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) + 16 * STAGES;
    static_assert(SMEM <= 232448, "shared memory of a CTA");
    static_assert(BN % 64 == 0 && BN <= 256, "wgmma N and the TMA box");
};

// gelu through the Abramowitz & Stegun 7.1.26 erf (|err| <= 1.5e-7), as the
// TPU kernel computes it (reverso_tpu/ops/fused_mlp.py:47), with the SFU's
// reciprocal and exponential; quick_gelu as x * sigmoid(1.702 x). Within a
// few 1e-7 of the exact forms, far below h's bf16 rounding.
__device__ __forceinline__ float act_fast(float x, int act) {
    if (act == kQuickGelu) return x * __fdividef(1.f, 1.f + __expf(-1.702f * x));
    const float z = x * 0.70710678118654752f, az = fabsf(z);
    const float t = __fdividef(1.f, fmaf(0.3275911f, az, 1.f));
    float poly = fmaf(t, 1.061405429f, -1.453152027f);
    poly = fmaf(t, poly, 1.421413741f);
    poly = fmaf(t, poly, -0.284496736f);
    poly = fmaf(t, poly, 0.254829592f) * t;
    const float erf = copysignf(fmaf(-poly, __expf(-az * az), 1.f), z);
    const float hx = 0.5f * x;
    return fmaf(hx, erf, hx);
}

template <class Cfg>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ c,
                       int m, int n, int k, int act) {
    constexpr int BN = Cfg::kBN, STAGES = Cfg::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* as = base;                           // [STAGES][128][64] bf16, swizzled
    uint8_t* bs = as + STAGES * Cfg::A_BYTES;     // [STAGES][BN][64]
    uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * Cfg::B_BYTES);
    uint64_t* empty = full + STAGES;              // the consumers' 8 warps are done

    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
    const int n_k = ceil_div(k, kBK);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer warp: lane 0 keeps the ring full ----
        if (tid == 0) {
            for (int j = 0; j < n_k; ++j) {
                const int s = j % STAGES;
                mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], Cfg::A_BYTES + Cfg::B_BYTES);
                tma_load_2d(as + s * Cfg::A_BYTES, &amap, &full[s], j * kBK, m0);
                tma_load_2d(bs + s * Cfg::B_BYTES, &bmap, &full[s], j * kBK, n0);
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a0 = smem_addr(as) + wg * 64 * kBK * 2;
    const uint32_t b0 = smem_addr(bs);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)   // k16 steps: 32 bytes into the swizzled rows
            WgmmaSS<BN>::run(acc, gmma_desc(a0 + s * Cfg::A_BYTES + kk * 32, 16, 1024, 1),
                             gmma_desc(b0 + s * Cfg::B_BYTES + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();   // step j - 1's products are done: release its stage
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
        }
    }
    wgmma_wait<0>();
    fence_operand(acc);

    // ---- epilogue ----
    // (1) both consumer warpgroups are done with the ring (every stage was
    // loaded and consumed), so it takes the fp32 tile, [128][BN + 8] (the
    // pad keeps a warp's fragment stores off shared bank conflicts)
    constexpr int LDC = BN + 8;
    static_assert(kBM * LDC * 4 <= STAGES * (Cfg::A_BYTES + Cfg::B_BYTES), "C tile fits the ring");
    float* ct = reinterpret_cast<float*>(base);
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = wg * 64 + warp * 16 + lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int col = 8 * i + 2 * t;
            *reinterpret_cast<float2*>(ct + r * LDC + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
            *reinterpret_cast<float2*>(ct + (r + 8) * LDC + col) =
                make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // (2) each thread takes 8 adjacent columns of a row at a time: fp32 bias,
    // activation, bf16, one 16-byte store (a warp writes whole row
    // segments); a short loop, so the activation's code stays small
    constexpr int TPR = BN / 8;                 // threads per row
    constexpr int ROWS = 2 * kWgThreads / TPR;  // rows per pass
    const int ctid = wg * kWgThreads + tid;
    const int c8 = (ctid % TPR) * 8, col = n0 + c8;
    if (col >= n) return;   // n % 8 == 0: a group of 8 is in or out whole
    float bv[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 b2 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col + 2 * e));
        bv[2 * e] = b2.x;
        bv[2 * e + 1] = b2.y;
    }
#pragma unroll 2
    for (int r = ctid / TPR; r < kBM && m0 + r < m; r += ROWS) {
        const float4 lo = *reinterpret_cast<const float4*>(ct + r * LDC + c8);
        const float4 hi = *reinterpret_cast<const float4*>(ct + r * LDC + c8 + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            v[e] += bv[e];
            if (act != kNoAct) v[e] = act_fast(v[e], act);
        }
        uint4 out;
        out.x = pack_bf16(v[0], v[1]);
        out.y = pack_bf16(v[2], v[3]);
        out.z = pack_bf16(v[4], v[5]);
        out.w = pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(c + (size_t)(m0 + r) * n + col) = out;
    }
}

// a 2-D bf16 map over [rows][cols] (cols contiguous, cols % 8 == 0), box
// [box_rows][64], 128-byte swizzle as the wgmma descriptors read it;
// out-of-bounds elements read zero
static bool make_map_2d(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [m, n] = epilogue(A [m, k] B [n, k]^T) with one tile config
template <class Cfg>
static int launch_gemm(const void* a, const void* b, const void* bias, void* c, int m, int n,
                       int k, int act, cudaStream_t stream) {
    CUtensorMap am, bm;
    if (!make_map_2d(&am, a, k, m, kBM) || !make_map_2d(&bm, b, k, n, Cfg::kBN))
        return kMapError;
    auto kernel = fused_mlp_wgmma_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(n, Cfg::kBN), ceil_div(m, kBM));
    kernel<<<grid, kThreads, Cfg::SMEM, stream>>>(
        am, bm, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(c), m, n,
        k, act);
    return (int)cudaGetLastError();
}

// Tiles (measured on the H100 with scripts/mlp_tc_probe.py; PERF.md has
// the times): 128 x 256 where that grid fills the 132 SMs at least four
// times over (the wider tile reads fewer operand bytes from L2 per
// product), 128 x 128 otherwise (more CTAs, fewer idle SMs in the last
// wave). PE-L14 at T = 4616: GEMM 1 (N = 4096) has 592 wide tiles and
// takes them; GEMM 2 (N = 1024) would have only 148, 1.12 waves, and takes
// 296 narrow ones; at T = 36,928 (B = 64) both take wide tiles.
using GemmWide = GemmCfg<256, 4>;
using GemmNarrow = GemmCfg<128, 4>;

static int launch_mlp_gemm(const void* a, const void* b, const void* bias, void* c, int m,
                           int n, int k, int act, cudaStream_t stream) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const long long wide_tiles = (long long)ceil_div(m, kBM) * ceil_div(n, GemmWide::kBN);
    if (wide_tiles >= 4LL * sms)
        return launch_gemm<GemmWide>(a, b, bias, c, m, n, k, act, stream);
    return launch_gemm<GemmNarrow>(a, b, bias, c, m, n, k, act, stream);
}

}  // namespace mlp_tc

// 16-byte asynchronous global->shared copy; `ok == false` zero-fills the
// destination without reading (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// ---- int8 variant (K5) ------------------------------------------------------
//
// Replaces: reverso_tpu/ops/fused_mlp.py::_fused_mlp_int8_kernel (entry
// fused_mlp(quant=True), ModelConfig.quant="int8"). x [T, W] (bf16 or fp32)
// is quantized per row, W1 [Hp, Wp] and W2 [Wn, Hp] arrive quantized per
// output unit and zero-padded (ops/fused_mlp.py::_kernel_weights), s1/s2
// are their f32 scales, b1/b2 the dtype-rounded biases in f32.
//
// What bounds it on the H100: 4 * T * W * H int8 operations (77.4 G at
// T = 4616, W = 1024, H = 4096: 0.039 ms at 1979 TOP/s) against 2 * T * W
// activation elements and 2 * W * H weight bytes: operations.
//
// What the design does about it:
//   * one CTA owns BM = 32 rows (16 for W > 1024): it quantizes its x rows
//     once into shared memory (per-row amax, `127 / amax` divided once,
//     round half to even, clamp to +-127) and keeps a [BM, W] fp32
//     accumulator there (128 KB at W = 1024);
//   * the hidden dimension streams in 512-wide chunks, the reference's
//     re-quantization unit: s8 tensor-core products (WMMA 16x16x16, s32
//     accumulate) of the resident x8 against W1 tiles streaming through a
//     two-stage cp.async ring give the chunk's exact s32 h; each element is
//     dequantized as f32(s32) * (xs * s1) + b1, activated, and parked as
//     fp32 in shared memory (64 KB), so each row's amax over the chunk is
//     exact before the chunk is re-quantized to int8;
//   * the second product streams W2 tiles the same way, 128 output columns
//     at a time; each warp owns one 16-column slice, dequantizes its s32
//     tile and adds it to the accumulator as acc + f32(s32) * (hs * s2);
//   * every multiply and add is written __fmul_rn / __fadd_rn: nvcc would
//     contract a*b+c into one FMA, one rounding fewer than the reference,
//     and an ulp at a rounding boundary flips an int8 quantum;
//   * gelu is the Abramowitz & Stegun erf polynomial of the reference's
//     int8 kernel, not erff (they differ by up to 1.5e-7);
//   * shared memory is one union for the W1 ring, the fp32 h chunk and
//     (h8, the W2 ring, the per-warp s32 tiles): 230 KB at BM = 32,
//     W = 1024, so one CTA per SM. No wgmma, no TMA: a simple kernel.
constexpr int Q8_CHUNK = 512;            // hidden re-quantization unit
constexpr int Q8_LDH = Q8_CHUNK + 4;     // fp32 row stride of the h chunk
constexpr int Q8_BK1 = 64;               // bytes of W per first-product stage
constexpr int Q8_BN = 128;               // output columns per second-product block
constexpr int Q8_BK2 = 128;              // hidden bytes per second-product stage
constexpr int Q8_WARPS = MLP_THREADS / 32;
constexpr int Q8_STAGE1 = Q8_CHUNK * Q8_BK1;   // bytes
constexpr int Q8_STAGE2 = Q8_BN * Q8_BK2;      // bytes

// the reference's constants, as its Python floats rounded to f32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kSqrtHalf = static_cast<float>(0.7071067811865476);
constexpr float kErfP = static_cast<float>(0.3275911);
constexpr float kErfA1 = static_cast<float>(0.254829592);
constexpr float kErfA2 = static_cast<float>(-0.284496736);
constexpr float kErfA3 = static_cast<float>(1.421413741);
constexpr float kErfA4 = static_cast<float>(-1.453152027);
constexpr float kErfA5 = static_cast<float>(1.061405429);
constexpr float kQuickGeluScale = static_cast<float>(1.702);

__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }

// gelu with erf from A&S 7.1.26, op for op as the reference: every product
// and sum rounded on its own
__device__ __forceinline__ float gelu_as(float x) {
    const float z = __fmul_rn(x, kSqrtHalf);
    const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
    const float az = fabsf(z);
    const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(kErfP, az)));
    float p = __fadd_rn(kErfA4, __fmul_rn(t, kErfA5));
    p = __fadd_rn(kErfA3, __fmul_rn(t, p));
    p = __fadd_rn(kErfA2, __fmul_rn(t, p));
    p = __fadd_rn(kErfA1, __fmul_rn(t, p));
    p = __fmul_rn(t, p);
    const float erf = __fmul_rn(sign, __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-az, az)))));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

__device__ __forceinline__ float q8_act(float x, int act) {
    if (act == kGelu) return gelu_as(x);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(kQuickGeluScale, x))));
    return __fmul_rn(x, sig);
}

// round(v * inv) half to even, clamped to +-127
__device__ __forceinline__ int quant8(float v, float inv) {
    return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

struct Q8Layout {   // byte offsets into dynamic shared memory
    size_t acc, xq, xs, hs, hinv, u, total;
};

__host__ __device__ inline Q8Layout q8_layout(int BM, int W) {
    Q8Layout L;
    size_t o = 0;
    L.acc = o;  o += align128((size_t)BM * W * sizeof(float));
    L.xq = o;   o += align128((size_t)BM * round_up(W, Q8_BK1));
    L.xs = o;   o += align128(BM * sizeof(float));
    L.hs = o;   o += align128(BM * sizeof(float));
    L.hinv = o; o += align128(BM * sizeof(float));
    // union: the W1 ring | the fp32 h chunk | h8 + the W2 ring + s32 tiles
    const size_t u1 = 2 * (size_t)Q8_STAGE1;
    const size_t u2 = (size_t)BM * Q8_LDH * sizeof(float);
    const size_t u3 = (size_t)BM * Q8_CHUNK + 2 * (size_t)Q8_STAGE2 +
                      (size_t)Q8_WARPS * BM * 16 * sizeof(int);
    L.u = o;    o += align128(u1 > u2 ? (u1 > u3 ? u1 : u3) : (u2 > u3 ? u2 : u3));
    L.total = o;
    return L;
}

// W1[c0 : c0+CHUNK, k0 : k0+BK1] -> one stage, [BK1/16][CHUNK][16 B]
__device__ __forceinline__ void q8_load_w1(signed char* st, const signed char* w1,
                                           int c0, int k0, int Wp, int tid) {
    for (int v = tid; v < Q8_CHUNK * (Q8_BK1 / 16); v += MLP_THREADS) {
        const int n = v / (Q8_BK1 / 16), kc = v % (Q8_BK1 / 16);
        cp_async16(st + ((size_t)kc * Q8_CHUNK + n) * 16,
                   w1 + (size_t)(c0 + n) * Wp + k0 + kc * 16, true);
    }
    cp_async_commit();
}

// W2[n0 : n0+BN, h0 : h0+BK2] -> one stage, [BK2/16][BN][16 B]
__device__ __forceinline__ void q8_load_w2(signed char* st, const signed char* w2,
                                           int n0, int h0, int Hp, int tid) {
    for (int v = tid; v < Q8_BN * (Q8_BK2 / 16); v += MLP_THREADS) {
        const int n = v / (Q8_BK2 / 16), kc = v % (Q8_BK2 / 16);
        cp_async16(st + ((size_t)kc * Q8_BN + n) * 16,
                   w2 + (size_t)(n0 + n) * Hp + h0 + kc * 16, true);
    }
    cp_async_commit();
}

template <typename T, int BM>
__global__ void __launch_bounds__(MLP_THREADS)
fused_mlp_int8_kernel(const T* __restrict__ x, const signed char* __restrict__ w1,
                      const float* __restrict__ s1, const float* __restrict__ b1,
                      const signed char* __restrict__ w2, const float* __restrict__ s2,
                      const float* __restrict__ b2, T* __restrict__ out, int T_rows,
                      int W, int H, int act) {
    using namespace nvcuda;
    constexpr int RF = BM / 16;                                // row fragments
    constexpr int NG = BM * Q8_CHUNK / 4 / MLP_THREADS;        // 4-byte groups per thread
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const Q8Layout L = q8_layout(BM, W);
    const int Wp = round_up(W, Q8_BK1), Hp = round_up(H, Q8_CHUNK), Wn = round_up(W, Q8_BN);
    float* acc = reinterpret_cast<float*>(smem_raw + L.acc);               // [BM][W]
    signed char* xq = reinterpret_cast<signed char*>(smem_raw + L.xq);     // [Wp/16][BM][16]
    float* xs = reinterpret_cast<float*>(smem_raw + L.xs);
    float* hs = reinterpret_cast<float*>(smem_raw + L.hs);
    float* hinv = reinterpret_cast<float*>(smem_raw + L.hinv);
    unsigned char* u = smem_raw + L.u;
    signed char* w1st = reinterpret_cast<signed char*>(u);                 // 2 W1 stages
    int* h32 = reinterpret_cast<int*>(u);                                  // [BM][LDH]
    float* hf = reinterpret_cast<float*>(u);                               // [BM][LDH]
    signed char* hq = reinterpret_cast<signed char*>(u);                   // [CHUNK/16][BM][16]
    signed char* w2st = hq + BM * Q8_CHUNK;                                // 2 W2 stages
    int* ytile = reinterpret_cast<int*>(w2st + 2 * Q8_STAGE2);             // [warps][BM][16]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = blockIdx.x * BM;

    for (int idx = tid; idx < BM * W; idx += MLP_THREADS) acc[idx] = 0.f;
    // x rows -> int8, one warp per row
    for (int r = warp; r < BM; r += Q8_WARPS) {
        const int gr = row0 + r;
        const T* xr = x + (size_t)gr * W;
        float amax = 0.f;
        if (gr < T_rows)
            for (int c = lane; c < W; c += 32) amax = fmaxf(amax, fabsf(to_f<T>(xr[c])));
        amax = fmaxf(warp_max(amax), 1e-30f);
        const float inv = __fdiv_rn(127.f, amax);
        if (lane == 0) xs[r] = __fmul_rn(amax, kInv127);
        for (int c = lane; c < Wp; c += 32) {
            const float v = (gr < T_rows && c < W) ? to_f<T>(xr[c]) : 0.f;
            xq[((c / 16) * BM + r) * 16 + c % 16] = static_cast<signed char>(quant8(v, inv));
        }
    }

    const int nK1 = Wp / Q8_BK1;
    const int nK2 = Q8_CHUNK / Q8_BK2;
    const int steps2 = (Wn / Q8_BN) * nK2;
    for (int c0 = 0; c0 < Hp; c0 += Q8_CHUNK) {
        // ---- h32 = x8 @ W1[c0:c0+CHUNK]^T: warp w owns hidden columns w*64.. ---
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> hfr[RF][4];
#pragma unroll
        for (int fr = 0; fr < RF; ++fr)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::fill_fragment(hfr[fr][j], 0);
        __syncthreads();   // x8 written; the last chunk is done with the union
        q8_load_w1(w1st, w1, c0, 0, Wp, tid);
        for (int s = 0; s < nK1; ++s) {
            if (s + 1 < nK1) {
                q8_load_w1(w1st + ((s + 1) & 1) * Q8_STAGE1, w1, c0, (s + 1) * Q8_BK1, Wp, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const signed char* st = w1st + (s & 1) * Q8_STAGE1;
#pragma unroll
            for (int kc = 0; kc < Q8_BK1 / 16; ++kc) {
                const int gkc = s * (Q8_BK1 / 16) + kc;
                wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> afr[RF];
#pragma unroll
                for (int fr = 0; fr < RF; ++fr)
                    wmma::load_matrix_sync(afr[fr], xq + ((size_t)gkc * BM + fr * 16) * 16, 16);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr;
                    wmma::load_matrix_sync(
                        bfr, st + ((size_t)kc * Q8_CHUNK + (warp * 4 + j) * 16) * 16, 16);
#pragma unroll
                    for (int fr = 0; fr < RF; ++fr)
                        wmma::mma_sync(hfr[fr][j], afr[fr], bfr, hfr[fr][j]);
                }
            }
            __syncthreads();   // this stage is refilled two steps later
        }
#pragma unroll
        for (int fr = 0; fr < RF; ++fr)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::store_matrix_sync(h32 + fr * 16 * Q8_LDH + (warp * 4 + j) * 16,
                                        hfr[fr][j], Q8_LDH, wmma::mem_row_major);
        __syncthreads();
        // ---- dequantize, bias, activation, in place as fp32 -------------------
        for (int idx = tid; idx < BM * Q8_CHUNK; idx += MLP_THREADS) {
            const int r = idx / Q8_CHUNK, c = idx % Q8_CHUNK, gc = c0 + c;
            const int o = r * Q8_LDH + c;
            float v = 0.f;
            if (gc < H) {
                v = __fmul_rn(__int2float_rn(h32[o]), __fmul_rn(xs[r], s1[gc]));
                v = q8_act(__fadd_rn(v, b1[gc]), act);
            }
            hf[o] = v;
        }
        __syncthreads();
        // ---- each row's amax over the chunk -> its scale and inverse ----------
        for (int r = warp; r < BM; r += Q8_WARPS) {
            float m = 0.f;
            for (int c = lane; c < Q8_CHUNK; c += 32) m = fmaxf(m, fabsf(hf[r * Q8_LDH + c]));
            m = fmaxf(warp_max(m), 1e-30f);
            if (lane == 0) {
                hs[r] = __fmul_rn(m, kInv127);
                hinv[r] = __fdiv_rn(127.f, m);
            }
        }
        __syncthreads();
        // ---- h -> int8 in registers, then over the fp32 chunk as h8 ----------
        unsigned packed[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            const int e = (tid + g * MLP_THREADS) * 4;
            const int r = e / Q8_CHUNK, c = e % Q8_CHUNK;
            const float4 v = *reinterpret_cast<const float4*>(hf + r * Q8_LDH + c);
            const float inv = hinv[r];
            packed[g] = (quant8(v.x, inv) & 0xff) | ((quant8(v.y, inv) & 0xff) << 8) |
                        ((quant8(v.z, inv) & 0xff) << 16) |
                        (static_cast<unsigned>(quant8(v.w, inv) & 0xff) << 24);
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            const int e = (tid + g * MLP_THREADS) * 4;
            const int r = e / Q8_CHUNK, c = e % Q8_CHUNK;
            *reinterpret_cast<unsigned*>(hq + ((c / 16) * BM + r) * 16 + c % 16) = packed[g];
        }
        // ---- acc += dequant(h8 @ W2[:, c0:c0+CHUNK]^T): warp w owns columns
        //      w*16.. of each 128-wide block ---------------------------------
        q8_load_w2(w2st, w2, 0, c0, Hp, tid);
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> yfr[RF];
        int* yt = ytile + warp * BM * 16;
        for (int g = 0; g < steps2; ++g) {
            const int nb = g / nK2, ks = g % nK2;
            if (ks == 0) {
#pragma unroll
                for (int fr = 0; fr < RF; ++fr) wmma::fill_fragment(yfr[fr], 0);
            }
            if (g + 1 < steps2) {
                const int nb1 = (g + 1) / nK2, ks1 = (g + 1) % nK2;
                q8_load_w2(w2st + ((g + 1) & 1) * Q8_STAGE2, w2, nb1 * Q8_BN,
                           c0 + ks1 * Q8_BK2, Hp, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();   // the stage landed; h8 complete
            const signed char* st = w2st + (g & 1) * Q8_STAGE2;
#pragma unroll
            for (int kc = 0; kc < Q8_BK2 / 16; ++kc) {
                const int gkc = ks * (Q8_BK2 / 16) + kc;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr;
                wmma::load_matrix_sync(bfr, st + ((size_t)kc * Q8_BN + warp * 16) * 16, 16);
#pragma unroll
                for (int fr = 0; fr < RF; ++fr) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> afr;
                    wmma::load_matrix_sync(afr, hq + ((size_t)gkc * BM + fr * 16) * 16, 16);
                    wmma::mma_sync(yfr[fr], afr, bfr, yfr[fr]);
                }
            }
            if (ks == nK2 - 1) {
#pragma unroll
                for (int fr = 0; fr < RF; ++fr)
                    wmma::store_matrix_sync(yt + fr * 16 * 16, yfr[fr], 16, wmma::mem_row_major);
                __syncwarp();
                const int n0 = nb * Q8_BN + warp * 16;
                for (int e = lane; e < BM * 16; e += 32) {
                    const int r = e / 16, n = n0 + e % 16;
                    if (n < W) {
                        float* a = acc + (size_t)r * W + n;
                        *a = __fadd_rn(*a, __fmul_rn(__int2float_rn(yt[e]), __fmul_rn(hs[r], s2[n])));
                    }
                }
                __syncwarp();
            }
            __syncthreads();   // this stage is refilled two steps later
        }
    }
    __syncthreads();
    for (int idx = tid; idx < BM * W; idx += MLP_THREADS) {
        const int r = idx / W, n = idx % W;
        const int gr = row0 + r;
        if (gr < T_rows) out[(size_t)gr * W + n] = from_f<T>(__fadd_rn(acc[idx], b2[n]));
    }
}

template <typename T, int BM>
static int launch_fused_mlp_int8(const void* x, const void* w1, const void* s1,
                                 const void* b1, const void* w2, const void* s2,
                                 const void* b2, void* out, int T_rows, int W, int H,
                                 int act, cudaStream_t stream) {
    const size_t smem = q8_layout(BM, W).total;
    cudaError_t err = cudaFuncSetAttribute(fused_mlp_int8_kernel<T, BM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_int8_kernel<T, BM><<<ceil_div(T_rows, BM), MLP_THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const signed char*>(w1),
        static_cast<const float*>(s1), static_cast<const float*>(b1),
        static_cast<const signed char*>(w2), static_cast<const float*>(s2),
        static_cast<const float*>(b2), static_cast<T*>(out), T_rows, W, H, act);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_int8(const void* x, const void* w1, const void* s1, const void* b1,
                         const void* w2, const void* s2, const void* b2, void* out,
                         int T_rows, int W, int H, int act, cudaStream_t stream) {
    constexpr size_t kMaxSmem = 232448;
    if (q8_layout(32, W).total <= kMaxSmem)
        return launch_fused_mlp_int8<T, 32>(x, w1, s1, b1, w2, s2, b2, out, T_rows, W, H,
                                            act, stream);
    if (q8_layout(16, W).total <= kMaxSmem)
        return launch_fused_mlp_int8<T, 16>(x, w1, s1, b1, w2, s2, b2, out, T_rows, W, H,
                                            act, stream);
    return kUnsupported;
}

}  // namespace rv

extern "C" int rv_fused_mlp_int8(const void* x, const void* w1, const void* s1,
                                 const void* b1, const void* w2, const void* s2,
                                 const void* b2, void* out, int T_rows, int W, int H,
                                 int act, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    // the padded weights' rows start on 16-byte boundaries only from aligned bases
    if (reinterpret_cast<uintptr_t>(w1) % 16 != 0 || reinterpret_cast<uintptr_t>(w2) % 16 != 0)
        return rv::kUnsupported;
    if (dtype == rv::kBFloat16)
        return rv::dispatch_int8<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, T_rows, W,
                                                H, act, st);
    if (dtype == rv::kFloat32)
        return rv::dispatch_int8<float>(x, w1, s1, b1, w2, s2, b2, out, T_rows, W, H, act,
                                        st);
    return rv::kUnsupported;
}

// fp32, and bf16 at widths the tensor-core GEMMs do not take: the CUDA-core
// kernel (rows of the output in shared memory, h never leaves the CTA)
extern "C" int rv_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int T_rows, int W, int H, int act, int dtype,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (dtype == rv::kBFloat16)
        return rv::dispatch_bm<__nv_bfloat16>(x, w1, b1, w2, b2, out, T_rows, W, H, act, st);
    if (dtype == rv::kFloat32)
        return rv::dispatch_bm<float>(x, w1, b1, w2, b2, out, T_rows, W, H, act, st);
    return rv::kUnsupported;
}

// bf16, W % 8 == 0, H % 8 == 0 (TMA's 16-byte row strides), 16-byte aligned
// x, weights, h and out, 4-byte aligned biases: the two wgmma GEMMs through
// h [T, H] bf16, scratch of the caller's
extern "C" int rv_fused_mlp_tc(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h, void* out,
                               int T_rows, int W, int H, int act, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (T_rows <= 0 || W <= 0 || H <= 0 || W % 8 || H % 8) return rv::kUnsupported;
    const int status = rv::mlp_tc::launch_mlp_gemm(x, w1, b1, h, T_rows, H, W, act, st);
    if (status != 0) return status;
    return rv::mlp_tc::launch_mlp_gemm(h, w2, b2, out, T_rows, W, H, rv::mlp_tc::kNoAct, st);
}
