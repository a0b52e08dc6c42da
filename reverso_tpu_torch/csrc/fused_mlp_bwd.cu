// Backward of the fused transformer MLP (K4's gradient): the fused part.
//
// Replaces: no TPU kernel. reverso_tpu/ops/fused_mlp.py::_fused_mlp_kernel
// (K4, pallas_call at :194) has no backward: jax.grad through it fails, so
// the JAX trainer learns only on XLA's MLP. This kernel gives the port's
// K4 forward (csrc/fused_mlp.cu) its gradient (ops/fused_mlp.py::
// FusedMLPFunction), so that the tower trains on the card's forward
// kernels.
//
// For y = act(x W1^T + b1) W2^T + b2 (Linear layout: W1 [H, W], W2 [W, H])
// and the output gradient dY [T, W], one kernel computes, per [T, H] tile,
//   z = x W1^T + b1 (recomputed, fp32 sums), h = act(z) rounded to x's
//   dtype as the plain version rounds it (for dW2 = dY^T h), and
//   dz = (dY W2) * act'(z), rounded once to x's dtype,
// both products inside the kernel, as K4's two products are: z and dY W2
// never reach device memory in fp32. act' is the exact-erf GELU's
// derivative, cdf(z) + z pdf(z), or quick-GELU's, s + 1.702 z s (1 - s)
// with s = sigmoid(1.702 z) (ops/fused_mlp.py::_act). In bf16 the kernel
// also writes each CTA's column sums of the rounded dz, [ceil(T / 128), H]
// fp32, which the wrapper adds in a fixed order for db1. The rest of the
// gradient is left to the caller: db2 is a column sum, and dW2 = dY^T h,
// dW1 = dz^T x and dx = dz W1 are plain large products that go to
// torch.matmul (XLA's dots of the autodiff in JAX).
//
// Two routes, by dtype (ops/fused_mlp.py::mlp_bwd_route):
//   * bf16 at W, H % 8 == 0 (every preset; the wrapper zero-pads other
//     widths to a multiple of 8, as K4's forward does), rv_fused_mlp_bwd_tc:
//     fused_mlp.cu's GEMM design (mlp_tc) with two accumulators. One CTA
//     per 128 x 128 tile of [T, H]: a producer warp, one thread of which
//     brings the x, dY and W1 tiles (K-major, 64 deep, 128-byte swizzle) and
//     W2's tile ([64 of W][128 of H]: H contiguous, read by the product in
//     its MN-major form, so W2 is never transposed) through TMA into a
//     three-stage mbarrier ring (64 KB a stage); two consumer warpgroups of
//     64 rows each run z += x W1^T and g += dY W2 (wgmma m64n128k16, fp32
//     accumulators, 128 registers a thread for the two). Rows past T, a K
//     past the last whole step and columns past H read zeros from the
//     hardware. The epilogue parks both fp32 tiles in the ring's shared
//     memory (139 KB) and applies the activation and its derivative by
//     element, 8 adjacent columns a thread and one 16-byte store of h and
//     of dz (erff straight from the fragments measured 2.2x slower in the
//     forward, fused_mlp.cu), then sums its column partials of dz through
//     shared memory;
//   * fp32, rv_fused_mlp_bwd: the same tile on the CUDA cores (64 x 64 a
//     CTA, 16 deep, each thread 4 x 4 of both accumulators), any shape.
//
// What bounds it on the H100: two products of T W H multiply-adds, 4 T W H
// operations (155 GFLOP at T = 16 * 577 = 9232, 1024 -> 4096 -> 1024,
// 0.157 ms at 989 TFLOP/s in bf16) against x, dY, W1, W2 and b1 read and h
// and dz written once (0.19 GB in bf16, 0.057 ms): bound by operations, so
// the rate comes from wgmma fed by TMA; above that, the epilogue's
// activation derivative (erff and expf) over the [T, H] tile, which no
// product overlaps (one CTA an SM at 193 KB of shared memory).
#include "common.cuh"
#include "hopper.cuh"

namespace rv {
namespace mbwd {

using namespace tc;

constexpr int kGelu = 0;
constexpr int kQuickGelu = 1;

// h = act(z) and act'(z) in fp32
__device__ __forceinline__ void act_grad(float z, int act, float& h, float& d) {
    if (act == kQuickGelu) {
        const float s = 1.f / (1.f + expf(-1.702f * z));
        h = z * s;
        d = s + 1.702f * z * s * (1.f - s);
    } else {
        const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
        h = z * cdf;
        d = cdf + z * 0.39894228040143268f * expf(-0.5f * z * z);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kTcThreads = 2 * kWgThreads + 32;    // two consumer warpgroups, a producer warp
constexpr int kTile = kBM * kBK * 2;               // 16 KB: each of x, dY, W1 and W2's tiles
constexpr int kStage = 4 * kTile;
constexpr int kLdc = kBN + 8;                      // the epilogue's fp32 row pitch
constexpr int kTcSmem = 1024 + kStages * kStage + 16 * kStages;
static_assert(2 * kBM * kLdc * 4 + 16 * kBN * 4 <= kStages * kStage, "epilogue fits the ring");
static_assert(kTcSmem <= 232448, "shared memory of a CTA");

// D (+)= A B, A (64 rows) K-major and B MN-major (N contiguous) in shared
// memory, N = 128: dY W2 with W2 read as it lies ([K][N])
struct WgmmaSSMn128 {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// One CTA: rows m0 .. m0 + 127 of [T, H], columns n0 .. n0 + 127
__global__ void __launch_bounds__(kTcThreads, 1)
mlp_bwd_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
              const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ h,
              __nv_bfloat16* __restrict__ dz, float* __restrict__ db1_part, int T, int W, int H,
              int act) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    // stage s: x [128][64], dY [128][64], W1 [128][64] (K-major), W2 as two
    // 64-column atoms [2][64 of W][64 of H]; every tile 128-byte swizzled
    uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStage);
    uint64_t* empty = full + kStages;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
    const int n_k = ceil_div(W, kBK);
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
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
                const int s = j % kStages;
                uint8_t* st = base + s * kStage;
                mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                mbar_expect_tx(&full[s], kStage);
                tma_load_2d(st, &xmap, &full[s], j * kBK, m0);
                tma_load_2d(st + kTile, &ymap, &full[s], j * kBK, m0);
                tma_load_2d(st + 2 * kTile, &w1map, &full[s], j * kBK, n0);
                tma_load_2d(st + 3 * kTile, &w2map, &full[s], n0, j * kBK);
                tma_load_2d(st + 3 * kTile + kTile / 2, &w2map, &full[s], n0 + 64, j * kBK);
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int warp = tid / 32, lane = tid % 32;
    float z[kBN / 2], g[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) z[i] = g[i] = 0.f;
    const uint32_t s0 = smem_addr(base);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        const uint32_t st = s0 + s * kStage;
        mbar_wait(&full[s], (j / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {   // k16 steps: 32 bytes into the swizzled rows
            const uint32_t a_x = st + wg * 64 * kBK * 2 + kk * 32;
            WgmmaSS<kBN>::run(z, gmma_desc(a_x, 16, 1024, 1),
                              gmma_desc(st + 2 * kTile + kk * 32, 16, 1024, 1), 1);
            // W2's tile MN-major: 16 rows of W a step, its two 64-column
            // atoms 8 KB apart
            WgmmaSSMn128::run(g, gmma_desc(a_x + kTile, 16, 1024, 1),
                              gmma_desc(st + 3 * kTile + kk * 16 * 128, kTile / 2, 1024, 1), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();   // step j - 1's products are done: release its stage
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
        }
    }
    wgmma_wait<0>();
    fence_operand(z);
    fence_operand(g);

    // ---- epilogue ----
    // (1) both consumer warpgroups are done with the ring: it takes the two
    // fp32 tiles [128][kLdc] and the column partials [16][128]
    float* zt = reinterpret_cast<float*>(base);
    float* gt = zt + kBM * kLdc;
    float* part = gt + kBM * kLdc;
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = wg * 64 + warp * 16 + lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
            const int col = 8 * i + 2 * t;
            *reinterpret_cast<float2*>(zt + r * kLdc + col) = make_float2(z[4 * i], z[4 * i + 1]);
            *reinterpret_cast<float2*>(zt + (r + 8) * kLdc + col) =
                make_float2(z[4 * i + 2], z[4 * i + 3]);
            *reinterpret_cast<float2*>(gt + r * kLdc + col) = make_float2(g[4 * i], g[4 * i + 1]);
            *reinterpret_cast<float2*>(gt + (r + 8) * kLdc + col) =
                make_float2(g[4 * i + 2], g[4 * i + 3]);
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // (2) each thread takes 8 adjacent columns of a row at a time: b1, the
    // activation and its derivative, one 16-byte store of h and of dz, and
    // its columns' sums of the rounded dz over its rows
    constexpr int TPR = kBN / 8;                  // threads per row
    constexpr int ROWS = 2 * kWgThreads / TPR;    // rows per pass
    const int ctid = wg * kWgThreads + tid;
    const int c8 = (ctid % TPR) * 8, col = n0 + c8;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (col < H) {   // H % 8 == 0: a group of 8 is in or out whole
        float bv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) bv[e] = __bfloat162float(b1[col + e]);
#pragma unroll 1
        for (int r = ctid / TPR; r < kBM && m0 + r < T; r += ROWS) {
            const float* zr = zt + r * kLdc + c8;
            const float* gr = gt + r * kLdc + c8;
            float hv[8], dv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                float d;
                act_grad(zr[e] + bv[e], act, hv[e], d);
                dv[e] = gr[e] * d;
            }
            const uint4 dz16 = make_uint4(pack_bf16(dv[0], dv[1]), pack_bf16(dv[2], dv[3]),
                                          pack_bf16(dv[4], dv[5]), pack_bf16(dv[6], dv[7]));
            const size_t off = (size_t)(m0 + r) * H + col;
            *reinterpret_cast<uint4*>(h + off) =
                make_uint4(pack_bf16(hv[0], hv[1]), pack_bf16(hv[2], hv[3]),
                           pack_bf16(hv[4], hv[5]), pack_bf16(hv[6], hv[7]));
            *reinterpret_cast<uint4*>(dz + off) = dz16;
            const __nv_bfloat16* r16 = reinterpret_cast<const __nv_bfloat16*>(&dz16);
#pragma unroll
            for (int e = 0; e < 8; ++e) sum[e] += __bfloat162float(r16[e]);
        }
    }
    // (3) db1's partials: the ROWS threads of each column group add their
    // sums through shared memory, in a fixed order
    float* pr = part + (ctid / TPR) * kBN + c8;
#pragma unroll
    for (int e = 0; e < 8; ++e) pr[e] = sum[e];
    named_bar_sync(1, 2 * kWgThreads);
    if (ctid < kBN && n0 + ctid < H) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s += part[r * kBN + ctid];
        db1_part[(size_t)blockIdx.y * H + n0 + ctid] = s;
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

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kSM = 64, kSN = 64, kSK = 16, kSP = 64 + 4;

__global__ void __launch_bounds__(kThreads)
    mlp_bwd_simt(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* dy, float* h, float* dz, int Tn, int W, int H, int act) {
    __shared__ __align__(16) float xs[kSK][kSP];
    __shared__ __align__(16) float ys[kSK][kSP];
    __shared__ __align__(16) float w1s[kSK][kSP];
    __shared__ __align__(16) float w2s[kSK][kSP];
    const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float z[4][4] = {}, g[4][4] = {};
    for (int k0 = 0; k0 < W; k0 += kSK) {
        for (int idx = threadIdx.x; idx < kSM * kSK; idx += kThreads) {
            const int r = idx / kSK, kk = idx % kSK, k = k0 + kk;
            const int m = m0 + r, n = n0 + r;
            const bool mk = m < Tn && k < W;
            xs[kk][r] = mk ? x[static_cast<size_t>(m) * W + k] : 0.f;
            ys[kk][r] = mk ? dy[static_cast<size_t>(m) * W + k] : 0.f;
            w1s[kk][r] = n < H && k < W ? w1[static_cast<size_t>(n) * W + k] : 0.f;
            const int kr = idx / kSN, nc = idx % kSN;
            w2s[kr][nc] = k0 + kr < W && n0 + nc < H
                              ? w2[static_cast<size_t>(k0 + kr) * H + n0 + nc]
                              : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kSK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&w1s[kk][tx * 4]);
            const float4 c = *reinterpret_cast<const float4*>(&ys[kk][ty * 4]);
            const float4 d = *reinterpret_cast<const float4*>(&w2s[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
            const float cv[4] = {c.x, c.y, c.z, c.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    z[i][j] += av[i] * bv[j];
                    g[i][j] += cv[i] * dv[j];
                }
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= Tn) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n >= H) continue;
            float hv, d;
            act_grad(z[i][j] + b1[n], act, hv, d);
            const size_t o = static_cast<size_t>(m) * H + n;
            h[o] = hv;
            dz[o] = g[i][j] * d;
        }
    }
}

}  // namespace mbwd
}  // namespace rv

// bf16 x, dy [T, W], w1 [H, W], w2 [W, H], b1 [H], contiguous, W, H % 8 ==
// 0, x, dy, w1, w2, h and dz 16-byte aligned (the wrapper pads other widths
// and passes fresh or `_aligned` tensors); h, dz [T, H] bf16 out; db1_part
// [ceil(T / 128), H] fp32 out: each 128-row tile's column sums of dz.
extern "C" int rv_fused_mlp_bwd_tc(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dy, void* h, void* dz,
                                   void* db1_part, int T, int W, int H, int act, void* stream) {
    using namespace rv::mbwd;
    if (T < 0 || W < 1 || H < 1 || W % 8 || H % 8 || (act != kGelu && act != kQuickGelu))
        return rv::kUnsupported;
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (!(a16(x) && a16(w1) && a16(w2) && a16(dy) && a16(h) && a16(dz))) return rv::kUnsupported;
    if (T == 0) return 0;
    CUtensorMap xm, ym, w1m, w2m;
    if (!make_map_2d(&xm, x, W, T, kBM) || !make_map_2d(&ym, dy, W, T, kBM) ||
        !make_map_2d(&w1m, w1, W, H, kBN) || !make_map_2d(&w2m, w2, H, W, kBK))
        return rv::tc::kMapError;
    cudaError_t err = cudaFuncSetAttribute(mlp_bwd_wgmma,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rv::ceil_div(H, kBN), rv::ceil_div(T, kBM));
    mlp_bwd_wgmma<<<grid, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
        xm, ym, w1m, w2m, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(h),
        static_cast<__nv_bfloat16*>(dz), static_cast<float*>(db1_part), T, W, H, act);
    return (int)cudaGetLastError();
}

// fp32 x, dy [T, W], w1 [H, W], b1 [H], w2 [W, H], contiguous; h, dz [T, H]
// fp32 out; any shape.
extern "C" int rv_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* dy, void* h, void* dz, int T, int W, int H, int act,
                                void* stream) {
    using namespace rv::mbwd;
    if (T < 0 || W < 1 || H < 1 || (act != kGelu && act != kQuickGelu)) return rv::kUnsupported;
    if (T == 0) return 0;
    const dim3 grid(rv::ceil_div(H, kSN), rv::ceil_div(T, kSM));
    mlp_bwd_simt<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(dy), static_cast<float*>(h), static_cast<float*>(dz), T, W, H,
        act);
    return static_cast<int>(cudaGetLastError());
}
