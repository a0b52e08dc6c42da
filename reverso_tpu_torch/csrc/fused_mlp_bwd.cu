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
// with s = sigmoid(1.702 z) (ops/fused_mlp.py::_act). The rest of the
// gradient is left to the caller: db1 and db2 are column sums, and dW2 =
// dY^T h, dW1 = dz^T x and dx = dz W1 are plain large products that go to
// torch.matmul. No TPU kernel body computes those: in JAX they would be
// XLA's dots of the autodiff. What is the kernel's own work is the
// recomputation of z, the activation and its derivative fused onto the
// two products.
//
// Two routes, by dtype (rv_fused_mlp_bwd below picks):
//   * bf16 at W, H % 8 == 0 (every preset; the wrapper zero-pads other
//     widths to a multiple of 8, as K4's forward does): a tensor-core
//     kernel, one CTA
//     per 128 x 64 tile of [T, H], 8 warps each holding 32 x 32 of both
//     accumulators in wmma fragments (m16n16k16, bf16 in, fp32 sums; the
//     mma.sync instructions of sm_80 and later), x, dY, W1 and W2 tiles 32
//     deep through a two-stage cp.async ring; the epilogue goes through
//     shared memory to apply the activation by element;
//   * fp32: the same tile on the CUDA cores (64 x 64 a CTA, 16 deep, each
//     thread 4 x 4 of both accumulators), any shape.
//
// What bounds it on the H100: two products of T W H multiply-adds, 4 T W H
// operations (155 GFLOP at T = 16 * 577 = 9232, 1024 -> 4096 -> 1024,
// 0.157 ms at 989 TFLOP/s in bf16) against x, dY, W1, W2 and b1 read and h
// and dz written once (0.19 GB in bf16, 0.057 ms): bound by operations.
// mma.sync through a two-stage ring reaches a fraction of wgmma's rate; a
// wgmma + TMA version (as K4's forward) is ROADMAP queue 2's second pass
// for it.
#include <mma.h>

#include "common.cuh"

namespace rv {
namespace mbwd {

constexpr int kGelu = 0;
constexpr int kQuickGelu = 1;
constexpr int kThreads = 256;

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
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8;    // x, dY and W1 tiles: [rows][kBK] bf16, padded
constexpr int kLdB = kBN + 8;    // W2 tile: [kBK][kBN] bf16, padded
constexpr int kLdC = kBN + 4;    // epilogue: [kBM][kBN] fp32, padded
constexpr int kStageElems = 2 * kBM * kLdA + kBN * kLdA + kBK * kLdB;
constexpr int kTcSmem = 2 * kBM * kLdC * 4 > 2 * kStageElems * 2 ? 2 * kBM * kLdC * 4
                                                                  : 2 * kStageElems * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = pred ? 16 : 0;   // 0: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct TcArgs {
    const __nv_bfloat16* x;
    const __nv_bfloat16* w1;
    const __nv_bfloat16* b1;
    const __nv_bfloat16* w2;
    const __nv_bfloat16* dy;
    __nv_bfloat16* h;
    __nv_bfloat16* dz;
    int T, W, H, act;
};

// one stage: x and dY rows m0.., W1 rows n0.., W2 rows k0.. (columns n0..)
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const TcArgs& a, int m0, int n0,
                                           int k0) {
    __nv_bfloat16* xs = st;
    __nv_bfloat16* ys = xs + kBM * kLdA;
    __nv_bfloat16* w1s = ys + kBM * kLdA;
    __nv_bfloat16* w2s = w1s + kBN * kLdA;
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // 128 rows x 4 chunks of 8
        const int idx = tid + i * kThreads, r = idx / 4, c = idx % 4;
        const int m = m0 + r, k = k0 + c * 8;
        const bool ok = m < a.T && k < a.W;
        const size_t off = ok ? static_cast<size_t>(m) * a.W + k : 0;
        cp_async16(xs + r * kLdA + c * 8, a.x + off, ok);
        cp_async16(ys + r * kLdA + c * 8, a.dy + off, ok);
    }
    {   // W1: 64 rows x 4 chunks
        const int r = tid / 4, c = tid % 4;
        const int n = n0 + r, k = k0 + c * 8;
        const bool ok = n < a.H && k < a.W;
        cp_async16(w1s + r * kLdA + c * 8, a.w1 + (ok ? static_cast<size_t>(n) * a.W + k : 0), ok);
    }
    {   // W2: 32 rows (k) x 8 chunks (n)
        const int r = tid / 8, c = tid % 8;
        const int k = k0 + r, n = n0 + c * 8;
        const bool ok = k < a.W && n < a.H;
        cp_async16(w2s + r * kLdB + c * 8, a.w2 + (ok ? static_cast<size_t>(k) * a.H + n : 0), ok);
    }
}

__global__ void __launch_bounds__(kThreads) mlp_bwd_tc(TcArgs a) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
    const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cz[2][2], cg[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            wmma::fill_fragment(cz[i][j], 0.f);
            wmma::fill_fragment(cg[i][j], 0.f);
        }
    const int nk = ceil_div(a.W, kBK);
    load_stage(stages, a, m0, n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk)
            load_stage(stages + ((kt + 1) & 1) * kStageElems, a, m0, n0, (kt + 1) * kBK);
        cp_async_commit();
        cp_async_wait<1>();   // stage kt has landed
        __syncthreads();
        const __nv_bfloat16* xs = stages + (kt & 1) * kStageElems;
        const __nv_bfloat16* ys = xs + kBM * kLdA;
        const __nv_bfloat16* w1s = ys + kBM * kLdA;
        const __nv_bfloat16* w2s = w1s + kBN * kLdA;
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ax[2], ay[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw1[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw2[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                wmma::load_matrix_sync(ax[i], xs + (wm * 32 + i * 16) * kLdA + ks, kLdA);
                wmma::load_matrix_sync(ay[i], ys + (wm * 32 + i * 16) * kLdA + ks, kLdA);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                // B(k, n) = W1[n][k]: W1's rows are B's columns
                wmma::load_matrix_sync(bw1[j], w1s + (wn * 32 + j * 16) * kLdA + ks, kLdA);
                wmma::load_matrix_sync(bw2[j], w2s + ks * kLdB + wn * 32 + j * 16, kLdB);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    wmma::mma_sync(cz[i][j], ax[i], bw1[j], cz[i][j]);
                    wmma::mma_sync(cg[i][j], ay[i], bw2[j], cg[i][j]);
                }
        }
        __syncthreads();   // the next loads overwrite this stage
    }
    cp_async_wait<0>();
    __syncthreads();
    float* zs = reinterpret_cast<float*>(smem);
    float* gs = zs + kBM * kLdC;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int off = (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16;
            wmma::store_matrix_sync(zs + off, cz[i][j], kLdC, wmma::mem_row_major);
            wmma::store_matrix_sync(gs + off, cg[i][j], kLdC, wmma::mem_row_major);
        }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBN / 2; idx += kThreads) {   // column pairs
        const int r = idx / (kBN / 2), c = (idx % (kBN / 2)) * 2;
        const int m = m0 + r, n = n0 + c;
        if (m >= a.T || n >= a.H) continue;   // H % 8 == 0: n + 1 < H too
        float hv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float d;
            act_grad(zs[r * kLdC + c + e] + __bfloat162float(a.b1[n + e]), a.act, hv[e], d);
            dv[e] = gs[r * kLdC + c + e] * d;
        }
        const size_t o = static_cast<size_t>(m) * a.H + n;
        *reinterpret_cast<__nv_bfloat162*>(a.h + o) = __floats2bfloat162_rn(hv[0], hv[1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dz + o) = __floats2bfloat162_rn(dv[0], dv[1]);
    }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

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

// x, dy [T, W], w1 [H, W], b1 [H], w2 [W, H] of one dtype, contiguous; h,
// dz [T, H] out in that dtype. bf16 takes the tensor-core route at W, H %
// 8 == 0 only, with 16-byte aligned x, dy, w1, w2 and 4-byte aligned h, dz
// (the wrapper pads other widths and passes fresh or `_aligned` tensors);
// fp32 takes the CUDA cores.
extern "C" int rv_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* dy, void* h, void* dz, int T, int W, int H, int act,
                                int dtype, void* stream) {
    using namespace rv::mbwd;
    if (T < 0 || W < 1 || H < 1 || (act != kGelu && act != kQuickGelu)) return rv::kUnsupported;
    if (T == 0) return 0;
    const auto st = static_cast<cudaStream_t>(stream);
    if (dtype == rv::kBFloat16) {
        if (W % 8 || H % 8) return rv::kUnsupported;
        const TcArgs a{static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w1),
                       static_cast<const __nv_bfloat16*>(b1),
                       static_cast<const __nv_bfloat16*>(w2),
                       static_cast<const __nv_bfloat16*>(dy),
                       static_cast<__nv_bfloat16*>(h),
                       static_cast<__nv_bfloat16*>(dz),
                       T, W, H, act};
        cudaFuncSetAttribute(mlp_bwd_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
        const dim3 grid(rv::ceil_div(H, kBN), rv::ceil_div(T, kBM));
        mlp_bwd_tc<<<grid, kThreads, kTcSmem, st>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    if (dtype == rv::kFloat32) {
        const dim3 grid(rv::ceil_div(H, kSN), rv::ceil_div(T, kSM));
        mlp_bwd_simt<<<grid, kThreads, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(w1),
            static_cast<const float*>(b1), static_cast<const float*>(w2),
            static_cast<const float*>(dy), static_cast<float*>(h), static_cast<float*>(dz), T,
            W, H, act);
        return static_cast<int>(cudaGetLastError());
    }
    return rv::kUnsupported;
}
