// Fused transformer MLP: y = act(x @ W1^T + b1) @ W2^T + b2.
//
// Replaces: reverso_tpu/ops/fused_mlp.py::_fused_mlp_kernel (entry
// fused_mlp), the MLP of every ViT block. Weights come in PyTorch Linear
// layout: W1 [H, W], W2 [W, H].
//
// What bounds it on the H100: 4 * T * W * H FLOPs (620 GFLOP per PE-L14
// layer at B = 64) against 2 * T * W activation elements and 2 * W * H
// weight elements; the unfused form also writes and reads the [T, H] hidden
// tensor (4x the activation) through HBM. So it is compute-bound, and the
// rate comes from the tensor cores.
//
// What the design does about it:
//   * one CTA owns BM = 32 rows and the full output width in an fp32
//     accumulator in shared memory (32 x 1024 x 4 B = 128 KB at W = 1024);
//   * the hidden dimension streams in BH-wide chunks: each chunk computes
//     h = act(x_tile @ W1[c]^T + b1[c]) with fp32 accumulation, rounds it to
//     T like the reference, parks it in shared memory and adds
//     h @ W2[:, c]^T into the accumulator. The [T, H] hidden tensor never
//     reaches HBM;
//   * bf16 (the working dtype): warp-level tensor-core products (WMMA
//     16x16x16, bf16 in, fp32 accumulate) on tiles that stream in through
//     two-stage cp.async rings, so copies overlap the products; each CTA
//     still re-reads the weights from L2, which bounds this version well
//     below the tensor cores' rate;
//   * fp32 (parity mode) and widths the tensor-core tiling does not take:
//     fp32 FMAs on the CUDA cores, operand tiles staged as fp32 with padded
//     rows and a register micro-tile per thread.
// gelu is the exact erf form (erff); the reference kernel's A&S polynomial
// differs from it by at most 1.5e-7 in erf.
#include <mma.h>

#include "common.cuh"

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

// ---- bf16 tensor-core variant ----------------------------------------------
// Operand tiles stream in with cp.async into two-stage rings, so the next
// tile's copy overlaps the current tile's tensor-core products.
constexpr int TC_BM = 32;            // rows per CTA
constexpr int TC_BH = 128;           // hidden chunk
constexpr int TC_BK = 64;            // reduction step of the first product
constexpr int TC_BN = 64;            // output-column block of the second product
constexpr int TC_LDX = TC_BK + 8;    // bf16 row stride of the x / W1 tiles
constexpr int TC_LDH = TC_BH + 8;    // bf16 row stride of the h / W2 tiles
constexpr int TC_P1_STAGE = (TC_BM + TC_BH) * TC_LDX;   // bf16 per x+W1 stage
constexpr int TC_W2_STAGE = TC_BN * TC_LDH;             // bf16 per W2 stage

struct TcLayout {   // byte offsets into dynamic shared memory
    size_t acc, p1, hb, w2s, total;
};

__host__ __device__ inline size_t align128(size_t b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline TcLayout tc_layout(int W) {
    TcLayout L;
    size_t o = 0;
    L.acc = o; o += align128((size_t)TC_BM * W * sizeof(float));
    // two x+W1 stages; the fp32 h staging tile reuses this space after the
    // first product
    L.p1 = o;  o += align128(2 * (size_t)TC_P1_STAGE * 2);
    L.hb = o;  o += align128((size_t)TC_BM * TC_LDH * 2);
    L.w2s = o; o += align128(2 * (size_t)TC_W2_STAGE * 2);
    L.total = o;
    return L;
}

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

// x[row0 : row0+BM, k0 : k0+BK] and W1[c0 : c0+BH, k0 : k0+BK] -> one stage
__device__ __forceinline__ void tc_load_p1(__nv_bfloat16* stage,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* w1, int row0,
                                           int c0, int k0, int T_rows, int W,
                                           int H, int tid) {
    __nv_bfloat16* xs = stage;
    __nv_bfloat16* w1s = stage + TC_BM * TC_LDX;
    for (int v = tid; v < TC_BM * TC_BK / 8; v += MLP_THREADS) {
        const int r = v / (TC_BK / 8), k8 = (v % (TC_BK / 8)) * 8;
        const int gr = row0 + r, gk = k0 + k8;
        const bool ok = gr < T_rows && gk < W;
        cp_async16(xs + r * TC_LDX + k8, ok ? x + (size_t)gr * W + gk : x, ok);
    }
    for (int v = tid; v < TC_BH * TC_BK / 8; v += MLP_THREADS) {
        const int c = v / (TC_BK / 8), k8 = (v % (TC_BK / 8)) * 8;
        const int gc = c0 + c, gk = k0 + k8;
        const bool ok = gc < H && gk < W;
        cp_async16(w1s + c * TC_LDX + k8, ok ? w1 + (size_t)gc * W + gk : w1, ok);
    }
    cp_async_commit();
}

// W2[nb : nb+BN, c0 : c0+BH] -> one stage, [n][c] with row stride LDH
__device__ __forceinline__ void tc_load_w2(__nv_bfloat16* stage,
                                           const __nv_bfloat16* w2, int nb,
                                           int c0, int W, int H, int tid) {
    for (int v = tid; v < TC_BN * TC_BH / 8; v += MLP_THREADS) {
        const int n = v / (TC_BH / 8), k8 = (v % (TC_BH / 8)) * 8;
        const int gn = nb + n, gc = c0 + k8;
        const bool ok = gn < W && gc < H;
        cp_async16(stage + n * TC_LDH + k8, ok ? w2 + (size_t)gn * H + gc : w2, ok);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(MLP_THREADS)
fused_mlp_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    const __nv_bfloat16* __restrict__ b2,
                    __nv_bfloat16* __restrict__ out, int T_rows, int W, int H,
                    int act) {
    using namespace nvcuda;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const TcLayout L = tc_layout(W);
    float* acc = reinterpret_cast<float*>(smem_raw + L.acc);                 // [BM][W]
    __nv_bfloat16* p1 = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.p1);   // 2 stages
    float* hf = reinterpret_cast<float*>(smem_raw + L.p1);                   // [BM][BH]
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.hb);   // [BM][LDH]
    __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.w2s); // 2 stages

    const int tid = threadIdx.x;
    const int warp = tid / 32;          // 8 warps
    const int row0 = blockIdx.x * TC_BM;
    const int nK = ceil_div(W, TC_BK);
    const int nN = ceil_div(W, TC_BN);

    for (int idx = tid; idx < TC_BM * W; idx += MLP_THREADS) acc[idx] = 0.f;

    for (int c0 = 0; c0 < H; c0 += TC_BH) {
        // ---- h = x_tile @ W1[c0:c0+BH]^T: warp w owns hidden columns w*16.. --
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> hfrag[2];
        wmma::fill_fragment(hfrag[0], 0.f);
        wmma::fill_fragment(hfrag[1], 0.f);
        tc_load_p1(p1, x, w1, row0, c0, 0, T_rows, W, H, tid);
        for (int s = 0; s < nK; ++s) {
            if (s + 1 < nK) {
                tc_load_p1(p1 + ((s + 1) & 1) * TC_P1_STAGE, x, w1, row0, c0,
                           (s + 1) * TC_BK, T_rows, W, H, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const __nv_bfloat16* xs = p1 + (s & 1) * TC_P1_STAGE;
            const __nv_bfloat16* w1s = xs + TC_BM * TC_LDX;
#pragma unroll
            for (int kk = 0; kk < TC_BK; kk += 16) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
                wmma::load_matrix_sync(bfr, w1s + warp * 16 * TC_LDX + kk, TC_LDX);
#pragma unroll
                for (int fr = 0; fr < 2; ++fr) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
                    wmma::load_matrix_sync(afr, xs + fr * 16 * TC_LDX + kk, TC_LDX);
                    wmma::mma_sync(hfrag[fr], afr, bfr, hfrag[fr]);
                }
            }
            __syncthreads();   // this stage is refilled two steps later
        }
        // prefetch the first W2 block while h is finished
        tc_load_w2(w2s, w2, 0, c0, W, H, tid);
#pragma unroll
        for (int fr = 0; fr < 2; ++fr)
            wmma::store_matrix_sync(hf + fr * 16 * TC_BH + warp * 16, hfrag[fr],
                                    TC_BH, wmma::mem_row_major);
        __syncthreads();
        // ---- bias + activation in fp32, rounded to bf16 ----------------------
        for (int idx = tid; idx < TC_BM * TC_BH; idx += MLP_THREADS) {
            const int r = idx / TC_BH, c = idx % TC_BH;
            const int gc = c0 + c;
            const float hv = (gc < H) ? mlp_act(hf[idx] + __bfloat162float(b1[gc]), act) : 0.f;
            hb[r * TC_LDH + c] = __float2bfloat16(hv);
        }

        // ---- acc += h @ W2[:, c0:c0+BH]^T: warp w owns one 16x16 tile -------
        const int fr = warp / 4, fc = warp % 4;
        for (int t = 0; t < nN; ++t) {
            if (t + 1 < nN) {
                tc_load_w2(w2s + ((t + 1) & 1) * TC_W2_STAGE, w2, (t + 1) * TC_BN,
                           c0, W, H, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();   // W2 stage landed; hb complete
            const __nv_bfloat16* ws = w2s + (t & 1) * TC_W2_STAGE;
            const int n0 = t * TC_BN + fc * 16;
            if (n0 < W) {
                wmma::fragment<wmma::accumulator, 16, 16, 16, float> afrag;
                float* ap = acc + (size_t)fr * 16 * W + n0;
                wmma::load_matrix_sync(afrag, ap, W, wmma::mem_row_major);
#pragma unroll
                for (int kk = 0; kk < TC_BH; kk += 16) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bfr;
                    wmma::load_matrix_sync(afr, hb + fr * 16 * TC_LDH + kk, TC_LDH);
                    wmma::load_matrix_sync(bfr, ws + fc * 16 * TC_LDH + kk, TC_LDH);
                    wmma::mma_sync(afrag, afr, bfr, afrag);
                }
                wmma::store_matrix_sync(ap, afrag, W, wmma::mem_row_major);
            }
            __syncthreads();   // this stage is refilled two steps later
        }
    }
    for (int idx = tid; idx < TC_BM * W; idx += MLP_THREADS) {
        const int r = idx / W, n = idx % W;
        const int gr = row0 + r;
        if (gr < T_rows)
            out[(size_t)gr * W + n] = __float2bfloat16(acc[idx] + __bfloat162float(b2[n]));
    }
}

static bool tc_supported(int W, int H) {
    return W % 16 == 0 && H % 8 == 0 && tc_layout(W).total <= 232448;
}

static int launch_fused_mlp_tc(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int T_rows, int W, int H, int act,
                               cudaStream_t stream) {
    const size_t smem = tc_layout(W).total;
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    using bf = __nv_bfloat16;
    fused_mlp_tc_kernel<<<ceil_div(T_rows, TC_BM), MLP_THREADS, smem, stream>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w1),
        static_cast<const bf*>(b1), static_cast<const bf*>(w2),
        static_cast<const bf*>(b2), static_cast<bf*>(out), T_rows, W, H, act);
    return (int)cudaGetLastError();
}

}  // namespace rv

extern "C" int rv_fused_mlp(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out,
                            int T_rows, int W, int H, int act, int dtype,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (dtype == rv::kBFloat16 && rv::tc_supported(W, H))
        return rv::launch_fused_mlp_tc(x, w1, b1, w2, b2, out, T_rows, W, H, act, st);
    if (dtype == rv::kBFloat16)
        return rv::dispatch_bm<__nv_bfloat16>(x, w1, b1, w2, b2, out, T_rows, W, H, act, st);
    if (dtype == rv::kFloat32)
        return rv::dispatch_bm<float>(x, w1, b1, w2, b2, out, T_rows, W, H, act, st);
    return rv::kUnsupported;
}
