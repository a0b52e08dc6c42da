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
