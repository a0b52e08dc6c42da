// Flash attention over [B, H, S, D] with an optional decomposed relative-
// position bias (SAM's global layers): two kernels.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_kernel (the tiled kernel,
// pallas_call at :229, used with rel_bias by SAM's global layers) and
// ::_flash_fullseq_kernel (the whole-sequence kernel, pallas_call at :98,
// used by ViT attention past the heads-in-lanes kernel's S <= 1032 envelope
// or at head_dim % 4 != 0). Both sit behind flash_attention(); the
// fullseq/tiled split only existed to fit the TPU's VMEM.
//
// What bounds them on the H100: products. At PE-L14 at 504 px (B = 8,
// H = 16, S = 1297, D = 64, bf16) the work is 4 * B * H * S^2 * D = 55 GFLOP
// against 85 MB of q/k/v/o (0.056 ms at 989 TFLOP/s against 0.025 ms of
// bytes); at SAM ViT-B's global layers (B = 4, H = 12, S = 4096, D = 64)
// 206 GFLOP against ~300 MB of fp32 q/k/v/o (0.208 ms at the bf16 rate).
//
//   * D % 16 == 0, D <= 128, and bf16 without a bias or either dtype with
//     SAM's rel-pos bias: rv_flash_attn_tc, the tensor-core core of
//     flash_tc.cuh (wgmma for QK^T and PV, P kept in registers between
//     them, K/V through TMA into a four-stage mbarrier ring, a 3-D [BH, S,
//     D] tensor map so a ragged tile zero-fills instead of reading the next
//     head; the bias added to the score fragments inside the tile). The
//     rel-pos bias takes bf16 operands in either dtype because the TPU
//     kernel does (one bf16 MXU pass for its fp32 inputs); fp32 callers
//     pass bf16 copies and get an fp32 output;
//   * fp32 without a bias, and other head dims with or without it:
//     rv_flash_attn below, on the CUDA cores in fp32 (published H100 SXM
//     peak 67 TFLOP/s at 700 W), which keeps the fp32 towers exact to fp32
//     rounding:
//       - one CTA of 256 threads per (64-query tile, batch*head); the q tile
//         is read once, scaled in fp32 and kept in shared memory, and the
//         [Sq, Skv] scores never leave the CTA;
//       - K/V stream through 64-key shared-memory tiles (zero-padded up to
//         the template head width, so any D <= 128 runs);
//       - register tiles: each thread scores 4 queries x 4 keys and
//         accumulates 4 queries x D/16 output columns from the p tile;
//       - online softmax with an fp32 running max and sum per row, reduced
//         across the 16 threads of a row with warp shuffles; keys at or past
//         kv_valid are never multiplied;
//       - the rel-pos bias bias[q, k] = bh[q, k / G] + bw[q, k % G] is added
//         to each score inside the tile from the CTA's [G, 64] row and
//         column bias tiles, staged once in shared memory, so the [Sq, Skv]
//         bias never reaches device memory (the TPU built it with a 0/1
//         selector matmul on the MXU; here it is two shared loads and adds).
// Rounding follows the plain version up to where p is rounded: p is rounded
// to the input dtype before the PV product while the row sum uses the fp32
// p, and the output is divided by the row sum at the end.
#include "common.cuh"
#include "flash_tc.cuh"

namespace rv {

constexpr int FA_BQ = 64;          // query rows per CTA
constexpr int FA_BK = 64;          // keys per shared-memory tile
constexpr int FA_THREADS = 256;    // 16 x 16: 4 rows x 4 keys per thread
constexpr int FA_PAD = FA_BQ + 4;  // row stride of the transposed tiles

template <int HDP>
struct FaSmem {
    static constexpr int qt = HDP * FA_PAD;   // q^T [HDP][BQ+4], scaled
    static constexpr int kt = HDP * FA_PAD;   // k^T [HDP][BK+4]
    static constexpr int vs = FA_BK * HDP;    // v   [BK][HDP]
    static constexpr int pt = FA_BK * FA_PAD; // p^T [BK][BQ+4]
    static constexpr int fixed = qt + kt + vs + pt;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bh,
                  const float* __restrict__ bw, T* __restrict__ o, int Sq,
                  int Skv, int D, int G, int kv_valid, float scale) {
    constexpr int DPT = HDP / 16;            // output columns per thread
    extern __shared__ __align__(16) float smem[];
    float* qt = smem;
    float* kt = qt + FaSmem<HDP>::qt;
    float* vs = kt + FaSmem<HDP>::kt;
    float* pt = vs + FaSmem<HDP>::vs;
    float* bhs = pt + FaSmem<HDP>::pt;       // [G][BQ] row bias (G > 0 only)
    float* bws = bhs + G * FA_BQ;            // [G][BQ] column bias

    const int tid = threadIdx.x;
    const int ty = tid >> 4, tx = tid & 15;
    const int r0 = ty * 4;                   // this thread's 4 query rows
    const int bhi = blockIdx.y;              // batch * heads + head
    const int row0 = blockIdx.x * FA_BQ;
    const int n_rows = min(FA_BQ, Sq - row0);
    const T* kb_ptr = k + (size_t)bhi * Skv * D;
    const T* vb_ptr = v + (size_t)bhi * Skv * D;

    {   // q tile, transposed and scaled; coalesced global reads
        const T* src = q + ((size_t)bhi * Sq + row0) * D;
        for (int idx = tid; idx < FA_BQ * HDP; idx += FA_THREADS) {
            const int r = idx / HDP, d = idx - r * HDP;
            qt[d * FA_PAD + r] = (r < n_rows && d < D)
                ? to_f<T>(src[(size_t)r * D + d]) * scale : 0.f;
        }
    }
    if (G > 0) {
        const size_t off = ((size_t)bhi * Sq + row0) * G;
        for (int idx = tid; idx < FA_BQ * G; idx += FA_THREADS) {
            const int r = idx / G, g = idx - r * G;
            const bool ok = r < n_rows;
            bhs[g * FA_BQ + r] = ok ? bh[off + idx] : 0.f;
            bws[g * FA_BQ + r] = ok ? bw[off + idx] : 0.f;
        }
    }

    float m[4], l[4], acc[4][DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -CUDART_INF_F;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
    }

    for (int kb = 0; kb < kv_valid; kb += FA_BK) {
        const int n = min(FA_BK, kv_valid - kb);
        __syncthreads();   // previous tile consumed (and q, bias staged)
        for (int idx = tid; idx < FA_BK * HDP; idx += FA_THREADS) {
            const int j = idx / HDP, d = idx - j * HDP;
            float kx = 0.f, vx = 0.f;
            if (j < n && d < D) {
                const size_t off = (size_t)(kb + j) * D + d;
                kx = to_f<T>(kb_ptr[off]);
                vx = to_f<T>(vb_ptr[off]);
            }
            kt[d * FA_PAD + j] = kx;
            vs[idx] = vx;
        }
        __syncthreads();

        // scores of 4 rows x 4 keys (keys tx*4 .. tx*4+3 of the tile)
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HDP; ++d) {
            const float4 qv = *reinterpret_cast<const float4*>(qt + d * FA_PAD + r0);
            const float4 kv = *reinterpret_cast<const float4*>(kt + d * FA_PAD + tx * 4);
            const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
            const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int jj = tx * 4 + j;
            if (jj >= n) {
#pragma unroll
                for (int i = 0; i < 4; ++i) s[i][j] = -CUDART_INF_F;
            } else if (G > 0) {
                const int key = kb + jj;
                const int ky = key / G;
                const float* bhr = bhs + ky * FA_BQ + r0;
                const float* bwr = bws + (key - ky * G) * FA_BQ + r0;
#pragma unroll
                for (int i = 0; i < 4; ++i) s[i][j] += bhr[i] + bwr[i];
            }
        }

        // online softmax; the 16 threads of a row group share lanes
        // [16 * (lane / 16), +16) of one warp
        float corr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            corr[i] = (m[i] == -CUDART_INF_F) ? 0.f : expf(m[i] - m_new);
            float rs = 0.f;
            float pr[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);   // masked keys -> 0
                rs += p;
                pr[j] = round_t<T>(p);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[i] = l[i] * corr[i] + rs;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 4; ++j) pt[(tx * 4 + j) * FA_PAD + r0 + i] = pr[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < DPT; ++c) acc[i][c] *= corr[i];
        __syncthreads();   // the p tile is complete

        for (int j = 0; j < n; ++j) {
            const float4 pv = *reinterpret_cast<const float4*>(pt + j * FA_PAD + r0);
            const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
            const float* vr = vs + j * HDP + tx * DPT;
            float va[DPT];
            if constexpr (DPT % 4 == 0) {
#pragma unroll
                for (int c = 0; c < DPT; c += 4) {
                    const float4 t = *reinterpret_cast<const float4*>(vr + c);
                    va[c] = t.x; va[c + 1] = t.y; va[c + 2] = t.z; va[c + 3] = t.w;
                }
            } else {
#pragma unroll
                for (int c = 0; c < DPT; ++c) va[c] = vr[c];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
        if (r >= n_rows) continue;
        T* op = o + ((size_t)bhi * Sq + row0 + r) * D;
        const float inv = 1.f / l[i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const int d = tx * DPT + c;
            if (d < D) op[d] = from_f<T>(acc[i][c] * inv);
        }
    }
}

template <typename T, int HDP>
static int launch_flash_attn(const void* q, const void* k, const void* v,
                             const void* bh, const void* bw, void* o, int BH,
                             int Sq, int Skv, int D, int G, int kv_valid,
                             float scale, cudaStream_t stream) {
    const size_t smem = (size_t)(FaSmem<HDP>::fixed + 2 * G * FA_BQ) * sizeof(float);
    if (smem > 232448) return kUnsupported;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(Sq, FA_BQ), BH);
    flash_attn_kernel<T, HDP><<<grid, FA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bh),
        static_cast<const float*>(bw), static_cast<T*>(o), Sq, Skv, D, G,
        kv_valid, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_d(const void* q, const void* k, const void* v,
                      const void* bh, const void* bw, void* o, int BH, int Sq,
                      int Skv, int D, int G, int kv_valid, float scale,
                      cudaStream_t stream) {
    if (D <= 0) return kUnsupported;
    if (D <= 16) return launch_flash_attn<T, 16>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, stream);
    if (D <= 32) return launch_flash_attn<T, 32>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, stream);
    if (D <= 64) return launch_flash_attn<T, 64>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, stream);
    if (D <= 128) return launch_flash_attn<T, 128>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, stream);
    return kUnsupported;
}

}  // namespace rv

// q [BH, Sq, D], k/v [BH, Skv, D]; bh/bw [BH, Sq, G] fp32 (G = 0: no bias)
extern "C" int rv_flash_attn(const void* q, const void* k, const void* v,
                             const void* bh, const void* bw, void* o, int BH,
                             int Sq, int Skv, int D, int G, int kv_valid,
                             float scale, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == rv::kBFloat16)
        return rv::dispatch_d<__nv_bfloat16>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, st);
    if (dtype == rv::kFloat32)
        return rv::dispatch_d<float>(q, k, v, bh, bw, o, BH, Sq, Skv, D, G, kv_valid, scale, st);
    return rv::kUnsupported;
}

// bf16 q [BH, Sq, D], k/v [BH, Skv, D], D % 16 == 0, D <= 128: the
// tensor-core core (flash_tc.cuh). G > 0 adds the rel-pos bias from bh/bw
// [BH, Sq, G] fp32 (Skv == G * G); out_dtype (kFloat32 or kBFloat16) is the
// output's type.
extern "C" int rv_flash_attn_tc(const void* q, const void* k, const void* v,
                                const void* bh, const void* bw, void* o, int BH, int Sq,
                                int Skv, int D, int G, int kv_valid, float scale,
                                int out_dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (out_dtype != rv::kFloat32 && out_dtype != rv::kBFloat16) return rv::kUnsupported;
    const int out_f32 = out_dtype == rv::kFloat32;
    if (G == rv::tc::kBK)   // SAM: a 64-key tile is one row of the key lattice
        return rv::tc::dispatch<false, rv::tc::kBiasRow>(D, q, k, v, o, nullptr, nullptr, 0, D,
                                                         BH, BH, Sq, Skv, kv_valid, scale, st,
                                                         bh, bw, G, out_f32);
    if (G > 0)
        return rv::tc::dispatch<false, rv::tc::kBiasAny>(D, q, k, v, o, nullptr, nullptr, 0, D,
                                                         BH, BH, Sq, Skv, kv_valid, scale, st,
                                                         bh, bw, G, out_f32);
    return rv::tc::dispatch<false>(D, q, k, v, o, nullptr, nullptr, 0, D, BH, BH, Sq, Skv,
                                   kv_valid, scale, st, nullptr, nullptr, 0, out_f32);
}
