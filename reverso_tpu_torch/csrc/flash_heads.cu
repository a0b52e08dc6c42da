// Heads-in-lanes flash attention with in-kernel 2D RoPE: two kernels.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_heads_kernel (entry
// flash_attention_heads, pallas_call at :467), the attention of every ViT
// block.
//
// What bounds it on the H100: at PE-Core-L14-336 shapes (S = 577, hd = 64)
// the [S, S] score work dominates (4 * B * H * S^2 * hd = 87 GFLOP per layer
// at B = 64) against 4 * B * S * W activation elements read or written
// once; on the tensor cores (989 TFLOP/s bf16) bytes and products bound it
// alike at B = 8 (0.0114 ms of bytes, 0.0110 ms of products), so what is
// left is the per-tile latency: the softmax between the two products,
// the RoPE pass on every K tile, and the wave tail of 640 CTAs on 132 SMs.
//
//   * bf16 with hd % 16 == 0 and hd <= 128: rv_flash_heads_tc, the
//     tensor-core core of flash_tc.cuh (wgmma for both products, K/V
//     through TMA into a six-stage mbarrier ring, heads read straight
//     out of [B, S, W] through a 3-D tensor map with a one-head box, q
//     rotated once per CTA and each K tile rotated in shared memory by
//     three producer warps in turn while the consumers work on earlier
//     tiles; the rotation's fp32 table reads are what keep it behind
//     SDPA without RoPE, see PERF.md);
//   * fp32, and bf16 at other head dims: rv_flash_heads below, on the CUDA
//     cores in fp32 (published H100 SXM peak 67 TFLOP/s at 700 W), which
//     keeps the fp32 tower exact to fp32 rounding:
//       - one CTA per (query tile, head, batch) reads its head's columns
//         straight out of [B, S, W] with stride W: no head transposes;
//       - one query row per thread: q is rotated in fp32 with the scale
//         folded in, rounded to the activation dtype and kept in registers
//         with an fp32 accumulator, so the [S, S] scores never leave the CTA;
//       - K/V tiles of 64 keys are staged in shared memory, k rotated and
//         rounded as it is staged, and read by every thread as float4
//         broadcasts;
//       - online softmax with an fp32 running max and sum per row;
//       - keys at or past kv_valid, and the ragged tail of S, are never
//         scored: the key loop stops at kv_valid and masks the last tile.
// Rounding follows the reference: p is rounded to the activation dtype
// before the PV product while the row sum uses the fp32 p.
#include "common.cuh"
#include "flash_tc.cuh"

namespace rv {

constexpr int FH_BQ = 128;   // query rows per CTA = threads per CTA
constexpr int FH_BK = 64;    // keys per shared-memory tile

// quarter-split axial rotate partner: [a, b | c, e] -> [-b, a | -e, c]
template <int HD>
__device__ __forceinline__ float rope_rotate(const float* __restrict__ cs,
                                             const float* __restrict__ sn,
                                             float x, float partner, int d) {
    constexpr int QH = HD / 4;
    const float half = ((d / QH) % 2 == 0) ? -partner : partner;
    return x * cs[d] + half * sn[d];
}

template <int HD>
__device__ __forceinline__ int rope_partner(int d) {
    constexpr int QH = HD / 4;
    return ((d / QH) % 2 == 0) ? d + QH : d - QH;
}

template <typename T, int HD>
__global__ void __launch_bounds__(FH_BQ)
flash_heads_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, T* __restrict__ o,
                   int S, int W, int kv_valid, float scale, int use_rope) {
    extern __shared__ float smem[];
    float* ks = smem;                    // [BK][HD] rotated, rounded keys
    float* vs = ks + FH_BK * HD;         // [BK][HD] values
    float* ss = vs + FH_BK * HD;         // [BK][BQ] scores of this tile

    const int tid = threadIdx.x;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int row = blockIdx.x * FH_BQ + tid;
    const bool row_ok = row < S;
    const size_t base = (size_t)b * S * W + (size_t)h * HD;

    float qr[HD];
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) { qr[d] = 0.f; acc[d] = 0.f; }
    if (row_ok) {
        const T* qp = q + base + (size_t)row * W;
        if (use_rope) {
            const float* cs = cos_t + (size_t)row * HD;
            const float* sn = sin_t + (size_t)row * HD;
#pragma unroll
            for (int d = 0; d < HD; ++d) {
                const float x = to_f<T>(qp[d]);
                const float p = to_f<T>(qp[rope_partner<HD>(d)]);
                qr[d] = round_t<T>(rope_rotate<HD>(cs, sn, x, p, d) * scale);
            }
        } else {
#pragma unroll
            for (int d = 0; d < HD; ++d) qr[d] = to_f<T>(qp[d]);
        }
    }

    float m = -CUDART_INF_F;
    float l = 0.f;
    for (int kb = 0; kb < kv_valid; kb += FH_BK) {
        const int n = min(FH_BK, kv_valid - kb);
        __syncthreads();   // previous tile fully consumed
        for (int idx = tid; idx < FH_BK * HD; idx += FH_BQ) {
            const int j = idx / HD;
            const int d = idx - j * HD;
            float kx = 0.f, vx = 0.f;
            if (j < n) {
                const size_t off = base + (size_t)(kb + j) * W;
                kx = to_f<T>(k[off + d]);
                if (use_rope) {
                    const float p = to_f<T>(k[off + rope_partner<HD>(d)]);
                    kx = round_t<T>(rope_rotate<HD>(
                        cos_t + (size_t)(kb + j) * HD,
                        sin_t + (size_t)(kb + j) * HD, kx, p, d));
                }
                vx = to_f<T>(v[off + d]);
            }
            ks[idx] = kx;
            vs[idx] = vx;
        }
        __syncthreads();

        float tmax = -CUDART_INF_F;
        for (int j = 0; j < n; ++j) {
            const float4* k4 = reinterpret_cast<const float4*>(ks + j * HD);
            float s = 0.f;
#pragma unroll
            for (int d4 = 0; d4 < HD / 4; ++d4) {
                const float4 kk = k4[d4];
                s = fmaf(qr[4 * d4 + 0], kk.x, s);
                s = fmaf(qr[4 * d4 + 1], kk.y, s);
                s = fmaf(qr[4 * d4 + 2], kk.z, s);
                s = fmaf(qr[4 * d4 + 3], kk.w, s);
            }
            if (!use_rope) s *= scale;
            ss[j * FH_BQ + tid] = s;
            tmax = fmaxf(tmax, s);
        }
        const float m_new = fmaxf(m, tmax);
        const float corr = (m == -CUDART_INF_F) ? 0.f : expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= corr;
        for (int j = 0; j < n; ++j) {
            const float p = expf(ss[j * FH_BQ + tid] - m_new);
            l += p;
            const float pr = round_t<T>(p);
            const float4* v4 = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
            for (int d4 = 0; d4 < HD / 4; ++d4) {
                const float4 vv = v4[d4];
                acc[4 * d4 + 0] = fmaf(pr, vv.x, acc[4 * d4 + 0]);
                acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1]);
                acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2]);
                acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3]);
            }
        }
        m = m_new;
    }

    if (row_ok) {
        T* op = o + base + (size_t)row * W;
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < HD; ++d) op[d] = from_f<T>(acc[d] * inv);
    }
}

template <typename T, int HD>
static int launch_flash_heads(const void* q, const void* k, const void* v,
                              const void* cos_t, const void* sin_t, void* o,
                              int B, int S, int W, int heads, int kv_valid,
                              float scale, int use_rope, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * FH_BK * HD + FH_BK * FH_BQ) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_heads_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(S, FH_BQ), heads, B);
    flash_heads_kernel<T, HD><<<grid, FH_BQ, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<T*>(o), S, W, kv_valid,
        scale, use_rope);
    return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v,
                       const void* cos_t, const void* sin_t, void* o, int B,
                       int S, int W, int heads, int kv_valid, float scale,
                       int use_rope, cudaStream_t stream) {
    switch (W / heads) {
        case 16: return launch_flash_heads<T, 16>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, stream);
        case 32: return launch_flash_heads<T, 32>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, stream);
        case 64: return launch_flash_heads<T, 64>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, stream);
        case 96: return launch_flash_heads<T, 96>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, stream);
        case 128: return launch_flash_heads<T, 128>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, stream);
        default: return kUnsupported;
    }
}

}  // namespace rv

extern "C" int rv_flash_heads(const void* q, const void* k, const void* v,
                              const void* cos_t, const void* sin_t, void* o,
                              int B, int S, int W, int heads, int kv_valid,
                              float scale, int use_rope, int dtype,
                              void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == rv::kBFloat16)
        return rv::dispatch_hd<__nv_bfloat16>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, st);
    if (dtype == rv::kFloat32)
        return rv::dispatch_hd<float>(q, k, v, cos_t, sin_t, o, B, S, W, heads, kv_valid, scale, use_rope, st);
    return rv::kUnsupported;
}

// bf16, hd % 16 == 0, hd <= 128: the tensor-core core (flash_tc.cuh)
extern "C" int rv_flash_heads_tc(const void* q, const void* k, const void* v,
                                 const void* cos_t, const void* sin_t, void* o,
                                 int B, int S, int W, int heads, int kv_valid,
                                 float scale, int use_rope, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using namespace rv::tc;
    if (heads <= 0 || W % heads) return rv::kUnsupported;
    const Call c{q, k, v, o, cos_t, sin_t, nullptr, nullptr, W / heads, 1, W, B, heads, S, S,
                 kv_valid, 0, 0, scale, st};
    if (use_rope) return dispatch<true, kOpsTma, false>(c);
    return dispatch<false, kOpsTma, false>(c);
}
