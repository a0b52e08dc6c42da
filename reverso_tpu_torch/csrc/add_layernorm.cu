// The vision tower's residual add, LayerScale and fp32 LayerNorm as one
// pass a norm site (`ops/norm.py::add_layernorm`).
//
// Replaces no TPU kernel: the JAX package leaves these steps to XLA, which
// fuses them. The port ran them as separate PyTorch passes over the
// [T, W] activations (bf16 -> fp32 copy, layer_norm in fp32, fp32 -> bf16
// copy, LayerScale's product, the residual's add), about 2.27 GB a block at
// T = 64 * 577 = 36,928, W = 1024 in PE, mostly fp32 intermediates.
//
// One launch computes, row by row,
//   r = round(x + round(round(gamma) * y))   (r = round(x + y) unscaled),
//   h = round(LN_fp32(r) * w + b),
// and writes r (the new residual, in the activation dtype) and h (the next
// sublayer's input), and where asked each row's mean and 1 / sqrt(var +
// eps) in fp32 (for the backward, as PyTorch's layer_norm saves them).
// Without y it is a LayerNorm alone: h only. Every
// rounding of the plain composition is kept, so r equals it bit for bit;
// the mean and variance come from the rounded r in fp32, two passes over
// registers, and h differs from the plain one only by the order of the
// fp32 reduction.
//
// What bounds it on the H100: bytes. x and y read, r and h written, 302 MB
// a launch at the size above (0.090 ms at 3.35 TB/s) against ~10
// operations an element. What the design does about it:
//   * a warp a row: a 1024-wide bf16 row is 2 KB, 4 vectors of 16 bytes a
//     lane (neighbouring lanes on neighbouring 16 bytes), held in
//     registers from the load to the store; the statistics are two warp
//     reductions by shuffles, no shared memory and no barrier a row;
//   * every load of a row is issued before its first use, and each SM
//     holds as many rows as its registers allow, so enough bytes are in
//     flight to hide HBM's latency;
//   * the LN weight, LN bias and gamma (rounded to the activation dtype)
//     go to shared memory once a CTA of 8 rows, laid out so that a warp
//     reads them without bank conflicts; a CTA takes its rows and ends.
// Measured at T = 36,928 with LayerScale (NVIDIA H100 80GB HBM3, 700 W):
// 0.110-0.114 ms, 79-82% of the HBM rate, where a pass that only copies
// the same bytes takes 0.106 (85%); the parameters read at a 32-byte lane
// stride (4-way bank conflicts) took 0.137; grids of one to two waves of
// CTAs walking the rows with a stride, with the next row's loads issued
// ahead or streaming cache hints, 5-10% longer than CTAs that end.
// NV, the vectors a lane holds, is a template bucket (1, 2, 4, 6, 8, 12):
// W % 8 == 0 up to 12 * 32 vectors (3072 bf16, 1536 fp32).
#include "common.cuh"

namespace rv {
namespace norm {

constexpr int kWarps = 8;    // rows a CTA takes, a warp each
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T <-> fp32
template <typename T> struct Pack;
template <> struct Pack<__nv_bfloat16> {
    static constexpr int E = 8;
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(u[i] << 16);
            f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ unsigned pack2(float a, float b) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // round to nearest even
        return *reinterpret_cast<const unsigned*>(&h);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
        uint4 v;
        v.x = pack2(f[0], f[1]);
        v.y = pack2(f[2], f[3]);
        v.z = pack2(f[4], f[5]);
        v.w = pack2(f[6], f[7]);
        *reinterpret_cast<uint4*>(p) = v;
    }
};
template <> struct Pack<float> {
    static constexpr int E = 4;
    static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    }
    static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
};

// The per-column parameters in shared memory, laid out so that a warp's
// read for its lanes' vectors j is 32 consecutive float4 (no bank
// conflicts): column i = (c, e) of vector c = j * 32 + lane goes to float4
// slot (j * E / 4 + e / 4) * 32 + lane, component e % 4.
template <int E>
__device__ __forceinline__ int param_slot(int i) {
    const int c = i / E, e = i % E;
    return (((c >> 5) * (E / 4) + e / 4) * 32 + (c & 31)) * 4 + e % 4;
}
template <int E>
__device__ __forceinline__ void load_params(const float* s, int j, int lane, float (&p)[E]) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(s)[(j * (E / 4) + q) * 32 + lane];
        p[4 * q] = v.x; p[4 * q + 1] = v.y; p[4 * q + 2] = v.z; p[4 * q + 3] = v.w;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
}

// RES: r = x + y is computed and written; SCALED: y is multiplied by gamma
// first. Without RES, x is the row normalised and r is not written.
template <typename T, int NV, bool RES, bool SCALED>
__global__ void __launch_bounds__(kWarps * 32)
add_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                     const float* __restrict__ gamma, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ r_out,
                     T* __restrict__ h_out, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int rows, int W, float eps) {
    constexpr int E = Pack<T>::E;
    constexpr int kSlots = NV * 32 * E;   // floats an array takes (`param_slot`)
    extern __shared__ __align__(16) float params[];   // w, b, gamma (rounded to T)
    float* sw = params;
    float* sb = params + kSlots;
    float* sg = params + 2 * kSlots;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        const int k = param_slot<E>(i);
        sw[k] = w[i];
        sb[k] = b[i];
        if (SCALED) sg[k] = round_t<T>(gamma[i]);
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int nvec = W / E;
    const float inv_w = 1.f / static_cast<float>(W);
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row < rows) {
        const long long base = static_cast<long long>(row) * W;
        float v[NV][E];
        float yv[RES ? NV : 1][E];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int c = j * 32 + lane;
            if (c < nvec) {
                Pack<T>::load(x + base + c * E, v[j]);
                if (RES) Pack<T>::load(y + base + c * E, yv[j]);
            }
        }
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int c = j * 32 + lane;
            if (c < nvec) {
                if (RES) {
                    float g[E];
                    if (SCALED) load_params<E>(sg, j, lane, g);
#pragma unroll
                    for (int e = 0; e < E; ++e) {
                        float p = yv[j][e];
                        // each step rounded as the plain composition rounds it
                        if (SCALED) p = round_t<T>(__fmul_rn(p, g[e]));
                        v[j][e] = round_t<T>(__fadd_rn(v[j][e], p));
                    }
                    Pack<T>::store(r_out + base + c * E, v[j]);
                }
#pragma unroll
                for (int e = 0; e < E; ++e) s += v[j][e];
            }
        }
        const float mean = warp_sum(s) * inv_w;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            if (j * 32 + lane < nvec) {
#pragma unroll
                for (int e = 0; e < E; ++e) {
                    const float d = v[j][e] - mean;
                    q = fmaf(d, d, q);
                }
            }
        }
        const float rstd = rsqrtf(warp_sum(q) * inv_w + eps);
        if (mean_out != nullptr && lane == 0) {
            mean_out[row] = mean;
            rstd_out[row] = rstd;
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int c = j * 32 + lane;
            if (c < nvec) {
                float o[E], pw[E], pb[E];
                load_params<E>(sw, j, lane, pw);
                load_params<E>(sb, j, lane, pb);
#pragma unroll
                for (int e = 0; e < E; ++e) o[e] = fmaf((v[j][e] - mean) * rstd, pw[e], pb[e]);
                Pack<T>::store(h_out + base + c * E, o);
            }
        }
    }
}

template <typename T, int NV, bool RES, bool SCALED>
int launch(const void* x, const void* y, const void* gamma, const void* w, const void* b,
           void* r, void* h, float* mean, float* rstd, int rows, int W, float eps,
           cudaStream_t st) {
    const size_t smem = 3 * NV * 32 * Pack<T>::E * sizeof(float);
    add_layernorm_kernel<T, NV, RES, SCALED><<<ceil_div(rows, kWarps), kWarps * 32, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const float*>(gamma),
        static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(r),
        static_cast<T*>(h), mean, rstd, rows, W, eps);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int NV>
int by_mode(const void* x, const void* y, const void* gamma, const void* w, const void* b,
            void* r, void* h, float* mean, float* rstd, int rows, int W, float eps,
            cudaStream_t st) {
    if (y == nullptr)
        return launch<T, NV, false, false>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (gamma == nullptr)
        return launch<T, NV, true, false>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    return launch<T, NV, true, true>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
}

template <typename T>
int by_width(const void* x, const void* y, const void* gamma, const void* w, const void* b,
             void* r, void* h, float* mean, float* rstd, int rows, int W, float eps,
             cudaStream_t st) {
    const int nv = ceil_div(W / Pack<T>::E, 32);
    if (nv <= 1) return by_mode<T, 1>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (nv <= 2) return by_mode<T, 2>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (nv <= 4) return by_mode<T, 4>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (nv <= 6) return by_mode<T, 6>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (nv <= 8) return by_mode<T, 8>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    if (nv <= 12) return by_mode<T, 12>(x, y, gamma, w, b, r, h, mean, rstd, rows, W, eps, st);
    return kUnsupported;
}

}  // namespace norm
}  // namespace rv

// x, y, r, h [rows, W] in the activation dtype (bf16 or fp32), 16-byte
// aligned, W % 8 == 0; w, b, gamma [W] fp32; mean, rstd [rows] fp32. y
// null: a LayerNorm alone (r not written); gamma null: no LayerScale; mean
// and rstd null: no statistics written.
extern "C" int rv_add_layernorm(const void* x, const void* y, const void* gamma, const void* w,
                                const void* b, void* r, void* h, void* mean, void* rstd,
                                int rows, int W, float eps, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows < 0 || W <= 0 || W % 8 != 0) return rv::kUnsupported;
    if (gamma != nullptr && y == nullptr) return rv::kUnsupported;
    if ((mean == nullptr) != (rstd == nullptr)) return rv::kUnsupported;
    float* m = static_cast<float*>(mean);
    float* rs = static_cast<float*>(rstd);
    const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                            reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(h);
    if (align % 16 != 0) return rv::kUnsupported;   // 16-byte vector loads and stores
    if (rows == 0) return 0;
    if (dtype == rv::kBFloat16)
        return rv::norm::by_width<__nv_bfloat16>(x, y, gamma, w, b, r, h, m, rs, rows, W, eps, st);
    if (dtype == rv::kFloat32)
        return rv::norm::by_width<float>(x, y, gamma, w, b, r, h, m, rs, rows, W, eps, st);
    return rv::kUnsupported;
}
