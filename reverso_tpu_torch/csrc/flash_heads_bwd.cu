// Backward of the heads-in-lanes attention (K3's gradient), on the CUDA
// cores: fp32, and bf16 at head dims the tensor-core route does not take
// (not a multiple of 16, above 128, or unaligned bases;
// ops/attention.py::heads_bwd_route). bf16 at head dims % 16 == 0 runs on
// flash_heads_bwd_tc.cu's wgmma + TMA kernels.
//
// Replaces: no TPU kernel. reverso_tpu/ops/attention.py::_flash_heads_kernel
// (K3, pallas_call at :467) has no backward: jax.grad through it fails to
// linearize, so the JAX trainer learns only on XLA's attention. This kernel
// gives the port's K3 forward (csrc/flash_tc.cuh) its gradient, so that the
// tower trains on the card's forward kernels (ops/attention.py::
// FlashHeadsFunction).
//
// What it computes, per (b, head), from q, k, v [B, S, W] before RoPE, the
// output gradient dO [B, S, W], the cos/sin tables [S, hd] and kv_valid,
// at the forward's rounding points:
//   qs = T(rot(q) * scale), ks = T(rot(k))   (RoPE; without it qs = q,
//                                             ks = k, and the scale
//                                             multiplies the scores)
//   s = qs ks^T in fp32, keys at or past kv_valid masked, P = softmax(s)
//   dP = dO v^T, D = rowsum(P * dP) (= rowsum(dO * O)), dS = P * (dP - D)
//   dq = rot^T(scale * dS ks), dk = rot^T(dS^T qs) (times the scale without
//   RoPE), dv = P^T dO,
// all in fp32 (bf16 inputs accumulate in fp32), each output rounded once
// to T. Keys at or past kv_valid get dk = dv = 0.
//
// Layout: two kernels a call, 256 threads a CTA.
//   1. dq: one CTA per (b, head, 64-query tile). A first sweep over the
//      key tiles keeps an online row max, the row sum l and the sum of
//      P * dP, which give each row's log-sum-exp and D (written to fp32
//      scratch); a second sweep recomputes s and dP, forms dS in shared
//      memory and accumulates dS ks.
//   2. dk, dv: one CTA per (b, head, 64-key tile), sweeping every query
//      tile with kernel 1's row statistics. Each CTA owns its keys' rows of
//      dk and dv, so no atomics are needed.
// Each thread holds a 4 x 4 block of a 64 x 64 score tile (rows ty + 16 a,
// columns tx + 16 c; at a row pitch of hd + 4 floats the float4 reads
// along the head dim are free of bank conflicts wherever hd / 4 is even)
// and, of the [64, hd] products, 4 rows by float4 column chunks tx + 16 cc.
// Tiles live in shared memory in fp32. RoPE is applied to q and k as they
// are loaded (each element against its partner hd / 4 away, in the
// reference's order of operations), and the transpose of the rotation to
// dq and dk before they are stored.
//
// What bounds it on the H100: five products of B H S^2 hd multiply-adds
// (s, dP, dv, dq, dk), 10 B H S^2 hd operations, against q, k, v, dO read
// and dq, dk, dv written once; at PE-L14's training shape (B = 16, S =
// 577, W = 1024, 16 heads of 64) 54.5 GFLOP, 0.055 ms at the bf16 tensor
// cores' 989 TFLOP/s, so it is bound by operations (in fp32, taken as the
// split mode's six bf16 passes, 0.041 ms at B = 2). This kernel computes
// nine products (s and dP three times over, the 64-row tiles padded past
// S) on the CUDA cores' fp32 rate (67 TFLOP/s), far from that bound: a
// simple layout that is right. Its fp32 second pass (the split mode's
// parts on the tensor cores) is ROADMAP queue 2's.
#include "common.cuh"

namespace rv {
namespace hbwd {

constexpr int kTile = 64;            // query and key rows a tile
constexpr int kThreads = 256;
constexpr int kSP = kTile + 4;       // row pitch of the 64 x 64 score tiles

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dO;
    const float* cos_t;
    const float* sin_t;
    void* dq;
    void* dk;
    void* dv;
    float* lse;
    float* dsum;
    int S, W, heads, hd, kv, pitch;
    float scale;
};

// The rotation's partner of column d and its sign: rot(x)[d] = cos[d] x[d]
// + sgn sin[d] x[p(d)], the rotate-half within each axis half
// ([a, b | c, e] -> [-b, a | -e, c], ops/rope.py).
__device__ __forceinline__ int partner(int d, int qtr, float& sgn) {
    if ((d / qtr) & 1) {
        sgn = 1.f;
        return d - qtr;
    }
    sgn = -1.f;
    return d + qtr;
}

// Rows row0 .. row0 + 63 of one head of src (row stride W) into dst
// [64][pitch] in fp32. With ROPE each value is rotated in fp32, times
// `mul`, and rounded to T, as the reference rotates q and k; rows at or
// past n_valid are zeros.
template <typename T, bool ROPE>
__device__ void load_tile(float* dst, const T* src, const Params& p, int row0, int n_valid,
                          float mul) {
    const int hd = p.hd, qtr = hd / 4;
    for (int idx = threadIdx.x; idx < kTile * hd; idx += kThreads) {
        const int r = idx / hd, d = idx - r * hd;
        const int row = row0 + r;
        float val = 0.f;
        if (row < n_valid) {
            const T* x = src + static_cast<size_t>(row) * p.W;
            val = to_f<T>(x[d]);
            if (ROPE) {
                float sgn;
                const int pd = partner(d, qtr, sgn);
                const size_t t = static_cast<size_t>(row) * hd + d;
                const float rot = __fadd_rn(__fmul_rn(val, p.cos_t[t]),
                                            __fmul_rn(sgn * to_f<T>(x[pd]), p.sin_t[t]));
                val = round_t<T>(__fmul_rn(rot, mul));
            }
        }
        dst[r * p.pitch + d] = val;
    }
}

// buf [64][pitch] (fp32 gradients of the rotated rows) -> rows row0 ..
// of dst (row stride W) in T, through the transpose of the rotation
// with ROPE: rot^T(y)[d] = cos[d] y[d] - sgn sin[p(d)] y[p(d)]. Rows at or
// past n_rows are not written.
template <typename T, bool ROPE>
__device__ void store_tile(T* dst, const float* buf, const Params& p, int row0, int n_rows) {
    const int hd = p.hd, qtr = hd / 4;
    for (int idx = threadIdx.x; idx < kTile * hd; idx += kThreads) {
        const int r = idx / hd, d = idx - r * hd;
        const int row = row0 + r;
        if (row >= n_rows) continue;
        float y = buf[r * p.pitch + d];
        if (ROPE) {
            float sgn;
            const int pd = partner(d, qtr, sgn);
            const size_t base = static_cast<size_t>(row) * hd;
            y = __fsub_rn(__fmul_rn(y, p.cos_t[base + d]),
                          __fmul_rn(sgn * buf[r * p.pitch + pd], p.sin_t[base + pd]));
        }
        dst[static_cast<size_t>(row) * p.W + d] = from_f<T>(y);
    }
}

// acc[a][c] += A[ty + 16 a] . B[tx + 16 c] over the head dim: both [64][pitch]
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A, const float* B,
                                         int pitch, int hd, int ty, int tx) {
    for (int d = 0; d < hd; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * pitch + d);
            b[i] = *reinterpret_cast<const float4*>(B + (tx + 16 * i) * pitch + d);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                             a[i].w * b[j].w;
    }
}

// over the 16 lanes that share a row (ty): lanes 0-15 and 16-31 of a warp
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s, const float4& v) {
    acc[0] += s * v.x;
    acc[1] += s * v.y;
    acc[2] += s * v.z;
    acc[3] += s * v.w;
}

// Kernel 1: dq and each query row's log-sum-exp and D, one CTA per
// (64-query tile, b * heads). Shared: q, dO, k, v tiles, dS [64][kSP].
template <typename T, bool ROPE, int NC>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
    extern __shared__ __align__(16) float sm[];
    const int tile = kTile * p.pitch;
    float* qs = sm;
    float* dos = qs + tile;
    float* ks = dos + tile;
    float* vs = ks + tile;
    float* ds = vs + tile;
    const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
    const size_t base = static_cast<size_t>(b) * p.S * p.W + static_cast<size_t>(h) * p.hd;
    const T* q = static_cast<const T*>(p.q) + base;
    const T* k = static_cast<const T*>(p.k) + base;
    const T* v = static_cast<const T*>(p.v) + base;
    const T* dO = static_cast<const T*>(p.dO) + base;
    const int q0 = blockIdx.x * kTile;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    // RoPE folds the scale into q before the rounding; without it the
    // scale multiplies the fp32 scores
    const float smul = ROPE ? 1.f : p.scale;
    load_tile<T, ROPE>(qs, q, p, q0, p.S, p.scale);
    load_tile<T, false>(dos, dO, p, q0, p.S, 1.f);
    const int n_kt = ceil_div(p.kv, kTile);

    // sweep 1: online max, row sum and sum of P * dP
    float m[4], l[4], pd[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        m[a] = -CUDART_INF_F;
        l[a] = 0.f;
        pd[a] = 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
        __syncthreads();   // the previous tile's readers are done
        load_tile<T, ROPE>(ks, k, p, kt * kTile, p.kv, 1.f);
        load_tile<T, false>(vs, v, p, kt * kTile, p.kv, 1.f);
        __syncthreads();
        float s[4][4] = {}, dp[4][4] = {};
        tile_dot(s, qs, ks, p.pitch, p.hd, ty, tx);
        tile_dot(dp, dos, vs, p.pitch, p.hd, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            float tmax = -CUDART_INF_F;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = kt * kTile + tx + 16 * c;
                s[a][c] = j < p.kv ? s[a][c] * smul : -CUDART_INF_F;
                tmax = fmaxf(tmax, s[a][c]);
            }
            const float mn = fmaxf(m[a], row_max(tmax));   // finite: a tile holds a valid key
            const float corr = expf(m[a] - mn);
            l[a] *= corr;
            pd[a] *= corr;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float e = expf(s[a][c] - mn);
                l[a] += e;
                pd[a] += e * dp[a][c];
            }
            m[a] = mn;
        }
    }
    float lse[4], dd[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const float lsum = row_sum(l[a]);
        lse[a] = m[a] + logf(lsum);
        dd[a] = row_sum(pd[a]) / lsum;
        const int row = q0 + ty + 16 * a;
        if (tx == 0 && row < p.S) {
            p.lse[static_cast<size_t>(bh) * p.S + row] = lse[a];
            p.dsum[static_cast<size_t>(bh) * p.S + row] = dd[a];
        }
    }

    // sweep 2: dS = P (dP - D), dq += dS ks
    float acc[4][NC][4] = {};
    for (int kt = 0; kt < n_kt; ++kt) {
        __syncthreads();
        load_tile<T, ROPE>(ks, k, p, kt * kTile, p.kv, 1.f);
        load_tile<T, false>(vs, v, p, kt * kTile, p.kv, 1.f);
        __syncthreads();
        float s[4][4] = {}, dp[4][4] = {};
        tile_dot(s, qs, ks, p.pitch, p.hd, ty, tx);
        tile_dot(dp, dos, vs, p.pitch, p.hd, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = kt * kTile + tx + 16 * c;
                const float pr = j < p.kv ? expf(s[a][c] * smul - lse[a]) : 0.f;
                ds[(ty + 16 * a) * kSP + tx + 16 * c] = pr * (dp[a][c] - dd[a]);
            }
        __syncthreads();
        const int nj = min(kTile, p.kv - kt * kTile);
        for (int j = 0; j < nj; ++j) {
            float dsv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) dsv[a] = ds[(ty + 16 * a) * kSP + j];
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const int c4 = tx + 16 * cc;
                if (c4 * 4 >= p.hd) continue;
                const float4 kr = *reinterpret_cast<const float4*>(ks + j * p.pitch + c4 * 4);
#pragma unroll
                for (int a = 0; a < 4; ++a) fma4(acc[a][cc], dsv[a], kr);
            }
        }
    }
    // d(rot(q)) = scale * dS ks into q's buffer, then rotated back
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
            const int c4 = tx + 16 * cc;
            if (c4 * 4 >= p.hd) continue;
            *reinterpret_cast<float4*>(qs + (ty + 16 * a) * p.pitch + c4 * 4) =
                make_float4(acc[a][cc][0] * p.scale, acc[a][cc][1] * p.scale,
                            acc[a][cc][2] * p.scale, acc[a][cc][3] * p.scale);
        }
    __syncthreads();
    store_tile<T, ROPE>(static_cast<T*>(p.dq) + base, qs, p, q0, p.S);
}

// Kernel 2: dk and dv, one CTA per (64-key tile, b * heads). Shared: k,
// v, q, dO tiles, P^T and dS^T [64 keys][kSP], the query tile's
// log-sum-exp and D.
template <typename T, bool ROPE, int NC>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
    extern __shared__ __align__(16) float sm[];
    const int tile = kTile * p.pitch;
    float* ks = sm;
    float* vs = ks + tile;
    float* qs = vs + tile;
    float* dos = qs + tile;
    float* pt = dos + tile;
    float* dst = pt + kTile * kSP;
    float* lse_s = dst + kTile * kSP;
    float* d_s = lse_s + kTile;
    const int bh = blockIdx.y, b = bh / p.heads, h = bh - b * p.heads;
    const size_t base = static_cast<size_t>(b) * p.S * p.W + static_cast<size_t>(h) * p.hd;
    T* dk = static_cast<T*>(p.dk) + base;
    T* dv = static_cast<T*>(p.dv) + base;
    const int k0 = blockIdx.x * kTile;
    if (k0 >= p.kv) {   // keys past kv_valid: dk = dv = 0
        for (int idx = threadIdx.x; idx < kTile * p.hd; idx += kThreads) {
            const int r = idx / p.hd, d = idx - r * p.hd;
            if (k0 + r >= p.S) continue;
            const size_t o = static_cast<size_t>(k0 + r) * p.W + d;
            dk[o] = from_f<T>(0.f);
            dv[o] = from_f<T>(0.f);
        }
        return;
    }
    const T* q = static_cast<const T*>(p.q) + base;
    const T* k = static_cast<const T*>(p.k) + base;
    const T* v = static_cast<const T*>(p.v) + base;
    const T* dO = static_cast<const T*>(p.dO) + base;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const float smul = ROPE ? 1.f : p.scale;
    load_tile<T, ROPE>(ks, k, p, k0, p.kv, 1.f);
    load_tile<T, false>(vs, v, p, k0, p.kv, 1.f);
    const float* lse_g = p.lse + static_cast<size_t>(bh) * p.S;
    const float* d_g = p.dsum + static_cast<size_t>(bh) * p.S;
    float dka[4][NC][4] = {}, dva[4][NC][4] = {};
    const int n_qt = ceil_div(p.S, kTile);
    for (int qt = 0; qt < n_qt; ++qt) {
        const int i0 = qt * kTile;
        __syncthreads();
        load_tile<T, ROPE>(qs, q, p, i0, p.S, p.scale);
        load_tile<T, false>(dos, dO, p, i0, p.S, 1.f);
        for (int r = threadIdx.x; r < kTile; r += kThreads) {
            lse_s[r] = i0 + r < p.S ? lse_g[i0 + r] : 0.f;
            d_s[r] = i0 + r < p.S ? d_g[i0 + r] : 0.f;
        }
        __syncthreads();
        // keys ty + 16 a, queries tx + 16 c
        float s[4][4] = {}, dp[4][4] = {};
        tile_dot(s, ks, qs, p.pitch, p.hd, ty, tx);
        tile_dot(dp, vs, dos, p.pitch, p.hd, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int i = tx + 16 * c, j = k0 + ty + 16 * a;
                const bool ok = i0 + i < p.S && j < p.kv;
                const float pr = ok ? expf(s[a][c] * smul - lse_s[i]) : 0.f;
                pt[(ty + 16 * a) * kSP + i] = pr;
                dst[(ty + 16 * a) * kSP + i] = pr * (dp[a][c] - d_s[i]);
            }
        __syncthreads();
        const int ni = min(kTile, p.S - i0);
        for (int i = 0; i < ni; ++i) {
            float pv[4], dsv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                pv[a] = pt[(ty + 16 * a) * kSP + i];
                dsv[a] = dst[(ty + 16 * a) * kSP + i];
            }
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const int c4 = tx + 16 * cc;
                if (c4 * 4 >= p.hd) continue;
                const float4 o4 = *reinterpret_cast<const float4*>(dos + i * p.pitch + c4 * 4);
                const float4 q4 = *reinterpret_cast<const float4*>(qs + i * p.pitch + c4 * 4);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    fma4(dva[a][cc], pv[a], o4);
                    fma4(dka[a][cc], dsv[a], q4);
                }
            }
        }
    }
    // dv straight out; d(rot(k)) into k's buffer, then rotated back
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
            const int c4 = tx + 16 * cc;
            if (c4 * 4 >= p.hd) continue;
            const int r = ty + 16 * a;
            if (k0 + r < p.S) {
                T* o = dv + static_cast<size_t>(k0 + r) * p.W + c4 * 4;
#pragma unroll
                for (int e = 0; e < 4; ++e) o[e] = from_f<T>(dva[a][cc][e]);
            }
            *reinterpret_cast<float4*>(ks + r * p.pitch + c4 * 4) =
                make_float4(dka[a][cc][0] * smul, dka[a][cc][1] * smul,
                            dka[a][cc][2] * smul, dka[a][cc][3] * smul);
        }
    __syncthreads();
    store_tile<T, ROPE>(dk, ks, p, k0, p.S);
}

template <typename T, bool ROPE, int NC>
int launch(const Params& p, int B, cudaStream_t stream) {
    const size_t tile = static_cast<size_t>(kTile) * p.pitch;
    const size_t smem1 = (4 * tile + kTile * kSP) * sizeof(float);
    const size_t smem2 = (4 * tile + 2 * kTile * kSP + 2 * kTile) * sizeof(float);
    auto* k1 = dq_kernel<T, ROPE, NC>;
    auto* k2 = dkv_kernel<T, ROPE, NC>;
    cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
    cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
    const dim3 grid(ceil_div(p.S, kTile), B * p.heads);
    k1<<<grid, kThreads, smem1, stream>>>(p);
    k2<<<grid, kThreads, smem2, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ROPE>
int dispatch_nc(const Params& p, int B, cudaStream_t stream) {
    if (p.hd <= 64) return launch<T, ROPE, 1>(p, B, stream);
    return launch<T, ROPE, 2>(p, B, stream);
}

template <typename T>
int dispatch(const Params& p, int B, bool rope, cudaStream_t stream) {
    return rope ? dispatch_nc<T, true>(p, B, stream) : dispatch_nc<T, false>(p, B, stream);
}

}  // namespace hbwd
}  // namespace rv

// q, k, v, dO [B, S, W] of one dtype (W = heads * hd, contiguous), cos_t,
// sin_t [S, hd] fp32 (RoPE only); dq, dk, dv [B, S, W] out; lse, dsum
// [B * heads, S] fp32 scratch. hd % 4 == 0, hd <= 128, 1 <= kv_valid <= S.
extern "C" int rv_flash_heads_bwd(const void* q, const void* k, const void* v, const void* dO,
                                  const void* cos_t, const void* sin_t, void* dq, void* dk,
                                  void* dv, void* lse, void* dsum, int B, int S, int W, int heads,
                                  int kv_valid, float scale, int use_rope, int dtype,
                                  void* stream) {
    using namespace rv::hbwd;
    if (B < 1 || S < 1 || heads < 1 || W % heads) return rv::kUnsupported;
    const int hd = W / heads;
    if (hd % 4 || hd > 128 || kv_valid < 1 || kv_valid > S) return rv::kUnsupported;
    if (use_rope && (cos_t == nullptr || sin_t == nullptr)) return rv::kUnsupported;
    const Params p{q, k, v, dO, static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                   dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(dsum),
                   S, W, heads, hd, kv_valid, hd + 4, scale};
    const auto st = static_cast<cudaStream_t>(stream);
    if (dtype == rv::kBFloat16) return dispatch<__nv_bfloat16>(p, B, use_rope != 0, st);
    if (dtype == rv::kFloat32) return dispatch<float>(p, B, use_rope != 0, st);
    return rv::kUnsupported;
}
