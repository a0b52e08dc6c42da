// Multi-scale deformable attention (GroundingDINO's encoder and decoder).
//
// Replaces: reverso_tpu/ops/deformable.py::_deform_kernel (entry
// ms_deform_attn_pallas, picked by DeformAttn on the TPU). That kernel
// builds dense "hat" matrices and contracts them on the MXU only because
// the v5e has no vector gather; the card gathers natively, so this is the
// gather form of MSDeformAttn with grid_sample(padding_mode="zeros",
// align_corners=False) semantics.
//
// What bounds it on the H100: each (b, q, h) reads L * P * 4 corner rows
// of D values; at GroundingDINO-tiny's encoder (B = 4, Lq = Lv = 13,294,
// H = 8, D = 32, L = P = 4) the function must move the value map, the
// sampling locations and weights and the output once (~190 MB in fp32)
// for ~2 GFLOP: memory bounds it, and the corner reads are scattered, so
// what matters is how many of them hit L1/L2 and how few instructions
// they take.
//
// What the design does about it:
//   * one warp per (b, q, h). Its L * P * 4 (sample, corner) pairs are
//     spread over the lanes, 32 at a time: a lane reads its sample's
//     (x, y) and weight (a (b, q, h)'s locations and weights are
//     contiguous, so the warp's loads are coalesced), computes the pixel
//     coordinates once in fp32 (clamped to [-1, size], as the reference),
//     and from them its corner's value row and combined weight
//     a * (1 - fx) * (1 - fy) (or the other three), or no row for a corner
//     off the map. The pairs reach the lanes that load them by __shfl_sync;
//   * vector channel loads: a group of G = D / V lanes (rounded up to a
//     power of two) reads one corner row with V-wide vectors (float4 in
//     fp32, 8 bf16 per 16 bytes; V follows D's divisibility down to 1), so
//     the warp reads 32 / G corner rows per load instruction: at D = 32
//     fp32, one sample's four corners (4 x 128 B), 16 instructions per
//     (b, q, h), against 64 scalar ones a lane in the thread-per-element
//     form. Each lane sums in fp32; the corner groups are summed by
//     __shfl_xor_sync at the end and the output leaves in vector stores,
//     rounded once to the value dtype;
//   * query-local CTAs: a CTA takes 32 consecutive queries of one (b, h)
//     (8 where that grid would not fill the SMs 8 times over: the
//     decoder), its 8 warps on 8 neighbouring queries at a time, and the
//     grid runs (query tile, h, b) with the query tile fastest, so the CTAs
//     resident together read one head's slice of the value map. The
//     encoder's queries are the map's own raster positions and sample near
//     themselves, so a CTA's corner rows repeat across its queries and hit
//     in L1.
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/ms_deform_probe.py): the
// kernel is bound by its instructions more than by its gathers: at the
// encoder's shape in fp32 it takes 0.26 of its 0.48 ms with the corner
// loads left out, and locations clustered as the encoder's save 2-8%.
#include "common.cuh"

namespace rv {

constexpr int MSD_WARPS = 8;                        // queries a CTA takes at a time
constexpr int MSD_QPW = 4;                          // queries a warp takes on a large grid
constexpr unsigned kFull = 0xffffffffu;

// V consecutive elements of T as fp32, one load (p aligned to V elements)
template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> {
    static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p));
        f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    }
    static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
};
template <> struct Vec<float, 2> {
    static __device__ __forceinline__ void load(const float* p, float (&f)[2]) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p));
        f[0] = v.x; f[1] = v.y;
    }
    static __device__ __forceinline__ void store(float* p, const float (&f)[2]) {
        *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    }
};
template <> struct Vec<float, 1> {
    static __device__ __forceinline__ void load(const float* p, float (&f)[1]) { f[0] = __ldg(p); }
    static __device__ __forceinline__ void store(float* p, const float (&f)[1]) { *p = f[0]; }
};
// bf16: V / 2 pairs in one load of V * 2 bytes
template <int V> struct Vec<__nv_bfloat16, V> {
    static_assert(V == 8 || V == 4 || V == 2, "bf16 vectors of 2, 4 or 8");
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[V]) {
        uint32_t w[V / 2];
        if constexpr (V == 8) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
        } else if constexpr (V == 4) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
            w[0] = v.x; w[1] = v.y;
        } else {
            w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
        }
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
            const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
            f[2 * i] = t.x;
            f[2 * i + 1] = t.y;
        }
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[V]) {
        uint32_t w[V / 2];
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
            const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
            w[i] = *reinterpret_cast<const uint32_t*>(&t);
        }
        if constexpr (V == 8) {
            *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
        } else if constexpr (V == 4) {
            *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
        } else {
            *reinterpret_cast<uint32_t*>(p) = w[0];
        }
    }
};
template <> struct Vec<__nv_bfloat16, 1> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[1]) {
        f[0] = __bfloat162float(p[0]);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[1]) {
        p[0] = __float2bfloat16(f[0]);
    }
};

template <typename T, int V>
__global__ void __launch_bounds__(MSD_WARPS * 32)
ms_deform_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                 const float* __restrict__ loc, const float* __restrict__ attw,
                 T* __restrict__ out, int Lv, int Lq, int H, int D, int L, int P, int qpw) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int h = blockIdx.y, b = blockIdx.z;
    const int NV = D / V;                          // vectors in a head's row
    int G = 1;                                     // lanes on one corner row
    while (G < NV && G < 32) G <<= 1;
    const int slots = 32 / G;                      // corner rows per load instruction
    const int slot = lane / G, sub = lane % G;
    const int pairs = 4 * L * P;                   // (sample, corner) pairs
    const size_t row = (size_t)H * D;              // stride of one value position
    const T* vb = value + (size_t)b * Lv * row + (size_t)h * D;

    for (int qi = 0; qi < qpw; ++qi) {
        const int q = blockIdx.x * MSD_WARPS * qpw + qi * MSD_WARPS + warp;
        if (q >= Lq) return;                       // warp-uniform; later queries are past too
        const size_t bqh = ((size_t)b * Lq + q) * H + h;
        const float* lp = loc + bqh * L * P * 2;
        const float* wp = attw + bqh * L * P;
        for (int v0 = 0; v0 < NV; v0 += G) {       // one pass unless D > 32 V
            const int vec = v0 + sub;
            float acc[V];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] = 0.f;
            for (int t0 = 0; t0 < pairs; t0 += 32) {
                // this lane's pair: corner (t0 + lane) % 4 of sample (t0 + lane) / 4
                const int t = t0 + lane;
                float cw = 0.f;
                int pos = -1;                      // value row; -1: off the map
                if (t < pairs) {
                    const int s = t >> 2, corner = t & 3, l = s / P;
                    const int hl = __ldg(levels + 3 * l), wl = __ldg(levels + 3 * l + 1);
                    // pixel space, each product and difference rounded as the
                    // reference's; clamping to [-1, size] changes no weight that
                    // lands inside the map and keeps the int conversion in range
                    const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(__ldg(lp + 2 * s), (float)wl), 0.5f),
                                                -1.f), (float)wl);
                    const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(__ldg(lp + 2 * s + 1), (float)hl), 0.5f),
                                                -1.f), (float)hl);
                    const float x0 = floorf(x), y0 = floorf(y);
                    const float fx = x - x0, fy = y - y0;
                    const int xx = (int)x0 + (corner & 1), yy = (int)y0 + (corner >> 1);
                    if (xx >= 0 && xx < wl && yy >= 0 && yy < hl) {
                        const float wx = (corner & 1) ? fx : 1.f - fx;
                        const float wy = (corner >> 1) ? fy : 1.f - fy;
                        cw = __ldg(wp + s) * wx * wy;
                        pos = __ldg(levels + 3 * l + 2) + yy * wl + xx;
                    }
                }
                const int n = min(32, pairs - t0);
                for (int i = 0; i < n; i += slots) {   // warp-uniform
                    const int src = i + slot;
                    const float w = __shfl_sync(kFull, cw, src);
                    const int p = __shfl_sync(kFull, pos, src);
                    if (src < n && p >= 0 && vec < NV) {
                        float f[V];
                        Vec<T, V>::load(vb + (size_t)p * row + (size_t)vec * V, f);
#pragma unroll
                        for (int e = 0; e < V; ++e) acc[e] = fmaf(w, f[e], acc[e]);
                    }
                }
            }
            for (int off = G; off < 32; off <<= 1)
#pragma unroll
                for (int e = 0; e < V; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
            if (slot == 0 && vec < NV) Vec<T, V>::store(out + bqh * D + (size_t)vec * V, acc);
        }
    }
}

template <typename T, int V>
static int launch_ms_deform(const void* value, const void* levels, const void* loc,
                            const void* attw, void* out, int B, int Lv, int Lq, int H, int D,
                            int L, int P, cudaStream_t stream) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    // a warp takes MSD_QPW queries where the grid still fills the SMs many
    // times over (the encoder), else one (the decoder's 900 queries)
    const long long tiles = (long long)ceil_div(Lq, MSD_WARPS * MSD_QPW) * H * B;
    const int qpw = tiles >= 8LL * sms ? MSD_QPW : 1;
    const dim3 grid(ceil_div(Lq, MSD_WARPS * qpw), H, B);
    ms_deform_kernel<T, V><<<grid, MSD_WARPS * 32, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const int*>(levels),
        static_cast<const float*>(loc), static_cast<const float*>(attw), static_cast<T*>(out),
        Lv, Lq, H, D, L, P, qpw);
    return (int)cudaGetLastError();
}

// the widest vector that D and both pointers' alignment allow
template <typename T>
static int vector_width(int D, const void* value, const void* out, int widest) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(out);
    int v = widest;
    while (v > 1 && (D % v != 0 || a % (v * sizeof(T)) != 0)) v >>= 1;
    return v;
}

}  // namespace rv

// value [B, Lv, H, D]; levels int32 [L, 3] = (h, w, start row); loc fp32
// [B, Lq, H, L, P, 2] normalized (x, y); attw fp32 [B, Lq, H, L, P];
// out [B, Lq, H * D] in the value dtype
extern "C" int rv_ms_deform(const void* value, const void* levels,
                            const void* loc, const void* attw, void* out,
                            int B, int Lv, int Lq, int H, int D, int L, int P,
                            int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((long long)B * Lq * H * D == 0) return 0;
    if (H > 65535 || B > 65535 || L <= 0 || P <= 0) return rv::kUnsupported;
    if (dtype == rv::kBFloat16) {
        using T = __nv_bfloat16;
        switch (rv::vector_width<T>(D, value, out, 8)) {
            case 8: return rv::launch_ms_deform<T, 8>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
            case 4: return rv::launch_ms_deform<T, 4>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
            case 2: return rv::launch_ms_deform<T, 2>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
            default: return rv::launch_ms_deform<T, 1>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
        }
    }
    if (dtype == rv::kFloat32) {
        switch (rv::vector_width<float>(D, value, out, 4)) {
            case 4: return rv::launch_ms_deform<float, 4>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
            case 2: return rv::launch_ms_deform<float, 2>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
            default: return rv::launch_ms_deform<float, 1>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
        }
    }
    return rv::kUnsupported;
}
