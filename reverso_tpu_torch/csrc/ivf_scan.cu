// IVF probed scan: per-query top-k over only the probed clusters' rows.
//
// Replaces: reverso_tpu/ops/ivf_scan.py::_ivf_scan_kernel (entry
// ivf_probe_scan, used by store/ivf.py::_ivf_search_pallas).
//
// Inputs: the cluster-sorted matrix [M, d] (fp32, bf16, or int8 with the
// query split into two int8 digits [2, Q, d] and a per-query score scale),
// and per (query, probe) the probed cluster's first row `base` and row
// count `cnt` ([Q, nprobe] int32), optionally an [M] uint8 mask over the
// sorted rows. Output: per query the k best (score, sorted-matrix row) in
// (-score, probe rank, position within the cluster) order, the order of the
// reference's probe loop (store/ivf.py::_ivf_search); -inf / -1 past the
// candidates.
//
// What bounds it on the H100: the rows of the probed clusters, read once
// per (query, probe), against 2 * d operations per row (x2 for the int8
// digits): about one operation per byte, far below the card's ratio, so
// memory bounds it. At serving batch sizes the probed clusters of one
// batch overlap little, and one (query, probe) is only ~1000 rows.
//
// What the design does about it:
//   * one CTA per (query, probe) streams exactly its cluster's cnt rows,
//     never past them (the compact layout needs no padding rows); the
//     query sits in shared memory;
//   * one warp per row, 16-byte loads across the lanes, fp32 sums
//     (__dp4a for the two int8 digits: exact s32 dots, combined as
//     f32(hi) * 254 + f32(lo) with two roundings, then times the query's
//     scale, as the reference's probe loop computes them);
//   * rows are scored 32 at a time and the CTA's first warp inserts them
//     in row order into a sorted per-CTA top-k (-score, position);
//   * a second kernel merges each query's nprobe sorted partials by
//     (-score, probe rank, position): one warp per query.
#include <type_traits>

#include "topk_select.cuh"

namespace rv {

constexpr int IVF_THREADS = 256;            // 8 warps
constexpr int IVF_WARPS = IVF_THREADS / 32;
constexpr int IVF_BATCH = 32;               // rows per k-select round
constexpr int IVF_ROWS_PER_WARP = IVF_BATCH / IVF_WARPS;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// dot of one fp32 / bf16 row with the fp32 query in shared memory; `vec`:
// 16-byte loads (D a multiple of the 16-byte vector, aligned base)
template <typename T>
__device__ __forceinline__ float row_dot(const T* row, const float* qf, int D,
                                         bool vec, int lane) {
    constexpr int V = 16 / sizeof(T);
    float acc = 0.f;
    if (vec) {
        for (int i = lane * V; i < D; i += 32 * V) {
            const uint4 raw = *reinterpret_cast<const uint4*>(row + i);
            const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int e = 0; e < V; ++e) acc = fmaf(to_f<T>(x[e]), qf[i + e], acc);
        }
    } else {
        for (int i = lane; i < D; i += 32) acc = fmaf(to_f<T>(row[i]), qf[i], acc);
    }
    return warp_sum(acc);
}

// exact s32 dots of one int8 row with the two query digits
__device__ __forceinline__ void row_dot_i8(const signed char* row,
                                           const signed char* qhi,
                                           const signed char* qlo, int D,
                                           bool vec, int lane, int& hi, int& lo) {
    int h = 0, l = 0;
    if (vec) {
        for (int i = lane * 16; i < D; i += 32 * 16) {
            const int4 x = *reinterpret_cast<const int4*>(row + i);
            const int4 a = *reinterpret_cast<const int4*>(qhi + i);
            const int4 b = *reinterpret_cast<const int4*>(qlo + i);
            h = __dp4a(x.x, a.x, h); h = __dp4a(x.y, a.y, h);
            h = __dp4a(x.z, a.z, h); h = __dp4a(x.w, a.w, h);
            l = __dp4a(x.x, b.x, l); l = __dp4a(x.y, b.y, l);
            l = __dp4a(x.z, b.z, l); l = __dp4a(x.w, b.w, l);
        }
    } else {
        for (int i = lane; i < D; i += 32) {
            h += (int)row[i] * (int)qhi[i];
            l += (int)row[i] * (int)qlo[i];
        }
    }
    hi = warp_sum(h);
    lo = warp_sum(l);
}

// grid: Q * nprobe CTAs, one per (query, probe). Writes the CTA's sorted
// (score, position within the cluster) list to part_s / part_w [Q*nprobe, k].
template <int MODE>
__global__ void __launch_bounds__(IVF_THREADS)
ivf_scan_kernel(const void* __restrict__ mat_v, const void* __restrict__ q_v,
                const float* __restrict__ row_scale, const int* __restrict__ base,
                const int* __restrict__ cnt, const unsigned char* __restrict__ mask,
                int D, int Q, int nprobe, int k, bool vec,
                float* __restrict__ part_s, int* __restrict__ part_w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qf = reinterpret_cast<float*>(smem_raw);            // [D] (fp32/bf16)
    signed char* qhi = reinterpret_cast<signed char*>(smem_raw);  // [D] (int8)
    signed char* qlo = qhi + ((D + 15) / 16) * 16;                // [D] (int8)
    const size_t q_bytes = MODE == kInt8 ? 2 * (size_t)((D + 15) / 16) * 16
                                         : (size_t)D * sizeof(float);
    float* S = reinterpret_cast<float*>(smem_raw + (q_bytes + 15) / 16 * 16);  // [k]
    int* I = reinterpret_cast<int*>(S + k);                                   // [k]
    float* sc = reinterpret_cast<float*>(I + k);                              // [BATCH]

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int qp = blockIdx.x;            // query * nprobe + probe
    const int qi = qp / nprobe;
    const int b = base[qp], c = cnt[qp];

    for (int j = tid; j < k; j += IVF_THREADS) { S[j] = -CUDART_INF_F; I[j] = -1; }
    if constexpr (MODE == kInt8) {
        const signed char* qd = static_cast<const signed char*>(q_v);
        for (int i = tid; i < D; i += IVF_THREADS) {
            qhi[i] = qd[(size_t)qi * D + i];
            qlo[i] = qd[((size_t)Q + qi) * D + i];
        }
    } else {
        using T = typename std::conditional<MODE == kBFloat16, __nv_bfloat16, float>::type;
        const T* qt = static_cast<const T*>(q_v);
        for (int i = tid; i < D; i += IVF_THREADS) qf[i] = to_f<T>(qt[(size_t)qi * D + i]);
    }
    const float rs = MODE == kInt8 ? row_scale[qi] : 1.f;
    __syncthreads();

    for (int w0 = 0; w0 < c; w0 += IVF_BATCH) {
#pragma unroll
        for (int t = 0; t < IVF_ROWS_PER_WARP; ++t) {
            const int rr = warp * IVF_ROWS_PER_WARP + t;
            const int w = w0 + rr;
            float s = -CUDART_INF_F;
            if (w < c && (mask == nullptr || mask[b + w] != 0)) {   // warp-uniform
                const size_t row = (size_t)(b + w) * D;
                if constexpr (MODE == kInt8) {
                    int hi, lo;
                    row_dot_i8(static_cast<const signed char*>(mat_v) + row, qhi, qlo, D,
                               vec, lane, hi, lo);
                    s = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(hi), 254.f),
                                            __int2float_rn(lo)), rs);
                } else if constexpr (MODE == kBFloat16) {
                    s = row_dot(static_cast<const __nv_bfloat16*>(mat_v) + row, qf, D, vec,
                                lane);
                } else {
                    s = row_dot(static_cast<const float*>(mat_v) + row, qf, D, vec, lane);
                }
            }
            if (lane == 0) sc[rr] = s;
        }
        __syncthreads();
        if (warp == 0) {
            const int w = w0 + lane;
            const bool real = w < c && (mask == nullptr || mask[b + w] != 0);
            warp_insert_batch(S, I, k, sc[lane], real, w0, lane);
        }
        __syncthreads();
    }
    for (int j = tid; j < k; j += IVF_THREADS) {
        part_s[(size_t)qp * k + j] = S[j];
        part_w[(size_t)qp * k + j] = I[j];
    }
}

// One warp per query: merge its nprobe sorted partials by (-score, probe
// rank, position) and map positions to sorted-matrix rows (base + within).
__global__ void ivf_merge_kernel(const float* __restrict__ part_s,
                                 const int* __restrict__ part_w,
                                 const int* __restrict__ base, int nprobe, int k,
                                 float* __restrict__ out_s, int* __restrict__ out_pos) {
    extern __shared__ int heads[];   // [nprobe]
    const int qi = blockIdx.x;
    const int lane = threadIdx.x;
    for (int p = lane; p < nprobe; p += 32) heads[p] = 0;
    __syncwarp();
    for (int r = 0; r < k; ++r) {
        float bs = -CUDART_INF_F;
        int bp = -1, bw = -1;
        for (int p = lane; p < nprobe; p += 32) {
            const int hd = heads[p];
            if (hd >= k) continue;
            const size_t o = ((size_t)qi * nprobe + p) * k + hd;
            const int w = part_w[o];
            if (w < 0) continue;   // an empty (-inf) slot ends that list
            const float s = part_s[o];
            if (bp < 0 || better(s, p, bs, bp)) { bs = s; bp = p; bw = w; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float os = __shfl_xor_sync(0xffffffffu, bs, off);
            const int op = __shfl_xor_sync(0xffffffffu, bp, off);
            const int ow = __shfl_xor_sync(0xffffffffu, bw, off);
            if (op >= 0 && (bp < 0 || better(os, op, bs, bp))) { bs = os; bp = op; bw = ow; }
        }
        if (lane == 0) {
            out_s[(size_t)qi * k + r] = bp < 0 ? -CUDART_INF_F : bs;
            out_pos[(size_t)qi * k + r] = bp < 0 ? -1 : base[(size_t)qi * nprobe + bp] + bw;
        }
        if (bp >= 0 && lane == bp % 32) heads[bp] += 1;
        __syncwarp();
    }
}

template <int MODE>
static int launch_ivf(const void* mat, const void* q, const float* row_scale,
                      const int* base, const int* cnt, const unsigned char* mask,
                      int D, int Q, int nprobe, int k, float* part_s, int* part_w,
                      cudaStream_t stream) {
    const int elem = MODE == kInt8 ? 1 : MODE == kBFloat16 ? 2 : 4;
    const bool vec = (D * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0;
    const size_t q_bytes = MODE == kInt8 ? 2 * (size_t)((D + 15) / 16) * 16
                                         : (size_t)D * sizeof(float);
    const size_t smem = (q_bytes + 15) / 16 * 16 + (size_t)k * 8 + IVF_BATCH * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ivf_scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ivf_scan_kernel<MODE><<<Q * nprobe, IVF_THREADS, smem, stream>>>(
        mat, q, row_scale, base, cnt, mask, D, Q, nprobe, k, vec, part_s, part_w);
    return (int)cudaGetLastError();
}

// mode: kFloat32 / kBFloat16 (q [Q, D] fp32 or bf16), kInt8 (q the digits
// [2, Q, D], row_scale [Q]). part_s/part_w: [Q * nprobe, k] scratch.
static int launch_ivf_scan(const void* mat, const void* q, const void* row_scale,
                           const void* base_v, const void* cnt_v, const void* mask_v,
                           int D, int Q, int nprobe, int k, void* part_s_v,
                           void* part_w_v, void* out_s, void* out_pos, int mode,
                           cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || nprobe < 1 || D < 1 || Q < 1) return kUnsupported;
    const auto* rs = static_cast<const float*>(row_scale);
    const auto* base = static_cast<const int*>(base_v);
    const auto* cnt = static_cast<const int*>(cnt_v);
    const auto* mask = static_cast<const unsigned char*>(mask_v);
    auto* part_s = static_cast<float*>(part_s_v);
    auto* part_w = static_cast<int*>(part_w_v);
    int status;
    if (mode == kFloat32)
        status = launch_ivf<kFloat32>(mat, q, rs, base, cnt, mask, D, Q, nprobe, k,
                                      part_s, part_w, stream);
    else if (mode == kBFloat16)
        status = launch_ivf<kBFloat16>(mat, q, rs, base, cnt, mask, D, Q, nprobe, k,
                                       part_s, part_w, stream);
    else if (mode == kInt8)
        status = launch_ivf<kInt8>(mat, q, rs, base, cnt, mask, D, Q, nprobe, k,
                                   part_s, part_w, stream);
    else
        return kUnsupported;
    if (status != 0) return status;
    ivf_merge_kernel<<<Q, 32, nprobe * sizeof(int), stream>>>(
        part_s, part_w, base, nprobe, k, static_cast<float*>(out_s),
        static_cast<int*>(out_pos));
    return (int)cudaGetLastError();
}

}  // namespace rv

extern "C" int rv_ivf_scan(const void* mat, const void* q, const void* row_scale,
                           const void* base, const void* cnt, const void* mask, int D,
                           int Q, int nprobe, int k, void* part_s, void* part_w,
                           void* out_s, void* out_pos, int mode, void* stream) {
    return rv::launch_ivf_scan(mat, q, row_scale, base, cnt, mask, D, Q, nprobe, k,
                               part_s, part_w, out_s, out_pos, mode,
                               static_cast<cudaStream_t>(stream));
}
