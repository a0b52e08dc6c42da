// IVF probed scan (K11): per query, the k best rows of its probed clusters.
//
// Replaces: reverso_tpu/ops/ivf_scan.py:70 _ivf_scan_kernel (entry
// ivf_probe_scan, used by store/ivf.py::_ivf_search_pallas).
//
// Inputs: the cluster-sorted matrix [M, d] (bf16, fp32, or int8 scored
// against each query's two int8 digits with a per-query scale) and per
// (query, probe) the probed cluster's first row `base` and row count `cnt`
// ([Q, nprobe] int32), optionally an [M] uint8 mask over the sorted rows.
// Output: per query the k best (score, sorted-matrix row) in (-score, probe
// rank, position within the cluster) order, the order of the reference's
// probe loop (store/ivf.py::_ivf_search); -inf / -1 past the candidates.
//
// What bounds it on the H100: the rows of the distinct probed clusters,
// read once: at 1M x 1024 bf16 over all 1,024 clusters 2.05 GB (0.61 ms at
// 3.35 TB/s), against 2 d operations per (query, probe, row) on the tensor
// cores (x2 for int8's digits; 0.14 ms of bf16 products at Q = 64). A
// cluster that q queries probe must not be read q times.
//
// What the design does about it: the scan is cluster-major.
//   * the plan (launch_plan; its plain version ops/ivf_scan.py::ivf_plan)
//     inverts base / cnt on the card: the Q * nprobe (query, probe) pairs
//     grouped by cluster (a hash table of (base, cnt) keys, a count of the
//     clusters, prefix sums over them), each cluster cut into row splits
//     (single row tiles while the pairs are fewer than the SMs, a tile more
//     for every further SM's worth of pairs, up to whole clusters) and its
//     run of pairs into query blocks of N (8 .. 128, from the mean pairs a
//     cluster: ops/ivf_scan.py::ivf_geometry), giving a work table of
//     (rows, pairs, split) slices; ivf_gather_kernel then gathers the
//     probing queries' operand rows (and int8 scales) into that order. The
//     sizes come from what the host knows (Q, nprobe, cmax, M, the SMs):
//     nothing waits for the card, and every launch (plan, gather, scan,
//     merge) comes from one call. Every cluster at Q = 64 takes 1.60x K1's
//     time over the same rows (PERF.md section 6; scripts/ivf_scan_probe.py);
//   * topk_stream.cu's wgmma + TMA scan (launch_ivf_scan_wg) walks the
//     table with one wave of CTAs: each slice's row tiles are read from
//     device memory once for its whole query block and scored on the
//     tensor cores (bf16; fp32 as the split mode's six bf16 products, the
//     TPU's Precision.HIGHEST; int8 as K9's exact s32 digit dots, combined
//     with two roundings and times the pair's scale before the gate), with
//     the gated k-select per query column. Rows past the slice's end (the
//     next cluster's, inside a TMA box) and columns past its pairs never
//     enter the lists;
//   * the merge below: one CTA per query over its nprobe x splits sorted
//     lists, by (-score, probe rank, row).
#include <algorithm>

#include "topk_select.cuh"

namespace rv {

// (-score, list, row): list l = probe * splits + split orders the lists by
// probe rank and, within a probe, by split, whose row ranges ascend, so
// this is the reference's (-score, probe rank, position) order
__device__ __forceinline__ bool before(float sa, int la, int ra, float sb, int lb, int rb) {
    return sa > sb || (sa == sb && (la < lb || (la == lb && ra < rb)));
}

constexpr int kMergeThreads = 128;

// One CTA per query: merges the sorted lists of its (probe, split) slices,
// list l live for split < ceil(cnt / rps), read from part_s / part_i
// [splits][P][k] at the pair's slot (its place in the cluster-major
// order). The CTA loads every list's head into shared memory; then its
// first warp merges: each lane keeps the best head of its lists (l % 32 ==
// lane) in registers, and a round takes the warp's best, whose lane alone
// reads that list's next entry and rescans.
__global__ void __launch_bounds__(kMergeThreads)
ivf_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                 const int* __restrict__ slot, const int* __restrict__ cnt, int P, int nprobe,
                 int splits, int rps, int k, float* __restrict__ out_s,
                 int* __restrict__ out_pos) {
    extern __shared__ int heads[];
    const int L = nprobe * splits;
    float* hs = reinterpret_cast<float*>(heads);   // [L] the head's score
    int* hr = heads + L;                           // [L] its row, -1 past the list
    int* hd = hr + L;                              // [L] its place in the list
    const int qi = blockIdx.x;
    for (int p = threadIdx.x; p < nprobe; p += kMergeThreads) {
        const int pair = qi * nprobe + p, live = ceil_div(cnt[pair], rps);
        const size_t o = (size_t)slot[pair] * k;
        for (int sp = 0; sp < splits; ++sp) {
            const int l = p * splits + sp;
            hs[l] = sp < live ? part_s[(size_t)sp * P * k + o] : -CUDART_INF_F;
            hr[l] = sp < live ? part_i[(size_t)sp * P * k + o] : -1;
            hd[l] = 0;
        }
    }
    __syncthreads();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    float bs = -CUDART_INF_F;
    int bl = -1, br = -1;
    auto rescan = [&]() {
        bs = -CUDART_INF_F;
        bl = br = -1;
        for (int l = lane; l < L; l += 32)
            if (hr[l] >= 0 && (bl < 0 || before(hs[l], l, hr[l], bs, bl, br))) {
                bs = hs[l];
                bl = l;
                br = hr[l];
            }
    };
    rescan();
    for (int r = 0; r < k; ++r) {
        float ws = bs;
        int wl = bl, wr = br;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float os = __shfl_xor_sync(0xffffffffu, ws, off);
            const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
            const int orow = __shfl_xor_sync(0xffffffffu, wr, off);
            if (ol >= 0 && (wl < 0 || before(os, ol, orow, ws, wl, wr))) {
                ws = os;
                wl = ol;
                wr = orow;
            }
        }
        if (lane == 0) {
            out_s[(size_t)qi * k + r] = wl < 0 ? -CUDART_INF_F : ws;
            out_pos[(size_t)qi * k + r] = wl < 0 ? -1 : wr;
        }
        if (wl >= 0 && lane == wl % 32) {   // the list's next entry; an empty (-1) slot ends it
            const int j = ++hd[wl];
            const size_t o = ((size_t)(wl % splits) * P + slot[qi * nprobe + wl / splits]) * k + j;
            hs[wl] = j < k ? part_s[o] : -CUDART_INF_F;
            hr[wl] = j < k ? part_i[o] : -1;
            rescan();
        }
        __syncwarp();
    }
}

// ---- the plan: three launches after two memsets (launch_plan) ----
//
// The pairs with cnt > 0 insert their (base, cnt) key into an open-
// addressing table of H slots (H a power of two >= 2P); a key's first
// pair numbers its cluster (an atomic count: clusters 0 .. G - 1 in
// arrival order) and the others wait for that number; each pair takes a
// rank among its cluster's pairs (ivf_plan_insert). One CTA then sums the
// clusters' pairs and slices in order (ivf_plan_scan), and a last grid
// gives each pair its place (the live pairs first, the pairs with cnt = 0
// after them) and each cluster its slices (ivf_plan_write). Places within
// a cluster and the clusters' order follow the atomics: a pair's list
// does not depend on them (ops/ivf_scan.py::ivf_plan, the plain version,
// sorts instead).

constexpr unsigned long long kNoKey = ~0ull;
constexpr int kPlanThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned mix(unsigned long long x) {   // a 64-bit finalizer
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ull;
    x ^= x >> 33;
    return (unsigned)x;
}

// the workspace (one int32 buffer, ops/ivf_scan.py::workspace_ints): work
// [5 U], n_work [1], slot [P], qrow [P]; then, 8-byte aligned, keys [H]
// (two ints each) and gid [H] (set to all ones, kNoKey and -1); ctr [3]
// (clusters, pairs with cnt = 0 placed so far, live pairs) and g_np [P]
// (set to zeros); g_b, g_c, g_p0, g_i0 [P] per cluster; pair_g, pair_rank
// [P] per pair
struct PlanSpace {
    int *work, *n_work, *slot, *qrow, *gid, *ctr, *g_np, *g_b, *g_c, *g_p0, *g_i0, *pair_g,
        *pair_rank;
    unsigned long long* keys;
};

static PlanSpace carve(int* ws, int U, int P, int H) {
    PlanSpace s;
    s.work = ws;
    s.n_work = s.work + 5 * (size_t)U;
    s.slot = s.n_work + 1;
    s.qrow = s.slot + P;
    int* tail = s.qrow + P;
    tail += (reinterpret_cast<uintptr_t>(tail) % 8) / 4;
    s.keys = reinterpret_cast<unsigned long long*>(tail);
    s.gid = tail + 2 * (size_t)H;
    s.ctr = s.gid + H;
    s.g_np = s.ctr + 3;
    s.g_b = s.g_np + P;
    s.g_c = s.g_b + P;
    s.g_p0 = s.g_c + P;
    s.g_i0 = s.g_p0 + P;
    s.pair_g = s.g_i0 + P;
    s.pair_rank = s.pair_g + P;
    return s;
}

__global__ void __launch_bounds__(kPlanThreads)
ivf_plan_insert(const int* __restrict__ base, const int* __restrict__ cnt, int P, int H,
                PlanSpace s) {
    const int p = blockIdx.x * kPlanThreads + threadIdx.x;
    if (p >= P) return;
    const int c = cnt[p];
    int g = -1, rank = 0;
    if (c > 0) {
        const int b = base[p];
        const unsigned long long key = ((unsigned long long)(unsigned)b << 32) | (unsigned)c;
        for (int h = mix(key) & (H - 1);; h = (h + 1) & (H - 1)) {
            const unsigned long long old = atomicCAS(&s.keys[h], kNoKey, key);
            if (old == kNoKey) {   // the key's first pair: number the cluster, then publish
                g = atomicAdd(&s.ctr[0], 1);
                s.g_b[g] = b;
                s.g_c[g] = c;
                __threadfence();
                atomicExch(&s.gid[h], g);
                break;
            }
            if (old == key) {      // its number, once the first pair has published it
                while ((g = *(volatile int*)&s.gid[h]) < 0) __nanosleep(32);
                break;
            }
        }
        rank = atomicAdd(&s.g_np[g], 1);
    }
    s.pair_g[p] = g;
    s.pair_rank[p] = rank;
}

// exclusive prefix sums of a and b over the CTA's kScanThreads threads in
// thread order, their totals in *ta and *tb (tmp: 64 ints of shared memory)
__device__ void block_scan2(int& a, int& b, int* tmp, int* ta, int* tb) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    int ia = a, ib = b;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int oa = __shfl_up_sync(0xffffffffu, ia, off);
        const int ob = __shfl_up_sync(0xffffffffu, ib, off);
        if (lane >= off) {
            ia += oa;
            ib += ob;
        }
    }
    if (lane == 31) {
        tmp[warp] = ia;
        tmp[32 + warp] = ib;
    }
    __syncthreads();
    if (warp == 0) {
        int wa = tmp[lane], wb = tmp[32 + lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int oa = __shfl_up_sync(0xffffffffu, wa, off);
            const int ob = __shfl_up_sync(0xffffffffu, wb, off);
            if (lane >= off) {
                wa += oa;
                wb += ob;
            }
        }
        tmp[lane] = wa;
        tmp[32 + lane] = wb;
    }
    __syncthreads();
    a = ia - a + (warp > 0 ? tmp[warp - 1] : 0);
    b = ib - b + (warp > 0 ? tmp[32 + warp - 1] : 0);
    *ta = tmp[31];
    *tb = tmp[63];
}

__device__ __forceinline__ int slices_of(const PlanSpace& s, int g, int n_block, int rps) {
    return ceil_div(s.g_c[g], rps) * ceil_div(s.g_np[g], n_block);
}

// one CTA: each thread's run of clusters, their places and slices summed;
// the slices past the table's U rows (only a count above cmax makes any)
// are dropped
__global__ void __launch_bounds__(kScanThreads)
ivf_plan_scan(int n_block, int rps, int U, PlanSpace s) {
    __shared__ int tmp[64];
    const int G = s.ctr[0], per = ceil_div(G, kScanThreads);
    const int g0 = min(G, threadIdx.x * per), g1 = min(G, g0 + per);
    int np = 0, items = 0;
    for (int g = g0; g < g1; ++g) {
        np += s.g_np[g];
        items += slices_of(s, g, n_block, rps);
    }
    int n_live, n_items;
    block_scan2(np, items, tmp, &n_live, &n_items);
    for (int g = g0; g < g1; ++g) {
        s.g_p0[g] = np;
        s.g_i0[g] = items;
        np += s.g_np[g];
        items += slices_of(s, g, n_block, rps);
    }
    if (threadIdx.x == 0) {
        s.ctr[2] = n_live;
        s.n_work[0] = min(n_items, U);
    }
}

// thread t: pair t's place and query row; cluster t's slices (r_begin,
// r_end, q0, nq, split), a split's query blocks neighbours
__global__ void __launch_bounds__(kPlanThreads)
ivf_plan_write(int P, int nprobe, int n_block, int rps, int U, PlanSpace s) {
    const int t = blockIdx.x * kPlanThreads + threadIdx.x;
    if (t >= P) return;
    const int g = s.pair_g[t];
    const int place = g >= 0 ? s.g_p0[g] + s.pair_rank[t] : s.ctr[2] + atomicAdd(&s.ctr[1], 1);
    s.slot[t] = place;
    s.qrow[place] = t / nprobe;
    if (t >= s.ctr[0]) return;
    const int b = s.g_b[t], c = s.g_c[t], np = s.g_np[t], nqb = ceil_div(np, n_block);
    const int n = min(ceil_div(c, rps) * nqb, U - s.g_i0[t]);
    for (int local = 0; local < n; ++local) {
        const int split = local / nqb, qb = local % nqb;
        int* w = s.work + 5 * (size_t)(s.g_i0[t] + local);
        w[0] = b + split * rps;
        w[1] = min(b + c, b + (split + 1) * rps);
        w[2] = s.g_p0[t] + qb * n_block;
        w[3] = min(n_block, np - qb * n_block);
        w[4] = split;
    }
}

// The query operand in the plan's order: dst [planes][P][chunks] from src
// [planes][Q][chunks] (16-byte chunks) at row qrow[place]; the int8 scales
// likewise (scale_src [Q] -> scale_dst [P], when given).
__global__ void ivf_gather_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                  const int* __restrict__ qrow, int P, int Q, int planes,
                                  int chunks, const float* __restrict__ scale_src,
                                  float* __restrict__ scale_dst) {
    const size_t total = (size_t)planes * P * chunks;
    const size_t stride = (size_t)gridDim.x * blockDim.x;
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total; i += stride) {
        const int c = (int)(i % chunks);
        const size_t row = i / chunks;
        const int place = (int)(row % P), plane = (int)(row / P);
        dst[i] = src[((size_t)plane * Q + qrow[place]) * chunks + c];
    }
    if (scale_dst != nullptr)
        for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (size_t)P; i += stride)
            scale_dst[i] = scale_src[qrow[i]];
}

static int launch_plan(const int* base, const int* cnt, int P, int nprobe, int n_block, int rps,
                       int U, int H, const PlanSpace& s, cudaStream_t stream) {
    if (H < 2 * P || (H & (H - 1)) != 0) return kUnsupported;
    cudaError_t err = cudaMemsetAsync(s.keys, 0xff, (size_t)H * 12, stream);   // keys, gid
    if (err == cudaSuccess) err = cudaMemsetAsync(s.ctr, 0, (size_t)(3 + P) * 4, stream);
    if (err != cudaSuccess) return (int)err;
    const int blocks = ceil_div(P, kPlanThreads);
    ivf_plan_insert<<<blocks, kPlanThreads, 0, stream>>>(base, cnt, P, H, s);
    ivf_plan_scan<<<1, kScanThreads, 0, stream>>>(n_block, rps, U, s);
    ivf_plan_write<<<blocks, kPlanThreads, 0, stream>>>(P, nprobe, n_block, rps, U, s);
    return (int)cudaGetLastError();
}

// declared here, defined in topk_stream.cu beside the scan it launches
int launch_ivf_scan_wg(int mode, const void* mat, const void* q, const unsigned char* mask,
                       const float* q_scale, const int* work, const int* n_work,
                       int n_work_max, int D, int P, int M, int k, int n, float* part_s,
                       int* part_i, cudaStream_t stream);

constexpr int kMergeSmemMax = 232448;

// One K11 call: the plan, the gather of the query operand (q_src [planes][Q]
// [pitch bytes] -> q_op [planes][P][pitch bytes]; int8: scale_src [Q] ->
// scale_op [P]), the scan over the work table and the merge.
static int launch_ivf(const void* mat, const void* q_src, void* q_op, int planes, int pitch,
                      const void* scale_src, void* scale_op, const void* mask, const int* base,
                      const int* cnt, int* ws, int U, int H, int D, int M, int Q, int nprobe,
                      int k, int n, int splits, int rps, float* part_s, int* part_i,
                      float* out_s, int* out_pos, int mode, cudaStream_t stream) {
    if (k < 1 || k > TOPK_KMAX || nprobe < 1 || D < 1 || Q < 1 || splits < 1 || rps < 1 ||
        U < 1 || pitch % 16 != 0 || planes < 1)
        return kUnsupported;
    const size_t merge_smem = (size_t)nprobe * splits * 12;   // ivf_merge_kernel's heads
    if (merge_smem > kMergeSmemMax) return kUnsupported;
    const int P = Q * nprobe;
    const PlanSpace sp = carve(ws, U, P, H);
    int status = launch_plan(base, cnt, P, nprobe, n, rps, U, H, sp, stream);
    if (status != 0) return status;
    const int chunks = pitch / 16;
    const size_t total = (size_t)planes * P * chunks;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 4096);
    ivf_gather_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const uint4*>(q_src), static_cast<uint4*>(q_op), sp.qrow, P, Q, planes,
        chunks, static_cast<const float*>(scale_src), static_cast<float*>(scale_op));
    if ((status = (int)cudaGetLastError()) != 0) return status;
    if (M > 0) {   // no rows: every pair's count is 0 and the merge reads no list
        status = launch_ivf_scan_wg(mode, mat, q_op, static_cast<const unsigned char*>(mask),
                                    static_cast<const float*>(scale_op), sp.work, sp.n_work, U,
                                    D, P, M, k, n, part_s, part_i, stream);
        if (status != 0) return status;
    }
    cudaError_t err = cudaFuncSetAttribute(
        ivf_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
    if (err != cudaSuccess) return (int)err;
    ivf_merge_kernel<<<Q, kMergeThreads, merge_smem, stream>>>(part_s, part_i, sp.slot, cnt, P,
                                                               nprobe, splits, rps, k, out_s,
                                                               out_pos);
    return (int)cudaGetLastError();
}

}  // namespace rv

// The plan alone (tests hold it against its contract): base, cnt [Q *
// nprobe] int32, ws the workspace (carve, ops/ivf_scan.py::workspace_ints).
extern "C" int rv_ivf_plan(const void* base, const void* cnt, void* ws, int U, int H, int Q,
                           int nprobe, int n, int rps, void* stream) {
    const int P = Q * nprobe;
    return rv::launch_plan(static_cast<const int*>(base), static_cast<const int*>(cnt), P,
                           nprobe, n, rps, U, H, rv::carve(static_cast<int*>(ws), U, P, H),
                           static_cast<cudaStream_t>(stream));
}

// mode: kBFloat16 / kFloat32 (q_src the bf16 rows [Q, D8] / their three
// bf16 parts [3, Q, D8]) or kInt8 (q_src the digits [2, Q, D16], scale_src
// [Q]); q_op / scale_op their gathered copies ([planes, Q * nprobe, pitch]
// / [Q * nprobe]); ws the plan's workspace; part_s / part_i [splits][Q *
// nprobe][k] scratch.
extern "C" int rv_ivf_scan(const void* mat, const void* q_src, void* q_op, int planes,
                           int pitch, const void* scale_src, void* scale_op, const void* mask,
                           const void* base, const void* cnt, void* ws, int U, int H, int D,
                           int M, int Q, int nprobe, int k, int n, int splits, int rps,
                           void* part_s, void* part_i, void* out_s, void* out_pos, int mode,
                           void* stream) {
    return rv::launch_ivf(mat, q_src, q_op, planes, pitch, scale_src, scale_op, mask,
                          static_cast<const int*>(base), static_cast<const int*>(cnt),
                          static_cast<int*>(ws), U, H, D, M, Q, nprobe, k, n, splits, rps,
                          static_cast<float*>(part_s), static_cast<int*>(part_i),
                          static_cast<float*>(out_s), static_cast<int*>(out_pos), mode,
                          static_cast<cudaStream_t>(stream));
}
