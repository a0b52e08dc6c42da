// The k cap and the (-score, index) order shared by the streaming top-k
// (topk_stream.cu) and the IVF probed scan (ivf_scan.cu), and the IVF
// scan's sorted state: a warp keeps one query's k best (score, index) pairs
// in shared memory, ordered by (-score, index).
#pragma once

#include "common.cuh"

namespace rv {

constexpr int TOPK_KMAX = 128;  // k cap of both kernels

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
    return sa > sb || (sa == sb && ia < ib);
}

// Warp-cooperative insert of (s, i) into the sorted list S/I of length k.
// The caller guarantees s > S[k - 1], so the insert position is < k, and
// that every listed entry of equal score has a lower index (candidates
// arrive in ascending index order), so the new entry goes after them.
__device__ __forceinline__ void warp_insert(float* S, int* I, int k, float s,
                                            int i, int lane) {
    int cnt = 0;
    for (int j = lane; j < k; j += 32) cnt += (S[j] >= s) ? 1 : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    const int pos = cnt;
    float ns[TOPK_KMAX / 32];
    int ni[TOPK_KMAX / 32];
#pragma unroll
    for (int t = 0; t < TOPK_KMAX / 32; ++t) {
        const int j = lane + 32 * t;
        ns[t] = 0.f;
        ni[t] = 0;
        if (j < k && j > pos) { ns[t] = S[j - 1]; ni[t] = I[j - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < TOPK_KMAX / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j > pos) { S[j] = ns[t]; I[j] = ni[t]; }
        if (j == pos) { S[j] = s; I[j] = i; }
    }
    __syncwarp();
}

// Inserts the lanes' candidates (s, idx0 + lane) that are `real` and beat
// the list's k-th score, in lane order. Lanes must hold ascending indices
// above every index already listed.
__device__ __forceinline__ void warp_insert_batch(float* S, int* I, int k, float s,
                                                  bool real, int idx0, int lane) {
    unsigned mask = __ballot_sync(0xffffffffu, real && s > S[k - 1]);
    while (mask) {
        const int src = __ffs(mask) - 1;
        const float s_c = __shfl_sync(0xffffffffu, s, src);
        warp_insert(S, I, k, s_c, idx0 + src, lane);
        const unsigned later = (src == 31) ? 0u : (0xffffffffu << (src + 1));
        mask = __ballot_sync(0xffffffffu, real && s > S[k - 1]) & later;
    }
}

}  // namespace rv
