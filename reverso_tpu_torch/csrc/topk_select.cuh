// The k cap and the (-score, index) order shared by the streaming top-k
// (topk_stream.cu) and the IVF probed scan (ivf_scan.cu, on the same scan).
#pragma once

#include "common.cuh"

namespace rv {

constexpr int TOPK_KMAX = 128;  // k cap of both kernels

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
    return sa > sb || (sa == sb && ia < ib);
}

}  // namespace rv
