// Hardware probe P5: a per-lane row gather, the primitive under K8.
//
// Replaces: scripts/bench_deformable.py::bench_dyngather_micro's kernel
// (its pl.pallas_call at :110): out[i, j] = the sum over it < iters (64) of
// tab[(idx[i, j] + it) mod n, j], tab [n, 128] fp32, idx [n, 128] int32,
// summed in fp32 from 0 in the order of it. The TPU kernel held the table
// in VMEM and compiled only at n <= 8 (one vector register along the
// gather dimension).
//
// What bounds it on the H100: the bytes, 3 x n x 512 (the table, the
// indices and the output once: 4.4 us at n = 256 from device memory), and
// n x 128 x iters fp32 adds (the CUDA cores' 67 TFLOP/s).
//
// What the design does about it: thread j of a row reads column j of the
// rows it gathers, so a warp's 32 lanes read 32 consecutive columns, 32
// banks, whatever rows their indices name. The table lives in shared
// memory (loaded once a CTA, 16 bytes a thread; up to 453 rows, 227 KB),
// or, for a table of K8's size (the encoder's 13,294-row value map at 800
// px), stays in device memory behind L2 (`in_smem` 0). Each CTA runs four
// rows at a time, 512 threads, over a grid of at most two CTAs an SM; each
// thread keeps its row index and wraps it at n instead of dividing.
#include "common.cuh"

namespace rv {
namespace probe_gather {

constexpr int kLanes = 128;
constexpr int kRowsAtOnce = 4;
constexpr int kThreads = kLanes * kRowsAtOnce;
constexpr int kSmemMax = 232448;

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ tab, const int* __restrict__ idx, int n, int iters,
              float* __restrict__ out) {
    extern __shared__ float4 smem_tab[];
    const float* t = tab;
    if constexpr (SMEM) {
        for (int i = threadIdx.x; i < n * kLanes / 4; i += kThreads)
            smem_tab[i] = __ldg(reinterpret_cast<const float4*>(tab) + i);
        __syncthreads();
        t = reinterpret_cast<const float*>(smem_tab);
    }
    const int j = threadIdx.x % kLanes;
    for (int i = blockIdx.x * kRowsAtOnce + threadIdx.x / kLanes; i < n;
         i += gridDim.x * kRowsAtOnce) {
        int p = idx[(size_t)i * kLanes + j] % n;
        if (p < 0) p += n;   // the floor modulo of Python and JAX
        float acc = 0.f;
        for (int it = 0; it < iters; ++it) {
            float v;
            if constexpr (SMEM) v = t[p * kLanes + j];
            else v = __ldg(t + (size_t)p * kLanes + j);
            acc = __fadd_rn(acc, v);
            if (++p == n) p = 0;
        }
        out[(size_t)i * kLanes + j] = acc;
    }
}

// tab [n, 128] fp32, idx [n, 128] int32, out [n, 128] fp32, 16-byte
// aligned; in_smem 1: the table in shared memory (n <= 453)
static int launch(const void* tab, const void* idx, int n, int iters, int in_smem, void* out,
                  cudaStream_t stream) {
    const size_t smem = in_smem ? (size_t)n * kLanes * 4 : 0;
    if (n < 1 || iters < 0 || smem > kSmemMax || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
        return kUnsupported;
    auto kernel = in_smem ? gather_kernel<true> : gather_kernel<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0, sms = 1;
    if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)err;
    const int grid = min(ceil_div(n, kRowsAtOnce), 2 * sms);
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(tab),
                                             static_cast<const int*>(idx), n, iters,
                                             static_cast<float*>(out));
    return (int)cudaGetLastError();
}

}  // namespace probe_gather
}  // namespace rv

extern "C" int rv_probe_gather(const void* tab, const void* idx, int n, int iters, int in_smem,
                               void* out, void* stream) {
    return rv::probe_gather::launch(tab, idx, n, iters, in_smem, out,
                                    static_cast<cudaStream_t>(stream));
}
