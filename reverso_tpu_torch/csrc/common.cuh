// Shared helpers for the hand-written Hopper kernels of reverso_tpu_torch.
//
// Every kernel is templated on its element type T (__nv_bfloat16 for the
// bf16 towers and stores, float for the fp32 parity mode) and computes in
// fp32. `round_t<T>` reproduces the points where the reference rounds an
// fp32 intermediate to the activation dtype before the next product.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace rv {

// dtype codes shared with kernels.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;          // int8 rows, two int8 query digits
constexpr int kBinaryPacked = 3;  // sign bits, planar-packed uint8 rows

// launcher status for a shape the kernel was not instantiated for
constexpr int kUnsupported = -1;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);   // round to nearest even
}

template <typename T> __device__ __forceinline__ float round_t(float x) {
    return to_f<T>(from_f<T>(x));
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// fp32 max into device memory by the bits' order: as int for v >= 0, as
// unsigned for v < 0 (the target starts at -inf; the hardware probes'
// reductions across CTAs)
__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
    if (v >= 0.f)
        atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
    else
        atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

}  // namespace rv
