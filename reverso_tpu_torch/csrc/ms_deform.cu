// Multi-scale deformable attention (GroundingDINO's encoder and decoder).
//
// Replaces: reverso_tpu/ops/deformable.py::_deform_kernel (entry
// ms_deform_attn_pallas, picked by DeformAttn on the TPU). That kernel
// builds dense "hat" matrices and contracts them on the MXU only because
// the v5e has no vector gather; the card gathers natively, so this is the
// gather form of MSDeformAttn with grid_sample(padding_mode="zeros",
// align_corners=False) semantics.
//
// What bounds it on the H100: each output element (b, q, h, c) reads
// L * P * 4 corner values; at GroundingDINO-tiny's encoder (B = 4,
// Lq = Lv = 13,294, H = 8, D = 32, L = P = 4) the function must move the
// value map, the sampling locations and weights and the output once
// (~190 MB in fp32) for ~2 GFLOP: memory bounds it, and the corner reads
// are scattered, so what matters is how many of them hit L1/L2.
//
// What the design does about it:
//   * one thread per output element, consecutive threads on consecutive
//     channels c of one (b, q, h): the D = 32 lanes of a warp read each
//     corner as one coalesced 128-byte row of the [B, Lv, H, D] value map,
//     and the location and weight loads are warp-wide broadcasts;
//   * neighbouring queries sample around neighbouring reference points, so
//     consecutive warps reuse each other's corner rows through L1/L2;
//   * coordinates and the weighted sum are fp32 whatever the value dtype;
//     the output is rounded once to the value dtype.
#include "common.cuh"

namespace rv {

constexpr int MSD_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MSD_THREADS)
ms_deform_kernel(const T* __restrict__ value, const int* __restrict__ levels,
                 const float* __restrict__ loc, const float* __restrict__ attw,
                 T* __restrict__ out, int Lv, int Lq, int H, int D, int L,
                 int P, size_t total) {
    const size_t idx = (size_t)blockIdx.x * MSD_THREADS + threadIdx.x;
    if (idx >= total) return;
    const int c = (int)(idx % D);
    size_t t = idx / D;
    const int h = (int)(t % H);
    t /= H;                                  // b * Lq + q
    const size_t b = t / Lq;
    const float* lp = loc + t * H * L * P * 2 + (size_t)h * L * P * 2;
    const float* wp = attw + t * H * L * P + (size_t)h * L * P;
    const size_t row = (size_t)H * D;        // stride of one value position
    const T* vb = value + b * Lv * row + (size_t)h * D + c;

    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
        const int hl = __ldg(levels + 3 * l);
        const int wl = __ldg(levels + 3 * l + 1);
        const T* vl = vb + (size_t)__ldg(levels + 3 * l + 2) * row;
        for (int p = 0; p < P; ++p) {
            const int lpi = l * P + p;
            // pixel space; clamping to [-1, size] changes no weight that
            // lands inside the map and keeps the int conversion in range
            float x = fminf(fmaxf(__ldg(lp + 2 * lpi) * wl - 0.5f, -1.f), (float)wl);
            float y = fminf(fmaxf(__ldg(lp + 2 * lpi + 1) * hl - 0.5f, -1.f), (float)hl);
            const float x0f = floorf(x), y0f = floorf(y);
            const float fx = x - x0f, fy = y - y0f;
            const int x0 = (int)x0f, y0 = (int)y0f;
            // a corner outside the map reads nothing and counts as zero
            auto corner = [&](int yy, int xx) -> float {
                return (yy >= 0 && yy < hl && xx >= 0 && xx < wl)
                    ? to_f<T>(vl[(size_t)(yy * wl + xx) * row]) : 0.f;
            };
            const float v00 = corner(y0, x0), v01 = corner(y0, x0 + 1);
            const float v10 = corner(y0 + 1, x0), v11 = corner(y0 + 1, x0 + 1);
            const float top = v00 * (1.f - fx) + v01 * fx;
            const float bot = v10 * (1.f - fx) + v11 * fx;
            acc = fmaf(__ldg(wp + lpi), top * (1.f - fy) + bot * fy, acc);
        }
    }
    out[idx] = from_f<T>(acc);
}

template <typename T>
static int launch_ms_deform(const void* value, const void* levels,
                            const void* loc, const void* attw, void* out,
                            int B, int Lv, int Lq, int H, int D, int L, int P,
                            cudaStream_t stream) {
    const size_t total = (size_t)B * Lq * H * D;
    if (total == 0) return 0;
    const size_t blocks = (total + MSD_THREADS - 1) / MSD_THREADS;
    if (blocks > 0x7fffffff) return kUnsupported;
    ms_deform_kernel<T><<<(unsigned)blocks, MSD_THREADS, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const int*>(levels),
        static_cast<const float*>(loc), static_cast<const float*>(attw),
        static_cast<T*>(out), Lv, Lq, H, D, L, P, total);
    return (int)cudaGetLastError();
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
    if (dtype == rv::kBFloat16)
        return rv::launch_ms_deform<__nv_bfloat16>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
    if (dtype == rv::kFloat32)
        return rv::launch_ms_deform<float>(value, levels, loc, attw, out, B, Lv, Lq, H, D, L, P, st);
    return rv::kUnsupported;
}
