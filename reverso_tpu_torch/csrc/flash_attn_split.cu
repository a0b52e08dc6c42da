// fp32 flash attention over [B, H, S, D], with an optional decomposed
// relative-position bias, on the tensor cores: the split mode of
// flash_tc.cuh (K7 and K6 with fp32 operands). A file of its own so that
// nvcc builds it beside flash_attn.cu's bf16 instantiations.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_fullseq_kernel (pallas_call
// at :98) and ::_flash_kernel (pallas_call at :229) for fp32 inputs, which
// the TPU kernel multiplies at Precision.HIGHEST (reverso_tpu/ops/topk.py:
// 42-48): each fp32 operand split into three bf16 parts, six bf16 products
// summed in fp32. Here the producer warpgroup's lanes read the fp32 K and V
// rows and write their hi, mid and lo parts into the ring's stages, each
// consumer warpgroup splits its q rows (times the scale) once, p is split
// in registers, and each product is the six terms lo.hi, hi.lo, mid.mid,
// mid.hi, hi.mid, hi.hi on wgmma, smallest first, in one fp32 accumulator;
// the output is fp32.
//
// What bounds it on the H100: products, six bf16 passes (989 / 6 = 164.8
// TFLOP/s for fp32-accurate products): K7 in fp32 at B = 2, H = 16, S =
// 1297, D = 64 is 13.8 GFLOP, 0.0836 ms of products against 0.0127 ms of
// fp32 q/k/v/o; SAM's global layer with fp32 operands (B = 4, H = 12, S =
// 4096, D = 64) 206 GFLOP, 1.25 ms. The CUDA-core kernel it replaces ran
// them as scalar FMAs at 29% of the 67 TFLOP/s fp32 rate. Above the
// products the split mode pays the split pass over every K and V element in
// each CTA (overlapped with the products by the ring) and p's split
// between the two products.
#include "common.cuh"
#include "flash_tc.cuh"

// fp32 q [BH, Sq, D], k/v [BH, Skv, D], D <= 128 (any alignment), fp32 o.
// G > 0 adds the rel-pos bias from bh/bw [BH, Sq, G] fp32 (Skv == G * G).
extern "C" int rv_flash_attn_split(const void* q, const void* k, const void* v,
                                   const void* bh, const void* bw, void* o, int BH, int Sq,
                                   int Skv, int D, int G, int kv_valid, float scale,
                                   void* stream) {
    using namespace rv::tc;
    const Call c{q, k, v, o, nullptr, nullptr, bh, bw, D, 0, D, BH, BH, Sq, Skv, kv_valid,
                 G, 1, scale, static_cast<cudaStream_t>(stream)};
    if (G > 0) return dispatch<false, kOpsSplit, true>(c);
    return dispatch<false, kOpsSplit, false>(c);
}
