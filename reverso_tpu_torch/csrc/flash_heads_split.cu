// Heads-in-lanes flash attention with in-kernel 2D RoPE in fp32, on the
// tensor cores: the split mode of flash_tc.cuh (K3 with fp32 operands). A
// file of its own so that nvcc builds it beside flash_heads.cu's bf16
// instantiations.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_heads_kernel (entry
// flash_attention_heads, pallas_call at :467) for fp32 inputs, the fp32
// tower's attention: q rotated in fp32 with the scale folded in, k rotated
// in fp32, both products at Precision.HIGHEST (reverso_tpu/ops/topk.py:
// 42-48), p kept in fp32. Here the producer warpgroup's lanes read one
// head's fp32 K rows straight out of [B, S, W] (row stride W), rotate
// each element against its partner d / 4 away in fp32 and split it into
// three bf16 parts in the ring's stage (V the same without the rotation);
// each consumer warpgroup rotates its q rows, folds the scale in and
// splits them once; each product is the six terms lo.hi, hi.lo, mid.mid,
// mid.hi, hi.mid, hi.hi on wgmma, smallest first, each tile's PV product
// added on the CUDA cores; the output is fp32.
//
// What bounds it on the H100: products, six bf16 passes (989 / 6 = 164.8
// TFLOP/s): at the depth-2 tower's B = 2, S = 577, W = 1024, 16 heads of
// 64, 2.73 GFLOP, 0.0165 ms, against 0.0097 ms of fp32 q/k/v/o and the
// tables. Above the products it pays the split pass (with the rotation's
// partner and table reads) over every K and V element in each CTA that
// reads them, which the three-stage ring overlaps with the products.
#include "common.cuh"
#include "flash_tc.cuh"

// fp32 q, k, v [B, S, W] (W = heads * hd, any alignment), o [B, S, W]
// fp32; cos_t, sin_t [S, hd] fp32, 16-byte aligned (RoPE only); lse null,
// or [B * heads, S] fp32: each query row's log-sum-exp in base 2
// (flash_tc.cuh::Params::lse), for the backward's split mode
// (flash_heads_bwd_tc.cu). hd <= 128, hd % 4 == 0.
extern "C" int rv_flash_heads_split(const void* q, const void* k, const void* v,
                                    const void* cos_t, const void* sin_t, void* o, void* lse,
                                    int B, int S, int W, int heads, int kv_valid,
                                    float scale, int use_rope, void* stream) {
    using namespace rv::tc;
    if (heads <= 0 || W % heads) return rv::kUnsupported;
    const Call c{q, k, v, o, cos_t, sin_t, nullptr, nullptr, W / heads, 1, W, B, heads, S, S,
                 kv_valid, 0, 1, scale, static_cast<cudaStream_t>(stream),
                 static_cast<float*>(lse)};
    if (use_rope) return dispatch<true, kOpsSplit, false>(c);
    return dispatch<false, kOpsSplit, false>(c);
}
