// Heads-in-lanes flash attention with in-kernel 2D RoPE, in bf16, on the
// tensor-core core of flash_tc.cuh.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_heads_kernel (entry
// flash_attention_heads, pallas_call at :467), the attention of every ViT
// block. fp32 takes the same core's split mode (flash_heads_split.cu).
//
// What bounds it on the H100: at PE-Core-L14-336 shapes (S = 577, hd = 64)
// the [S, S] score work dominates (4 * B * H * S^2 * hd = 87 GFLOP per layer
// at B = 64) against 4 * B * S * W activation elements read or written
// once; on the tensor cores (989 TFLOP/s bf16) bytes and products bound it
// alike at B = 8 (0.0114 ms of bytes, 0.0110 ms of products), so what is
// left is the per-tile latency: the softmax between the two products,
// the RoPE pass on every K tile, and the wave tail of 640 CTAs on 132 SMs.
//
// rv_flash_heads_tc: wgmma for both products, heads read straight out of
// [B, S, W] (no head transposes):
//   * hd % 16 == 0 and 16-byte aligned bases: K/V through TMA into a
//     six-stage mbarrier ring with a 3-D tensor map and a one-head box, q
//     rotated once per CTA and each K tile rotated in shared memory by
//     three producer warps in turn while the consumers work on earlier
//     tiles (the rotation's fp32 table reads are what keep it behind SDPA
//     without RoPE, see PERF.md);
//   * other head dims (hd % 4 == 0, <= 128, zero-padded to a multiple of
//     16 in shared memory) and bases TMA cannot take: the producer
//     warpgroup's lanes copy the rows, rotating each K element against its
//     partner as they load it (q likewise, by each consumer warpgroup).
// Rounding follows the reference: q and k rotated in fp32 (the scale
// folded into q) and rounded to bf16, p rounded to bf16 before the PV
// product while the row sum uses the fp32 p.
#include "common.cuh"
#include "flash_tc.cuh"

// bf16 q, k, v [B, S, W] (W = heads * hd), o [B, S, W]; cos_t, sin_t [S, hd]
// fp32, 16-byte aligned (RoPE only); lse null, or [B * heads, S] fp32: each
// query row's log-sum-exp in base 2 (flash_tc.cuh::Params::lse), for the
// backward (flash_heads_bwd_tc.cu). hd <= 128, hd % 4 == 0.
extern "C" int rv_flash_heads_tc(const void* q, const void* k, const void* v,
                                 const void* cos_t, const void* sin_t, void* o, void* lse,
                                 int B, int S, int W, int heads, int kv_valid,
                                 float scale, int use_rope, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using namespace rv::tc;
    if (heads <= 0 || W % heads) return rv::kUnsupported;
    const int hd = W / heads;
    const Call c{q, k, v, o, cos_t, sin_t, nullptr, nullptr, hd, 1, W, B, heads, S, S,
                 kv_valid, 0, 0, scale, st, static_cast<float*>(lse)};
    const bool tma = hd % 16 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                     (!use_rope || (aligned16(cos_t) && aligned16(sin_t)));
    if (use_rope)
        return tma ? dispatch<true, kOpsTma, false>(c) : dispatch<true, kOpsCopy, false>(c);
    return tma ? dispatch<false, kOpsTma, false>(c) : dispatch<false, kOpsCopy, false>(c);
}
