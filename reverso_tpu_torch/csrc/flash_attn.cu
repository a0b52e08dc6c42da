// Flash attention over [B, H, S, D] in bf16, with an optional decomposed
// relative-position bias (SAM's global layers), on the tensor-core core of
// flash_tc.cuh.
//
// Replaces: reverso_tpu/ops/attention.py::_flash_kernel (the tiled kernel,
// pallas_call at :229, used with rel_bias by SAM's global layers) and
// ::_flash_fullseq_kernel (the whole-sequence kernel, pallas_call at :98,
// used by ViT attention past the heads-in-lanes kernel's S <= 1032 envelope
// or at head_dim % 4 != 0). Both sit behind flash_attention(); the
// fullseq/tiled split only existed to fit the TPU's VMEM. fp32 operands
// take the same core's split mode (flash_attn_split.cu).
//
// What bounds it on the H100: products. At PE-L14 at 504 px (B = 8,
// H = 16, S = 1297, D = 64, bf16) the work is 4 * B * H * S^2 * D = 55 GFLOP
// against 85 MB of q/k/v/o (0.056 ms at 989 TFLOP/s against 0.025 ms of
// bytes); at SAM ViT-B's global layers (B = 4, H = 12, S = 4096, D = 64)
// 206 GFLOP against ~300 MB of fp32 q/k/v/o (0.208 ms at the bf16 rate).
//
// rv_flash_attn_tc: bf16 q, k, v at any head dim up to 128 (zero-padded to
// a multiple of 16 in shared memory), and either dtype with SAM's rel-pos
// bias, on wgmma for QK^T and PV with P kept in registers between them, K/V
// through a four-stage mbarrier ring, the bias added to the score
// fragments inside the tile. Rows TMA can take (D % 8 == 0, 16-byte
// aligned bases) arrive through 3-D [BH, S, D] tensor maps, so a ragged
// tile zero-fills instead of reading the next head and a box past D reads
// zeros; other rows are copied by the producer warpgroup's lanes in TMA's
// swizzle. The rel-pos bias takes bf16 operands in either dtype because
// the TPU kernel does (one bf16 MXU pass for its fp32 inputs); fp32 callers
// pass bf16 copies and get an fp32 output.
#include "common.cuh"
#include "flash_tc.cuh"

// bf16 q [BH, Sq, D], k/v [BH, Skv, D], D <= 128. G > 0 adds the rel-pos
// bias from bh/bw [BH, Sq, G] fp32 (Skv == G * G); out_dtype (kFloat32 or
// kBFloat16) is the output's type.
extern "C" int rv_flash_attn_tc(const void* q, const void* k, const void* v,
                                const void* bh, const void* bw, void* o, int BH, int Sq,
                                int Skv, int D, int G, int kv_valid, float scale,
                                int out_dtype, void* stream) {
    using namespace rv::tc;
    if (out_dtype != rv::kFloat32 && out_dtype != rv::kBFloat16) return rv::kUnsupported;
    const Call c{q, k, v, o, nullptr, nullptr, bh, bw, D, 0, D, BH, BH, Sq, Skv, kv_valid,
                 G, out_dtype == rv::kFloat32, scale, static_cast<cudaStream_t>(stream)};
    const bool tma = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
    if (G > 0)
        return tma ? dispatch<false, kOpsTma, true>(c) : dispatch<false, kOpsCopy, true>(c);
    return tma ? dispatch<false, kOpsTma, false>(c) : dispatch<false, kOpsCopy, false>(c);
}
