// Fused transformer MLP: y = act(x @ W1^T + b1) @ W2^T + b2.
//
// Replaces: reverso_tpu/ops/fused_mlp.py::_fused_mlp_kernel (entry
// fused_mlp), the MLP of every ViT block, in bf16 and in fp32 (the parity
// mode, whose products the TPU kernel takes at Precision.HIGHEST), and
// ::_fused_mlp_int8_kernel (K5, further below). Weights come in PyTorch
// Linear layout: W1 [H, W], W2 [W, H].
//
// What bounds it on the H100: 4 * T * W * H FLOPs (77.4 GFLOP at T = 4616,
// PE-L14's 1024 -> 4096 -> 1024: 0.078 ms at 989 TFLOP/s) against 2 * T * W
// activation elements and 2 * W * H weight elements (27.6 MB, 0.008 ms at
// 3.35 TB/s). So it is compute-bound, and the rate comes from the tensor
// cores. In fp32 every product is six bf16 products of three-way split
// operands, so the bound is 989 / 6 = 164.8 TFLOP/s: 0.470 ms at T = 4616.
//
// Three modes, chosen by dtype (ops/fused_mlp.py::mlp_route):
//   * bf16: two launches of one wgmma + TMA GEMM kernel with fused
//     epilogues (rv_fused_mlp_tc, below), h = bf16(act(x W1^T + b1))
//     written to a bf16 scratch and read back by the second product; at a
//     width or hidden size that is not a multiple of 8 the wrapper pads
//     x and the weights with the split pass's one-part form
//     (rv_split_parts) and the GEMMs compute the zero pad along;
//   * fp32 (the parity mode): the same GEMM kernel on three bf16 parts a
//     value (rv_fused_mlp_split): the split pass writes x's parts, GEMM 1
//     writes h's parts straight from its epilogue (no fp32 h reaches
//     device memory) and GEMM 2 reads them; the weights' parts come from
//     the split pass once per tower (the model's cache) or per call;
//   * int8 (K5, rv_fused_mlp_int8): x quantized per row, then two s8
//     wgmma + TMA GEMMs, the first re-quantizing h per (row, 512-wide
//     chunk) in its epilogue, the second dequantizing per chunk.
#include "common.cuh"
#include "hopper.cuh"

namespace rv {

constexpr int kGelu = 0;
constexpr int kQuickGelu = 1;

// 8 fp32 values of one output row -> T at y (16-byte aligned when `vec`)
__device__ __forceinline__ void store8(__nv_bfloat16* y, const float (&v)[8], int n, bool vec) {
    if (vec) {
        uint4 out;
        out.x = tc::pack_bf16(v[0], v[1]);
        out.y = tc::pack_bf16(v[2], v[3]);
        out.z = tc::pack_bf16(v[4], v[5]);
        out.w = tc::pack_bf16(v[6], v[7]);
        *reinterpret_cast<uint4*>(y) = out;
        return;
    }
    for (int e = 0; e < 8 && e < n; ++e) y[e] = from_f<__nv_bfloat16>(v[e]);
}
__device__ __forceinline__ void store8(float* y, const float (&v)[8], int n, bool vec) {
    if (vec) {
        *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(y + 4) = make_float4(v[4], v[5], v[6], v[7]);
        return;
    }
    for (int e = 0; e < 8 && e < n; ++e) y[e] = v[e];
}

// ---- the split pass ------------------------------------------------------------
//
// Rows of x [rows, cols] (fp32 or bf16) into bf16 parts [PARTS][out_rows]
// [pitch]: hi, mid and lo of the fp32 values (PARTS = 3: hi = bf16(x), mid
// = bf16(x - hi), lo = bf16(x - hi - mid), as ops/split.py::split3), or the
// values rounded to bf16 (PARTS = 1); zeros past the rows and columns, so
// that TMA reads whole 16-byte rows and a product over the pad adds
// nothing. A thread takes 8 columns of a row: one or two 16-byte loads
// where the rows allow, one 16-byte store a part. Bound by bytes: 4 read
// and 6 written an fp32 element (0.014 ms for x at T = 4616, W = 1024).
constexpr int kSplitThreads = 256;

template <typename T, int PARTS>
__global__ void __launch_bounds__(kSplitThreads)
split_parts_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ out, int rows,
                   int cols, int out_rows, int pitch, bool vec) {
    const int units = pitch / 8;
    const long long idx = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
    if (idx >= (long long)out_rows * units) return;
    const int r = (int)(idx / units), c = (int)(idx % units) * 8;
    const T* row = x + (size_t)r * cols;
    float v[8];
    if (r < rows && vec && c + 8 <= cols) {
        tc::load8(row + c, v);
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = r < rows && c + e < cols ? to_f<T>(row[c + e]) : 0.f;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r * pitch + c);
    if constexpr (PARTS == 3) {
        uint4 hi, mid, lo;
        tc::split2(v[0], v[1], hi.x, mid.x, lo.x);
        tc::split2(v[2], v[3], hi.y, mid.y, lo.y);
        tc::split2(v[4], v[5], hi.z, mid.z, lo.z);
        tc::split2(v[6], v[7], hi.w, mid.w, lo.w);
        const size_t part = (size_t)out_rows * units;   // 16-byte units of one part
        dst[0] = hi;
        dst[part] = mid;
        dst[2 * part] = lo;
    } else {
        *dst = make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
                          tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
    }
}

// The current device's SM count, looked up once per device: a process may
// launch on several cards (a mesh), each under its own current device.
static int current_sms(int* sms) {
    constexpr int kMaxDevices = 64;
    static int by_device[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices && by_device[dev] > 0) {
        *sms = by_device[dev];
        return 0;
    }
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) by_device[dev] = *sms;
    return 0;
}

static int launch_split_parts(const void* x, void* out, int rows, int cols, int out_rows,
                              int pitch, int parts, int dtype, cudaStream_t stream) {
    if (rows < 0 || cols <= 0 || out_rows < rows || pitch < cols || pitch % 8 ||
        reinterpret_cast<uintptr_t>(out) % 16)
        return kUnsupported;
    const long long n = (long long)out_rows * (pitch / 8);
    if (n == 0) return 0;
    const int blocks = (int)((n + kSplitThreads - 1) / kSplitThreads);
    const int size = dtype == kFloat32 ? 4 : 2;
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && cols * size % 16 == 0;
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (dtype == kFloat32 && parts == 3)
        split_parts_kernel<float, 3><<<blocks, kSplitThreads, 0, stream>>>(
            static_cast<const float*>(x), o, rows, cols, out_rows, pitch, vec);
    else if (dtype == kFloat32 && parts == 1)
        split_parts_kernel<float, 1><<<blocks, kSplitThreads, 0, stream>>>(
            static_cast<const float*>(x), o, rows, cols, out_rows, pitch, vec);
    else if (dtype == kBFloat16 && parts == 1)
        split_parts_kernel<__nv_bfloat16, 1><<<blocks, kSplitThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), o, rows, cols, out_rows, pitch, vec);
    else
        return kUnsupported;
    return (int)cudaGetLastError();
}

// ---- the GEMMs on the tensor cores: bf16 and fp32 as split parts ---------------
//
// The MLP as two launches of one hand-written GEMM kernel, C = epilogue(A
// B^T), A [M, K] and B [N, K] row-major, so both operands are K-major
// (PyTorch's Linear layout: no transposes):
//   GEMM 1: h = act(x W1^T + b1), [T, H], scratch the wrapper allocates;
//   GEMM 2: y = h W2^T + b2, [T, W].
// In bf16 (PARTS = 1) h is rounded to bf16; the reference rounds h to bf16
// before the second product too (reverso_tpu/ops/fused_mlp.py:81), so its
// round trip through device memory changes no result; it costs 2 * T * H
// * 2 bytes (75.6 MB at T = 4616, H = 4096: 0.023 ms at 3.35 TB/s against
// the products' 0.078 ms at 989 TFLOP/s), and the products, not the
// bytes, bound the MLP.
//
// In fp32 (PARTS = 3, the split mode) the operands are the split pass's
// bf16 parts [3][rows][pitch] and each product is the six bf16 products
// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid and hi.hi (hopper.cuh::split_part,
// smallest first; the three dropped are below 2^-23 of the product), the
// TPU kernel's Precision.HIGHEST. h stays fp32 (the reference rounds it to
// x's dtype, fp32): GEMM 1's epilogue adds b1 in fp32, applies the
// activation and writes h's three parts (3 * 2 bytes an element where fp32
// h and a second split pass would move 4 + 4 + 6), which GEMM 2 reads
// through TMA; GEMM 2's epilogue adds b2 and stores fp32 y.
//
// Design of one CTA (one 128 x BN tile of C):
//   * a producer warp, one thread of which brings 128 x BK A tiles and
//     BN x BK B tiles (each of their parts: 3-D maps over [3][rows][pitch]
//     in the split mode) through TMA (128-byte swizzle at BK = 64 in bf16,
//     64-byte at BK = 32 in the split mode, mbarrier completion) into a
//     ring of STAGES stages; rows past M (T = 4616 = 36 * 128 + 8),
//     columns past N and a K past the last whole step read zeros from the
//     hardware, so nothing is padded in memory beyond 16-byte row pitches;
//   * two consumer warpgroups of 64 rows each run wgmma m64nBNk16 (bf16 in,
//     fp32 accumulate, both operands from shared memory) over the ring. In
//     bf16 one product group is in flight while the stage before it is
//     released to the producer. In the split mode a step's six products
//     land in a fresh accumulator that the CUDA cores add to the running
//     fp32 tile (round to nearest): the tensor cores' fp32 sums do not
//     round to nearest, and in one accumulator their error grows with the
//     steps summed (flash_tc.cuh measured 1.1e-5 over 64 tiles against
//     1.6e-6 with per-tile sums); K here is 1024 and 4096;
//   * a consumer's accumulator takes BN / 2 registers a thread (ptxas: 154
//     registers a thread at BN = 256, 90 at BN = 128, no spills; the split
//     mode, with its step accumulator beside it, 146 at BN = 128);
//   * the epilogue parks the fp32 tile in the ring's shared memory, then
//     each thread takes 8 adjacent columns of a row: the fp32 bias, the
//     activation (GEMM 1), and one 16-byte store of bf16 (or one a part,
//     or two of fp32); rows past M and columns past N are masked.
//     (Applying the activation straight from the accumulator fragments
//     unrolled erff over all 128 registers of a thread: GEMM 1 took 0.227
//     ms at T = 4616 against 0.101 without the activation,
//     scripts/mlp_tc_probe.py on the H100.)
namespace mlp_tc {

using namespace tc;

constexpr int kBM = 128;     // rows of a CTA tile: two consumer warpgroups of 64
constexpr int kBK = 64;      // bf16 reduction step: one 128-byte swizzle atom
constexpr int kNoAct = -1;   // GEMM 2: the bias only

constexpr int kThreads = 2 * kWgThreads + 32;   // two consumer warpgroups, one producer warp

// what the epilogue stores: bf16 C (the bf16 MLP), the three bf16 parts of
// fp32 C (the split mode's GEMM 1: h), fp32 C (the split mode's GEMM 2: y)
constexpr int kOutBf16 = 0, kOutParts = 1, kOutF32 = 2;

// A tile shape: BN output columns, a ring of STAGES stages, PARTS bf16 parts
// an operand value (3: the split mode, whose stage holds every part of a
// 32-deep step, 48 KB at BN = 128)
template <int BN, int STAGES, int PARTS = 1>
struct GemmCfg {
    static constexpr int kBN = BN, kStages = STAGES, kParts = PARTS;
    static constexpr int BK = PARTS == 3 ? 32 : kBK;           // reduction step
    static constexpr uint64_t LAYOUT = BK == 64 ? 1 : 2;       // 128- or 64-byte swizzle
    static constexpr uint32_t SBO = 8 * BK * 2;                // 8 rows of a swizzle atom
    static constexpr int A_BYTES = kBM * BK * 2;               // one part of a stage's A tile
    static constexpr int B_BYTES = BN * BK * 2;
    static constexpr int STAGE_BYTES = PARTS * (A_BYTES + B_BYTES);
    static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
    static_assert(SMEM <= 232448, "shared memory of a CTA");
    static_assert(BN % 64 == 0 && BN <= 256, "wgmma N and the TMA box");
    static_assert(PARTS == 1 || PARTS == 3, "bf16 or split parts");
};

// gelu through the Abramowitz & Stegun 7.1.26 erf (|err| <= 1.5e-7), as the
// TPU kernel computes it (reverso_tpu/ops/fused_mlp.py:47), with the SFU's
// reciprocal and exponential; quick_gelu as x * sigmoid(1.702 x). Within a
// few 1e-7 of the exact forms, far below h's bf16 rounding and the fp32
// mode's 1e-4 gate.
__device__ __forceinline__ float act_fast(float x, int act) {
    if (act == kQuickGelu) return x * __fdividef(1.f, 1.f + __expf(-1.702f * x));
    const float z = x * 0.70710678118654752f, az = fabsf(z);
    const float t = __fdividef(1.f, fmaf(0.3275911f, az, 1.f));
    float poly = fmaf(t, 1.061405429f, -1.453152027f);
    poly = fmaf(t, poly, 1.421413741f);
    poly = fmaf(t, poly, -0.284496736f);
    poly = fmaf(t, poly, 0.254829592f) * t;
    const float erf = copysignf(fmaf(-poly, __expf(-az * az), 1.f), z);
    const float hx = 0.5f * x;
    return fmaf(hx, erf, hx);
}

// One CTA of the GEMM: C [m, n] = epilogue(A [m, k] B [n, k]^T), C's rows
// at a pitch of ldc elements; the bias [n_valid] and the activation apply
// to the first n_valid columns, and in the parts mode the columns from
// n_valid to n are stored as zeros (h's pad, read by GEMM 2 against zero
// weights)
template <class Cfg, int OUT>
__device__ __forceinline__ void gemm_cta(const CUtensorMap* amap, const CUtensorMap* bmap,
                                         const void* bias, void* c, int m, int n, int n_valid,
                                         int ldc, int k, int act) {
    constexpr int BN = Cfg::kBN, STAGES = Cfg::kStages, PARTS = Cfg::kParts, BK = Cfg::BK;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* as = base;                                   // [STAGES][PARTS][128][BK] bf16, swizzled
    uint8_t* bs = as + STAGES * PARTS * Cfg::A_BYTES;     // [STAGES][PARTS][BN][BK]
    uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * PARTS * Cfg::B_BYTES);
    uint64_t* empty = full + STAGES;              // the consumers' 8 warps are done

    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
    const int n_k = ceil_div(k, BK);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer warp: lane 0 keeps the ring full ----
        if (tid == 0) {
            for (int j = 0; j < n_k; ++j) {
                const int s = j % STAGES;
                mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], Cfg::STAGE_BYTES);
                if constexpr (PARTS == 1) {
                    tma_load_2d(as + s * Cfg::A_BYTES, amap, &full[s], j * BK, m0);
                    tma_load_2d(bs + s * Cfg::B_BYTES, bmap, &full[s], j * BK, n0);
                } else {
#pragma unroll
                    for (int p = 0; p < PARTS; ++p) {
                        tma_load_3d(as + (s * PARTS + p) * Cfg::A_BYTES, amap, &full[s], j * BK,
                                    m0, p);
                        tma_load_3d(bs + (s * PARTS + p) * Cfg::B_BYTES, bmap, &full[s], j * BK,
                                    n0, p);
                    }
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int warp = tid / 32, lane = tid % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t a0 = smem_addr(as) + wg * 64 * BK * 2;
    const uint32_t b0 = smem_addr(bs);
    if constexpr (PARTS == 1) {
        for (int j = 0; j < n_k; ++j) {
            const int s = j % STAGES;
            mbar_wait(&full[s], (j / STAGES) & 1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)   // k16 steps: 32 bytes into the swizzled rows
                WgmmaSS<BN>::run(acc, gmma_desc(a0 + s * Cfg::A_BYTES + kk * 32, 16, Cfg::SBO, Cfg::LAYOUT),
                                 gmma_desc(b0 + s * Cfg::B_BYTES + kk * 32, 16, Cfg::SBO, Cfg::LAYOUT), 1);
            wgmma_commit();
            wgmma_wait<1>();   // step j - 1's products are done: release its stage
            if (j > 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
            }
        }
        wgmma_wait<0>();
        fence_operand(acc);
    } else {
        float step[BN / 2];   // one step's six products, started afresh each step
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) step[i] = 0.f;
        for (int j = 0; j < n_k; ++j) {
            const int s = j % STAGES;
            mbar_wait(&full[s], (j / STAGES) & 1);
            wgmma_fence();
#pragma unroll
            for (int t = 0; t < kSplitTerms; ++t)
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    WgmmaSS<BN>::run(
                        step,
                        gmma_desc(a0 + (s * PARTS + split_part(t, 0)) * Cfg::A_BYTES + kk * 32,
                                  16, Cfg::SBO, Cfg::LAYOUT),
                        gmma_desc(b0 + (s * PARTS + split_part(t, 1)) * Cfg::B_BYTES + kk * 32,
                                  16, Cfg::SBO, Cfg::LAYOUT),
                        t > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(step);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], step[i]);
        }
    }

    // ---- epilogue ----
    // (1) both consumer warpgroups are done with the ring (every stage was
    // loaded and consumed), so it takes the fp32 tile, [128][BN + 8] (the
    // pad keeps a warp's fragment stores off shared bank conflicts)
    constexpr int LDC = BN + 8;
    static_assert(kBM * LDC * 4 <= STAGES * Cfg::STAGE_BYTES, "C tile fits the ring");
    float* ct = reinterpret_cast<float*>(base);
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = wg * 64 + warp * 16 + lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            const int col = 8 * i + 2 * t;
            *reinterpret_cast<float2*>(ct + r * LDC + col) = make_float2(acc[4 * i], acc[4 * i + 1]);
            *reinterpret_cast<float2*>(ct + (r + 8) * LDC + col) =
                make_float2(acc[4 * i + 2], acc[4 * i + 3]);
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // (2) each thread takes 8 adjacent columns of a row at a time: fp32 bias,
    // activation, the store (a warp writes whole row segments); a short
    // loop, so the activation's code stays small
    constexpr int TPR = BN / 8;                 // threads per row
    constexpr int ROWS = 2 * kWgThreads / TPR;  // rows per pass
    const int ctid = wg * kWgThreads + tid;
    const int c8 = (ctid % TPR) * 8, col = n0 + c8;
    if (col >= n) return;   // bf16 and parts: n % 8 == 0, a group of 8 is in or out whole
    float bv[8];
    if constexpr (OUT == kOutBf16) {
        const __nv_bfloat16* b16 = static_cast<const __nv_bfloat16*>(bias);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 b2 =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b16 + col + 2 * e));
            bv[2 * e] = b2.x;
            bv[2 * e + 1] = b2.y;
        }
    } else {
        const float* b32 = static_cast<const float*>(bias);
#pragma unroll
        for (int e = 0; e < 8; ++e) bv[e] = col + e < n_valid ? b32[col + e] : 0.f;
    }
#pragma unroll 2
    for (int r = ctid / TPR; r < kBM && m0 + r < m; r += ROWS) {
        const float4 lo = *reinterpret_cast<const float4*>(ct + r * LDC + c8);
        const float4 hi = *reinterpret_cast<const float4*>(ct + r * LDC + c8 + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const size_t off = (size_t)(m0 + r) * ldc + col;
        if constexpr (OUT == kOutBf16) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                v[e] += bv[e];
                if (act != kNoAct) v[e] = act_fast(v[e], act);
            }
            uint4 out;
            out.x = pack_bf16(v[0], v[1]);
            out.y = pack_bf16(v[2], v[3]);
            out.z = pack_bf16(v[4], v[5]);
            out.w = pack_bf16(v[6], v[7]);
            *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(c) + off) = out;
        } else if constexpr (OUT == kOutParts) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                v[e] = col + e < n_valid ? act_fast(__fadd_rn(v[e], bv[e]), act) : 0.f;
            uint4 ph, pm, pl;
            split2(v[0], v[1], ph.x, pm.x, pl.x);
            split2(v[2], v[3], ph.y, pm.y, pl.y);
            split2(v[4], v[5], ph.z, pm.z, pl.z);
            split2(v[6], v[7], ph.w, pm.w, pl.w);
            __nv_bfloat16* cp = static_cast<__nv_bfloat16*>(c) + off;
            const size_t part = (size_t)m * ldc;
            *reinterpret_cast<uint4*>(cp) = ph;
            *reinterpret_cast<uint4*>(cp + part) = pm;
            *reinterpret_cast<uint4*>(cp + 2 * part) = pl;
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], bv[e]);
            store8(static_cast<float*>(c) + off, v, n - col, ldc % 8 == 0);
        }
    }
}

// the bf16 MLP's GEMM (GEMM 2: act = kNoAct)
template <class Cfg>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ c,
                       int m, int n, int k, int act) {
    gemm_cta<Cfg, kOutBf16>(&amap, &bmap, bias, c, m, n, n, n, k, act);
}

// the split mode's GEMMs: h's parts (GEMM 1) or fp32 y (GEMM 2)
template <class Cfg, int OUT>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_split_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap, const float* __restrict__ bias,
                       void* __restrict__ c, int m, int n, int n_valid, int ldc, int k, int act) {
    gemm_cta<Cfg, OUT>(&amap, &bmap, bias, c, m, n, n_valid, ldc, k, act);
}

// a 2-D bf16 map over [rows][cols] (cols contiguous, cols % 8 == 0), box
// [box_rows][64], 128-byte swizzle as the wgmma descriptors read it;
// out-of-bounds elements read zero
static bool make_map_2d(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [m, n] = epilogue(A [m, k] B [n, k]^T) with one tile config
template <class Cfg>
static int launch_gemm(const void* a, const void* b, const void* bias, void* c, int m, int n,
                       int k, int act, cudaStream_t stream) {
    CUtensorMap am, bm;
    if (!make_map_2d(&am, a, k, m, kBM) || !make_map_2d(&bm, b, k, n, Cfg::kBN))
        return kMapError;
    auto kernel = fused_mlp_wgmma_kernel<Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(n, Cfg::kBN), ceil_div(m, kBM));
    kernel<<<grid, kThreads, Cfg::SMEM, stream>>>(
        am, bm, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(c), m, n,
        k, act);
    return (int)cudaGetLastError();
}

// the split mode's C = epilogue(A B^T) on parts: A [3][m][k], B [3][n_valid][k]
template <class Cfg, int OUT>
static int launch_split_gemm(const void* a, const void* b, const float* bias, void* c, int m,
                             int n, int n_valid, int ldc, int k, int act, cudaStream_t stream) {
    CUtensorMap am, bm;
    if (!make_map_parts(&am, a, k, m, kBM) || !make_map_parts(&bm, b, k, n_valid, Cfg::kBN))
        return kMapError;
    auto kernel = fused_mlp_split_kernel<Cfg, OUT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(n, Cfg::kBN), ceil_div(m, kBM));
    kernel<<<grid, kThreads, Cfg::SMEM, stream>>>(am, bm, bias, c, m, n, n_valid, ldc, k, act);
    return (int)cudaGetLastError();
}

// Tiles (measured on the H100 with scripts/mlp_tc_probe.py; PERF.md has
// the times): 128 x 256 where that grid fills the 132 SMs at least four
// times over (the wider tile reads fewer operand bytes from L2 per
// product), 128 x 128 otherwise (more CTAs, fewer idle SMs in the last
// wave). PE-L14 at T = 4616: GEMM 1 (N = 4096) has 592 wide tiles and
// takes them; GEMM 2 (N = 1024) would have only 148, 1.12 waves, and takes
// 296 narrow ones; at T = 36,928 (B = 64) both take wide tiles.
// The split mode keeps three parts of A and B a stage: 128 x 128 tiles
// with a ring of four 48 KB stages at every shape. At the depth-2 tower's
// T = 1154, GEMM 2 has only 80 such tiles for 132 SMs, and still 128 x
// 128 took the MLP 0.2703 ms against 0.2969 with 160 tiles of 128 x 64
// and six stages (the narrow tile reads each A tile for half the
// products; scripts/mlp_tc_probe.py on the H100).
using GemmWide = GemmCfg<256, 4>;
using GemmNarrow = GemmCfg<128, 4>;
using GemmSplit = GemmCfg<128, 4, 3>;

static int launch_mlp_gemm(const void* a, const void* b, const void* bias, void* c, int m,
                           int n, int k, int act, cudaStream_t stream) {
    int sms = 0;
    const int err_sms = current_sms(&sms);
    if (err_sms != 0) return err_sms;
    const long long wide_tiles = (long long)ceil_div(m, kBM) * ceil_div(n, GemmWide::kBN);
    if (wide_tiles >= 4LL * sms)
        return launch_gemm<GemmWide>(a, b, bias, c, m, n, k, act, stream);
    return launch_gemm<GemmNarrow>(a, b, bias, c, m, n, k, act, stream);
}

}  // namespace mlp_tc

// ---- int8 variant (K5) ------------------------------------------------------
//
// Replaces: reverso_tpu/ops/fused_mlp.py::_fused_mlp_int8_kernel (entry
// fused_mlp(quant=True), ModelConfig.quant="int8"). x [T, W] (bf16 or fp32)
// is quantized per row; W1 [H, Wp] and W2 [W, Hp] arrive quantized per
// output unit with K zero-padded to 16-byte rows (Wp, Hp: W, H rounded up
// to 16; ops/fused_mlp.py::_kernel_weights pads nothing at any preset's
// widths); s1/s2 are their f32 scales, b1/b2 the dtype-rounded biases in
// f32.
//
// The contract (ops/fused_mlp.py::mlp_int8_plain): h = act(f32(x8 W1^T) *
// (xs * s1) + b1), re-quantized per (row, 512-wide hidden chunk); y = the
// sum over chunks, in chunk order, of f32(h8_c W2_c^T) * (hs_c * s2), then
// + b2, cast to x's dtype. The s32 products are exact in any order, so the
// tensor cores may reorder them; every f32 operation is __fmul_rn /
// __fadd_rn / __fdiv_rn in the reference's order (nvcc would contract a*b+c
// into one FMA, one rounding fewer, and an ulp at a rounding boundary flips
// an int8 quantum), and gelu is the reference int8 kernel's Abramowitz &
// Stegun erf polynomial, not erff.
//
// What bounds it on the H100: 4 * T * W * H int8 operations (77.4 G at
// T = 4616, W = 1024, H = 4096: 0.039 ms at 1979 TOP/s) against 2 * T * W
// activation elements and 2 * W * H weight bytes: operations, so the rate
// comes from s8 wgmma.
//
// Three launches on the caller's stream, through scratch the wrapper
// allocates (x8 [T, Wp] and h8 [T, Hp] int8, xs [T] and hs [T, ceil(H /
// 512)] f32):
//   1. q8_quant_rows_kernel: a warp per row quantizes x into x8 (amax,
//      127 / amax divided once, round half to even, clamp to +-127; the
//      pad columns zero) and its scale into xs;
//   2. q8_gemm1_kernel, one CTA per (64 rows, one 512-wide hidden chunk):
//      the chunk is the re-quantization unit, so one CTA holds every column
//      a row's amax needs. A producer warp brings 64-row x8 tiles and
//      512-row W1 tiles (two 256-row boxes), 128 bytes of K each, through
//      TMA (128-byte swizzle) into a 3-stage mbarrier ring; two consumer
//      warpgroups, one per 256 columns, share the x8 tile and run wgmma
//      m64n256k32 s8 x s8 -> s32 (128 s32 registers a thread). After the
//      last product the s32 tile is parked in the ring's shared memory;
//      then each warp takes whole rows, two at a time, so a row's amax is
//      one warp reduction: lane l holds columns 4l + 128g (g < 4;
//      conflict-free 16-byte shared loads, and each h8 store is a warp's
//      128 contiguous bytes). Pass 1 dequantizes, adds b1 and activates,
//      four columns of both rows at a time, writing the fp32 values back in
//      place; pass 2 quantizes them with the row's 127 / amax into h8, and
//      lane 0 writes hs. The exact activation is bound by instruction
//      throughput and runs after the products, one CTA an SM: at
//      T = 36,928 it is 0.44 of GEMM 1's 1.07 ms (NVIDIA H100 80GB HBM3,
//      700 W; scripts/mlp_q8_probe.py);
//   3. q8_gemm2_kernel, one CTA per 128 x BN tile of y: h8 and W2 tiles
//      through a 6-stage TMA ring, two consumer warpgroups of 64 rows on
//      wgmma m64nBNk32. After a chunk's last step (4 steps of 128 bytes; a
//      partial last chunk has fewer) the warpgroup waits for its products
//      and drains the s32 accumulator into an fp32 one, term = f32(s32) *
//      (hs * s2), the first chunk's term starting the sum and later ones
//      added, then resets it; the producer keeps the next stages' loads in
//      flight across the drain. The epilogue parks the fp32 tile in the
//      ring's shared memory, adds b2 and stores x's dtype, 8 columns (16
//      bytes in bf16) a thread.
// h8 goes through device memory: 2 * T * Hp bytes (37.8 MB at T = 4616,
// H = 4096: 0.011 ms at 3.35 TB/s). Rows past T, columns past W or H and
// K past the last whole step read zeros from TMA, so nothing but K's
// 16-byte row pitch is padded in memory.
constexpr int Q8_CHUNK = 512;   // hidden re-quantization unit

// the reference's constants, as its Python floats rounded to f32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);
constexpr float kSqrtHalf = static_cast<float>(0.7071067811865476);
constexpr float kErfP = static_cast<float>(0.3275911);
constexpr float kErfA1 = static_cast<float>(0.254829592);
constexpr float kErfA2 = static_cast<float>(-0.284496736);
constexpr float kErfA3 = static_cast<float>(1.421413741);
constexpr float kErfA4 = static_cast<float>(-1.453152027);
constexpr float kErfA5 = static_cast<float>(1.061405429);
constexpr float kQuickGeluScale = static_cast<float>(1.702);

__host__ __device__ inline int round_up(int a, int b) { return ceil_div(a, b) * b; }

// gelu with erf from A&S 7.1.26, op for op as the reference: every product
// and sum rounded on its own
__device__ __forceinline__ float gelu_as(float x) {
    const float z = __fmul_rn(x, kSqrtHalf);
    const float sign = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
    const float az = fabsf(z);
    const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(kErfP, az)));
    float p = __fadd_rn(kErfA4, __fmul_rn(t, kErfA5));
    p = __fadd_rn(kErfA3, __fmul_rn(t, p));
    p = __fadd_rn(kErfA2, __fmul_rn(t, p));
    p = __fadd_rn(kErfA1, __fmul_rn(t, p));
    p = __fmul_rn(t, p);
    const float erf = __fmul_rn(sign, __fsub_rn(1.f, __fmul_rn(p, expf(__fmul_rn(-az, az)))));
    return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf));
}

__device__ __forceinline__ float q8_act(float x, int act) {
    if (act == kGelu) return gelu_as(x);
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(kQuickGeluScale, x))));
    return __fmul_rn(x, sig);
}

// round(v * inv) half to even, clamped to +-127
__device__ __forceinline__ int quant8(float v, float inv) {
    return static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// four int8 quanta packed low byte first
__device__ __forceinline__ unsigned pack_q8(int a, int b, int c, int d) {
    return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
           (static_cast<unsigned>(d & 0xff) << 24);
}

namespace mlp_q8 {

using namespace tc;

constexpr int kBK = 128;                        // K bytes a stage: one 128-byte swizzle atom
constexpr int kStepsPerChunk = Q8_CHUNK / kBK;  // steps of GEMM 2 between drains
constexpr int kThreads = 2 * kWgThreads + 32;   // two consumer warpgroups, one producer warp
constexpr int kQuantWarps = 8;                  // rows a block of the x quantizer takes

// GEMM 1: 64 rows x one whole 512-wide chunk
constexpr int G1_BM = 64;
constexpr int G1_STAGES = 3;
constexpr int G1_A_BYTES = G1_BM * kBK;                  // 8 KB
constexpr int G1_B_BYTES = Q8_CHUNK * kBK;               // 64 KB: two 256-row boxes
constexpr int G1_RING = G1_STAGES * (G1_A_BYTES + G1_B_BYTES);
constexpr int G1_SMEM = 1024 + G1_RING + 16 * G1_STAGES;
constexpr int G1_LDC = Q8_CHUNK + 8;                     // s32 tile row pitch (words)
static_assert(G1_SMEM <= 232448, "shared memory of a CTA");
static_assert((G1_BM * G1_LDC + 2 * Q8_CHUNK) * 4 <= G1_RING, "epilogue tiles fit the ring");

// GEMM 2: 128 rows x BN output columns
template <int BN>
struct Gemm2Cfg {
    static constexpr int kBN = BN, kBM = 128, kStages = 6;
    static constexpr int A_BYTES = kBM * kBK;
    static constexpr int B_BYTES = BN * kBK;
    static constexpr int RING = kStages * (A_BYTES + B_BYTES);
    static constexpr int SMEM = 1024 + RING + 16 * kStages + BN * 4;
    static constexpr int LDC = BN + 8;                   // fp32 tile row pitch
    static_assert(SMEM <= 232448, "shared memory of a CTA");
    static_assert(kBM * LDC * 4 <= RING, "the fp32 tile fits the ring");
    static_assert(BN % 64 == 0 && BN <= 128, "two accumulator sets a thread");
};

template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
q8_quant_rows_kernel(const T* __restrict__ x, signed char* __restrict__ x8,
                     float* __restrict__ xs, int rows, int W, int Wp) {
    const int r = blockIdx.x * kQuantWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (r >= rows) return;
    const T* xr = x + (size_t)r * W;
    float amax = 0.f;
    for (int c = lane; c < W; c += 32) amax = fmaxf(amax, fabsf(to_f<T>(xr[c])));
    amax = fmaxf(warp_max(amax), 1e-30f);
    const float inv = __fdiv_rn(127.f, amax);
    if (lane == 0) xs[r] = __fmul_rn(amax, kInv127);
    unsigned* out = reinterpret_cast<unsigned*>(x8 + (size_t)r * Wp);
    for (int g = lane; g < Wp / 4; g += 32) {
        int q[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 4 * g + e;
            q[e] = c < W ? quant8(to_f<T>(xr[c]), inv) : 0;
        }
        out[g] = pack_q8(q[0], q[1], q[2], q[3]);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
q8_gemm1_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ xs, const float* __restrict__ s1,
                const float* __restrict__ b1, signed char* __restrict__ h8,
                float* __restrict__ hs, int rows, int Wp, int H, int Hp, int act) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* as = base;                            // [STAGES][64][128] int8, swizzled
    uint8_t* bs = as + G1_STAGES * G1_A_BYTES;     // [STAGES][512][128]
    uint64_t* full = reinterpret_cast<uint64_t*>(bs + G1_STAGES * G1_B_BYTES);
    uint64_t* empty = full + G1_STAGES;            // the consumers' 8 warps are done

    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int chunk = blockIdx.x, c0 = chunk * Q8_CHUNK, m0 = blockIdx.y * G1_BM;
    const int n_k = ceil_div(Wp, kBK);

    if (threadIdx.x == 0) {
        for (int s = 0; s < G1_STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 2) {
        // ---- producer warp: lane 0 keeps the ring full ----
        if (tid == 0) {
            for (int j = 0; j < n_k; ++j) {
                const int s = j % G1_STAGES;
                mbar_wait(&empty[s], ((j / G1_STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], G1_A_BYTES + G1_B_BYTES);
                uint8_t* b = bs + s * G1_B_BYTES;
                tma_load_2d(as + s * G1_A_BYTES, &xmap, &full[s], j * kBK, m0);
                tma_load_2d(b, &wmap, &full[s], j * kBK, c0);
                tma_load_2d(b + G1_B_BYTES / 2, &wmap, &full[s], j * kBK, c0 + Q8_CHUNK / 2);
            }
        }
        return;
    }

    // ---- consumer warpgroup wg: columns c0 + 256 wg .. + 256 of all 64 rows ----
    const int warp = tid / 32, lane = tid % 32;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    const uint32_t a0 = smem_addr(as);
    const uint32_t b0 = smem_addr(bs) + wg * (G1_B_BYTES / 2);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % G1_STAGES;
        mbar_wait(&full[s], (j / G1_STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)   // k32 steps: 32 bytes into the swizzled rows
            WgmmaSS8<256>::run(acc, gmma_desc(a0 + s * G1_A_BYTES + kk * 32, 16, 1024, 1),
                               gmma_desc(b0 + s * G1_B_BYTES + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();   // step j - 1's products are done: release its stage
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % G1_STAGES]);
        }
    }
    wgmma_wait<0>();
    fence_operand(acc);

    // ---- epilogue ----
    // (1) both consumer warpgroups are done with the ring (every stage was
    // loaded and consumed): it takes the s32 tile [64][LDC] (the pad keeps
    // a warp's fragment stores off shared bank conflicts) and the chunk's
    // s1 and b1
    int* ct = reinterpret_cast<int*>(base);
    float* s1c = reinterpret_cast<float*>(ct + G1_BM * G1_LDC);
    float* b1c = s1c + Q8_CHUNK;
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = warp * 16 + lane / 4, cb = wg * (Q8_CHUNK / 2) + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            *reinterpret_cast<int2*>(ct + r * G1_LDC + cb + 8 * i) = make_int2(acc[4 * i], acc[4 * i + 1]);
            *reinterpret_cast<int2*>(ct + (r + 8) * G1_LDC + cb + 8 * i) =
                make_int2(acc[4 * i + 2], acc[4 * i + 3]);
        }
        for (int c = wg * kWgThreads + tid; c < Q8_CHUNK; c += 2 * kWgThreads) {
            const bool in = c0 + c < H;
            s1c[c] = in ? s1[c0 + c] : 0.f;
            b1c[c] = in ? b1[c0 + c] : 0.f;
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // (2) warp cw takes the row pairs (cw + 16i, cw + 16i + 8); lane l holds
    // columns 4l + 128g of both, so each step of the column loop has eight
    // independent activations
    const int cw = threadIdx.x / 32;
    const int n_chunks = ceil_div(H, Q8_CHUNK);
#pragma unroll 1
    for (int r = cw; r < G1_BM && m0 + r < rows; r += 16) {
        const int rr[2] = {r, r + 8};
        const bool second = m0 + r + 8 < rows;
        const float xsr[2] = {xs[m0 + r], second ? xs[m0 + r + 8] : 0.f};
        float amax[2] = {0.f, 0.f};
#pragma unroll 1
        for (int g = 0; g < 4; ++g) {   // pass 1: dequantize, bias, activation, in place
            const int c = 128 * g + 4 * lane;
            const float4 sc = *reinterpret_cast<const float4*>(s1c + c);
            const float4 bi = *reinterpret_cast<const float4*>(b1c + c);
            const float sv[4] = {sc.x, sc.y, sc.z, sc.w}, bv[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                int* cell = ct + rr[k] * G1_LDC + c;
                const int4 q = *reinterpret_cast<const int4*>(cell);
                const int qv[4] = {q.x, q.y, q.z, q.w};
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[e] = 0.f;
                    if (c0 + c + e < H)
                        v[e] = q8_act(__fadd_rn(__fmul_rn(__int2float_rn(qv[e]),
                                                          __fmul_rn(xsr[k], sv[e])),
                                                bv[e]), act);
                    amax[k] = fmaxf(amax[k], fabsf(v[e]));
                }
                *reinterpret_cast<float4*>(cell) = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (k == 1 && !second) break;
            const float m = fmaxf(warp_max(amax[k]), 1e-30f);
            const float inv = __fdiv_rn(127.f, m);
            const int row = m0 + rr[k];
            if (lane == 0) hs[(size_t)row * n_chunks + chunk] = __fmul_rn(m, kInv127);
            signed char* hrow = h8 + (size_t)row * Hp + c0;
#pragma unroll
            for (int g = 0; g < 4; ++g) {   // pass 2: the lane's own values, quantized
                const int c = 128 * g + 4 * lane;
                if (c0 + c >= Hp) break;   // Hp % 16 == 0: a group of 4 is in or out whole
                const float4 v = *reinterpret_cast<const float4*>(ct + rr[k] * G1_LDC + c);
                *reinterpret_cast<unsigned*>(hrow + c) =
                    pack_q8(quant8(v.x, inv), quant8(v.y, inv), quant8(v.z, inv), quant8(v.w, inv));
            }
        }
    }
}

template <typename T, class Cfg>
__global__ void __launch_bounds__(kThreads, 1)
q8_gemm2_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ hs, const float* __restrict__ s2,
                const float* __restrict__ b2, T* __restrict__ y, int rows, int W, int H,
                int Hp) {
    constexpr int BN = Cfg::kBN, BM = Cfg::kBM, STAGES = Cfg::kStages;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* as = base;                           // [STAGES][128][128] int8, swizzled
    uint8_t* bs = as + STAGES * Cfg::A_BYTES;     // [STAGES][BN][128]
    uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * Cfg::B_BYTES);
    uint64_t* empty = full + STAGES;
    float* s2t = reinterpret_cast<float*>(empty + STAGES);   // [BN]

    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int n_k = ceil_div(Hp, kBK);
    const int n_chunks = ceil_div(H, Q8_CHUNK);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);
        }
        fence_barrier_init();
    }
    for (int i = threadIdx.x; i < BN; i += kThreads) s2t[i] = n0 + i < W ? s2[n0 + i] : 0.f;
    __syncthreads();

    if (wg == 2) {
        if (tid == 0) {
            for (int j = 0; j < n_k; ++j) {
                const int s = j % STAGES;
                mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], Cfg::A_BYTES + Cfg::B_BYTES);
                tma_load_2d(as + s * Cfg::A_BYTES, &hmap, &full[s], j * kBK, m0);
                tma_load_2d(bs + s * Cfg::B_BYTES, &wmap, &full[s], j * kBK, n0);
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;   // the fragment's rows r0, r0 + 8
    const int cq = 2 * (lane % 4);                        // and columns 8i + cq, + 1
    int acc[BN / 2];
    float facc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0;
        facc[i] = 0.f;
    }
    const uint32_t a0 = smem_addr(as) + wg * 64 * kBK;
    const uint32_t b0 = smem_addr(bs);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % STAGES;
        mbar_wait(&full[s], (j / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
            WgmmaSS8<BN>::run(acc, gmma_desc(a0 + s * Cfg::A_BYTES + kk * 32, 16, 1024, 1),
                              gmma_desc(b0 + s * Cfg::B_BYTES + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
        }
        if ((j + 1) % kStepsPerChunk == 0 || j + 1 == n_k) {
            // the chunk's products are all in: drain them into the fp32 sum
            wgmma_wait<0>();
            fence_operand(acc);
            const int c = j / kStepsPerChunk;
            const float h0 = r0 < rows ? hs[(size_t)r0 * n_chunks + c] : 0.f;
            const float h1 = r0 + 8 < rows ? hs[(size_t)(r0 + 8) * n_chunks + c] : 0.f;
#pragma unroll
            for (int i = 0; i < BN / 8; ++i) {
                const float2 sc = *reinterpret_cast<const float2*>(s2t + 8 * i + cq);
                const float scale[4] = {__fmul_rn(h0, sc.x), __fmul_rn(h0, sc.y),
                                        __fmul_rn(h1, sc.x), __fmul_rn(h1, sc.y)};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float term = __fmul_rn(__int2float_rn(acc[4 * i + e]), scale[e]);
                    facc[4 * i + e] = c == 0 ? term : __fadd_rn(facc[4 * i + e], term);
                    acc[4 * i + e] = 0;
                }
            }
        }
    }

    // ---- epilogue: the fp32 tile through the ring's shared memory ----
    constexpr int LDC = Cfg::LDC;
    float* ct = reinterpret_cast<float*>(base);
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
            *reinterpret_cast<float2*>(ct + r * LDC + 8 * i + cq) = make_float2(facc[4 * i], facc[4 * i + 1]);
            *reinterpret_cast<float2*>(ct + (r + 8) * LDC + 8 * i + cq) =
                make_float2(facc[4 * i + 2], facc[4 * i + 3]);
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // each thread takes 8 adjacent columns of a row: + b2, x's dtype
    constexpr int TPR = BN / 8;                  // threads per row
    constexpr int ROWS = 2 * kWgThreads / TPR;   // rows per pass
    const int ctid = wg * kWgThreads + tid;
    const int c8 = (ctid % TPR) * 8, col = n0 + c8;
    if (col >= W) return;
    const bool vec = W % 8 == 0;   // 16-byte stores (y is 16-byte aligned)
    float bv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) bv[e] = col + e < W ? b2[col + e] : 0.f;
#pragma unroll 2
    for (int r = ctid / TPR; r < BM && m0 + r < rows; r += ROWS) {
        const float4 lo = *reinterpret_cast<const float4*>(ct + r * LDC + c8);
        const float4 hi = *reinterpret_cast<const float4*>(ct + r * LDC + c8 + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], bv[e]);
        store8(y + (size_t)(m0 + r) * W + col, v, W - col, vec);
    }
}

// a 2-D int8 map over [rows][cols] (cols contiguous, cols % 16 == 0), box
// [box_rows][128 bytes], 128-byte swizzle as the wgmma descriptors read
// it; out-of-bounds elements read zero
static bool make_map_s8(CUtensorMap* map, const void* ptr, int cols, int rows, int box_rows) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
               elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, class Cfg>
static int launch_gemm2(const void* h8, const void* w2, const void* hs, const void* s2,
                        const void* b2, void* y, int rows, int W, int H, int Hp,
                        cudaStream_t stream) {
    CUtensorMap hm, wm;
    if (!make_map_s8(&hm, h8, Hp, rows, Cfg::kBM) || !make_map_s8(&wm, w2, Hp, W, Cfg::kBN))
        return kMapError;
    auto kernel = q8_gemm2_kernel<T, Cfg>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(ceil_div(W, Cfg::kBN), ceil_div(rows, Cfg::kBM));
    kernel<<<grid, kThreads, Cfg::SMEM, stream>>>(
        hm, wm, static_cast<const float*>(hs), static_cast<const float*>(s2),
        static_cast<const float*>(b2), static_cast<T*>(y), rows, W, H, Hp);
    return (int)cudaGetLastError();
}

// GEMM 2's tile: 128 x 128 where those tiles fill the SMs, else 128 x 64
// (a single image's T = 577 at W = 1024 has 40 wide tiles, 80 narrow ones)
using Gemm2Wide = Gemm2Cfg<128>;
using Gemm2Narrow = Gemm2Cfg<64>;

template <typename T>
static int launch_int8_mlp(const void* x, const void* w1, const void* s1, const void* b1,
                           const void* w2, const void* s2, const void* b2, void* x8, void* xs,
                           void* h8, void* hs, void* y, int rows, int W, int H, int act,
                           cudaStream_t stream) {
    int sms = 0;
    const int err_sms = current_sms(&sms);
    if (err_sms != 0) return err_sms;
    const int Wp = round_up(W, 16), Hp = round_up(H, 16);
    q8_quant_rows_kernel<T><<<ceil_div(rows, kQuantWarps), kQuantWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<signed char*>(x8), static_cast<float*>(xs), rows, W,
        Wp);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    CUtensorMap xm, wm;
    if (!make_map_s8(&xm, x8, Wp, rows, G1_BM) || !make_map_s8(&wm, w1, Wp, H, Q8_CHUNK / 2))
        return kMapError;
    err = cudaFuncSetAttribute(q8_gemm1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G1_SMEM);
    if (err != cudaSuccess) return (int)err;
    q8_gemm1_kernel<<<dim3(ceil_div(H, Q8_CHUNK), ceil_div(rows, G1_BM)), kThreads, G1_SMEM,
                      stream>>>(xm, wm, static_cast<const float*>(xs),
                                static_cast<const float*>(s1), static_cast<const float*>(b1),
                                static_cast<signed char*>(h8), static_cast<float*>(hs), rows, Wp,
                                H, Hp, act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const long long wide_tiles = (long long)ceil_div(W, Gemm2Wide::kBN) * ceil_div(rows, 128);
    if (wide_tiles >= sms)
        return launch_gemm2<T, Gemm2Wide>(h8, w2, hs, s2, b2, y, rows, W, H, Hp, stream);
    return launch_gemm2<T, Gemm2Narrow>(h8, w2, hs, s2, b2, y, rows, W, H, Hp, stream);
}

}  // namespace mlp_q8

}  // namespace rv

// x [T, W] bf16 or fp32; w1 [H, Wp], w2 [W, Hp] int8 (Wp, Hp: W, H rounded
// up to 16, zero pad), 16-byte aligned; s1, b1 [H], s2, b2 [W] f32; scratch
// of the caller's, 16-byte aligned: x8 [T, Wp] and h8 [T, Hp] int8, xs [T]
// and hs [T, ceil(H / 512)] f32; out [T, W] in x's dtype, 16-byte aligned
extern "C" int rv_fused_mlp_int8(const void* x, const void* w1, const void* s1,
                                 const void* b1, const void* w2, const void* s2,
                                 const void* b2, void* x8, void* xs, void* h8, void* hs,
                                 void* out, int T_rows, int W, int H, int act, int dtype,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (T_rows <= 0 || W <= 0 || H <= 0) return rv::kUnsupported;
    const uintptr_t align = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
                            reinterpret_cast<uintptr_t>(x8) | reinterpret_cast<uintptr_t>(h8) |
                            reinterpret_cast<uintptr_t>(out);
    if (align % 16 != 0) return rv::kUnsupported;   // TMA and 16-byte stores
    if (dtype == rv::kBFloat16)
        return rv::mlp_q8::launch_int8_mlp<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, x8, xs, h8,
                                                          hs, out, T_rows, W, H, act, st);
    if (dtype == rv::kFloat32)
        return rv::mlp_q8::launch_int8_mlp<float>(x, w1, s1, b1, w2, s2, b2, x8, xs, h8, hs, out,
                                                  T_rows, W, H, act, st);
    return rv::kUnsupported;
}

// x [rows, cols] (fp32, or bf16 with parts = 1), any alignment -> out
// [parts][out_rows][pitch] bf16, 16-byte aligned (pitch % 8 == 0, pitch >=
// cols, out_rows >= rows): the split pass (three parts, or one)
extern "C" int rv_split_parts(const void* x, void* out, int rows, int cols, int out_rows,
                              int pitch, int parts, int dtype, void* stream) {
    return rv::launch_split_parts(x, out, rows, cols, out_rows, pitch, parts, dtype,
                                  static_cast<cudaStream_t>(stream));
}

// fp32: x [T, W] (any alignment); w1p [3][H][Wp] and w2p [3][W][Hp], the
// weights' parts from the split pass (Wp, Hp: W, H rounded up to 8);
// b1 [H], b2 [W] fp32; scratch of the caller's, xp [3][T][Wp] and hp
// [3][T][Hp] bf16; out [T, W] fp32. The parts, the scratch and out 16-byte
// aligned.
// Three launches: x's split pass, GEMM 1 (h's parts), GEMM 2.
extern "C" int rv_fused_mlp_split(const void* x, const void* w1p, const void* b1,
                                  const void* w2p, const void* b2, void* xp, void* hp,
                                  void* out, int T_rows, int W, int H, int act, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using namespace rv::mlp_tc;
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (T_rows <= 0 || W <= 0 || H <= 0) return rv::kUnsupported;
    const uintptr_t align = reinterpret_cast<uintptr_t>(w1p) | reinterpret_cast<uintptr_t>(w2p) |
                            reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(hp) |
                            reinterpret_cast<uintptr_t>(out);
    if (align % 16 != 0) return rv::kUnsupported;   // TMA and 16-byte stores
    const int Wp = rv::round_up(W, 8), Hp = rv::round_up(H, 8);
    int status = rv::launch_split_parts(x, xp, T_rows, W, T_rows, Wp, 3, rv::kFloat32, st);
    if (status != 0) return status;
    status = launch_split_gemm<GemmSplit, kOutParts>(xp, w1p, static_cast<const float*>(b1), hp,
                                                     T_rows, Hp, H, Hp, Wp, act, st);
    if (status != 0) return status;
    return launch_split_gemm<GemmSplit, kOutF32>(hp, w2p, static_cast<const float*>(b2), out,
                                                 T_rows, W, W, W, Hp, kNoAct, st);
}

// bf16, W % 8 == 0, H % 8 == 0 (TMA's 16-byte row strides), 16-byte aligned
// x, weights, h and out, 4-byte aligned biases: the two wgmma GEMMs through
// h [T, H] bf16, scratch of the caller's
extern "C" int rv_fused_mlp_tc(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h, void* out,
                               int T_rows, int W, int H, int act, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (act != rv::kGelu && act != rv::kQuickGelu) return rv::kUnsupported;
    if (T_rows <= 0 || W <= 0 || H <= 0 || W % 8 || H % 8) return rv::kUnsupported;
    const int status = rv::mlp_tc::launch_mlp_gemm(x, w1, b1, h, T_rows, H, W, act, st);
    if (status != 0) return status;
    return rv::mlp_tc::launch_mlp_gemm(h, w2, b2, out, T_rows, W, H, rv::mlp_tc::kNoAct, st);
}
