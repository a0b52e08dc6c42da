// Backward of the fused transformer MLP (K4's gradient): the fused part.
//
// Replaces: no TPU kernel. reverso_tpu/ops/fused_mlp.py::_fused_mlp_kernel
// (K4, pallas_call at :194) has no backward: jax.grad through it fails, so
// the JAX trainer learns only on XLA's MLP. This kernel gives the port's
// K4 forward (csrc/fused_mlp.cu) its gradient (ops/fused_mlp.py::
// FusedMLPFunction), so that the tower trains on the card's forward
// kernels.
//
// For y = act(x W1^T + b1) W2^T + b2 (Linear layout: W1 [H, W], W2 [W, H])
// and the output gradient dY [T, W], one kernel computes, per [T, H] tile,
//   z = x W1^T + b1 (recomputed, fp32 sums), h = act(z) rounded to x's
//   dtype as the plain version rounds it (for dW2 = dY^T h), and
//   dz = (dY W2) * act'(z), rounded once to x's dtype,
// both products inside the kernel, as K4's two products are: z and dY W2
// never reach device memory in fp32. act' is the exact-erf GELU's
// derivative, cdf(z) + z pdf(z), or quick-GELU's, s + 1.702 z s (1 - s)
// with s = sigmoid(1.702 z) (ops/fused_mlp.py::_act). The kernel also
// writes each CTA's column sums of the stored dz, [ceil(T / 128), H] fp32,
// which the wrapper adds in a fixed order for db1. The rest of the
// gradient is left to the caller: db2 is a column sum, and dW2 = dY^T h,
// dW1 = dz^T x and dx = dz W1 are plain large products that go to
// torch.matmul (XLA's dots of the autodiff in JAX).
//
// Two routes, by dtype (ops/fused_mlp.py::mlp_bwd_route):
//   * bf16 at W, H % 8 == 0 (every preset; the wrapper zero-pads other
//     widths to a multiple of 8, as K4's forward does), rv_fused_mlp_bwd_tc:
//     fused_mlp.cu's GEMM design (mlp_tc) with two accumulators. One CTA
//     per 128 x 128 tile of [T, H]: a producer warp, one thread of which
//     brings the x, dY and W1 tiles (K-major, 64 deep, 128-byte swizzle) and
//     W2's tile ([64 of W][128 of H]: H contiguous, read by the product in
//     its MN-major form, so W2 is never transposed) through TMA into a
//     three-stage mbarrier ring (64 KB a stage); two consumer warpgroups of
//     64 rows each run z += x W1^T and g += dY W2 (wgmma m64n128k16, fp32
//     accumulators, 128 registers a thread for the two). Rows past T, a K
//     past the last whole step and columns past H read zeros from the
//     hardware. The epilogue parks both fp32 tiles in the ring's shared
//     memory (139 KB) and applies the activation and its derivative by
//     element, 8 adjacent columns a thread and one 16-byte store of h and
//     of dz (erff straight from the fragments measured 2.2x slower in the
//     forward, fused_mlp.cu), then sums its column partials of dz through
//     shared memory;
//   * fp32 at any shape, rv_fused_mlp_bwd_split: the same tile and
//     epilogue on three bf16 parts a value (the TPU kernels' fp32
//     contract, Precision.HIGHEST, as K4's fp32 forward computes it): the
//     split pass (fused_mlp.cu's rv_split_parts) writes the parts of x and
//     dY, [3][T][Wp], the weights' parts come from the forward's cache
//     (W1 [3][H][Wp], W2 [3][W][Hp]; Wp, Hp: W, H rounded up to 8, zero
//     pad), and each 32-deep step runs the six part products of each
//     accumulator (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi), 64-byte
//     swizzle, a ring of two 96 KB stages; h and dz are stored in fp32 at
//     a row pitch of Hp.
//
// What bounds it on the H100: two products of T W H multiply-adds, 4 T W H
// operations (155 GFLOP at T = 16 * 577 = 9232, 1024 -> 4096 -> 1024,
// 0.157 ms at 989 TFLOP/s in bf16, 0.940 ms at the split mode's 989 / 6)
// against x, dY, W1, W2 and b1 read and h and dz written once (0.19 GB in
// bf16, 0.057 ms): bound by operations, so the rate comes from wgmma fed by
// TMA; above that, the epilogue's activation derivative (erff and expf)
// over the [T, H] tile, which no product overlaps (one CTA an SM at 193 KB
// of shared memory, 197 KB in the split mode).
#include "common.cuh"
#include "hopper.cuh"

namespace rv {
namespace mbwd {

using namespace tc;

constexpr int kGelu = 0;
constexpr int kQuickGelu = 1;

// h = act(z) and act'(z) in fp32
__device__ __forceinline__ void act_grad(float z, int act, float& h, float& d) {
    if (act == kQuickGelu) {
        const float s = 1.f / (1.f + expf(-1.702f * z));
        h = z * s;
        d = s + 1.702f * z * s * (1.f - s);
    } else {
        const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
        h = z * cdf;
        d = cdf + z * 0.39894228040143268f * expf(-0.5f * z * z);
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kTcThreads = 2 * kWgThreads + 32;    // two consumer warpgroups, a producer warp
constexpr int kTile = kBM * kBK * 2;               // 16 KB: each of x, dY, W1 and W2's tiles
constexpr int kStage = 4 * kTile;
constexpr int kLdc = kBN + 8;                      // the epilogue's fp32 row pitch
constexpr int kTcSmem = 1024 + kStages * kStage + 16 * kStages;
static_assert(2 * kBM * kLdc * 4 + 16 * kBN * 4 <= kStages * kStage, "epilogue fits the ring");
static_assert(kTcSmem <= 232448, "shared memory of a CTA");

// D (+)= A B, A (64 rows) K-major and B MN-major (N contiguous) in shared
// memory, N = 128: dY W2 with W2 read as it lies ([K][N])
struct WgmmaSSMn128 {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// 8 values of h or dz: one 16-byte store of bf16, two of fp32
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The epilogue of a 128 x 128 tile of [T, H] (rows m0.., columns n0..),
// for both routes, from the two consumer warpgroups' accumulators z (x
// W1^T) and g (dY W2): h = act(z + b1) and dz = g * act'(z + b1) in fp32,
// stored as T (bf16 rounded once, or fp32) at a row pitch of ldh, and the
// tile's column sums of the stored dz into db1_part's row blockIdx.y.
// Columns at or past H take b1 = 0 (the split route's pad up to ldh, whose
// z and g are zeros); columns past ldh are not stored.
template <typename T>
__device__ __forceinline__ void epilogue(const float (&z)[kBN / 2], const float (&g)[kBN / 2],
                                         uint8_t* base, const T* __restrict__ b1, T* h, T* dz,
                                         float* db1_part, int rows, int H, int ldh, int m0,
                                         int n0, int act, int wg, int tid) {
    // (1) both consumer warpgroups are done with the ring: it takes the two
    // fp32 tiles [128][kLdc] and the column partials [16][128]
    float* zt = reinterpret_cast<float*>(base);
    float* gt = zt + kBM * kLdc;
    float* part = gt + kBM * kLdc;
    const int warp = tid / 32, lane = tid % 32;
    named_bar_sync(1, 2 * kWgThreads);
    {
        const int r = wg * 64 + warp * 16 + lane / 4, t = lane % 4;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
            const int col = 8 * i + 2 * t;
            *reinterpret_cast<float2*>(zt + r * kLdc + col) = make_float2(z[4 * i], z[4 * i + 1]);
            *reinterpret_cast<float2*>(zt + (r + 8) * kLdc + col) =
                make_float2(z[4 * i + 2], z[4 * i + 3]);
            *reinterpret_cast<float2*>(gt + r * kLdc + col) = make_float2(g[4 * i], g[4 * i + 1]);
            *reinterpret_cast<float2*>(gt + (r + 8) * kLdc + col) =
                make_float2(g[4 * i + 2], g[4 * i + 3]);
        }
    }
    named_bar_sync(1, 2 * kWgThreads);
    // (2) each thread takes 8 adjacent columns of a row at a time: b1, the
    // activation and its derivative, one store of h and of dz, and its
    // columns' sums of the stored dz over its rows
    constexpr int TPR = kBN / 8;                  // threads per row
    constexpr int ROWS = 2 * kWgThreads / TPR;    // rows per pass
    const int ctid = wg * kWgThreads + tid;
    const int c8 = (ctid % TPR) * 8, col = n0 + c8;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (col < ldh) {   // ldh % 8 == 0: a group of 8 is in or out whole
        float bv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) bv[e] = col + e < H ? to_f<T>(b1[col + e]) : 0.f;
#pragma unroll 1
        for (int r = ctid / TPR; r < kBM && m0 + r < rows; r += ROWS) {
            const float* zr = zt + r * kLdc + c8;
            const float* gr = gt + r * kLdc + c8;
            float hv[8], dv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                float d;
                act_grad(zr[e] + bv[e], act, hv[e], d);
                dv[e] = round_t<T>(gr[e] * d);
            }
            const size_t off = (size_t)(m0 + r) * ldh + col;
            store8(h + off, hv);
            store8(dz + off, dv);
#pragma unroll
            for (int e = 0; e < 8; ++e) sum[e] += dv[e];
        }
    }
    // (3) db1's partials: the ROWS threads of each column group add their
    // sums through shared memory, in a fixed order
    float* pr = part + (ctid / TPR) * kBN + c8;
#pragma unroll
    for (int e = 0; e < 8; ++e) pr[e] = sum[e];
    named_bar_sync(1, 2 * kWgThreads);
    if (ctid < kBN && n0 + ctid < ldh) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s += part[r * kBN + ctid];
        db1_part[(size_t)blockIdx.y * ldh + n0 + ctid] = s;
    }
}

// One CTA: rows m0 .. m0 + 127 of [T, H], columns n0 .. n0 + 127
__global__ void __launch_bounds__(kTcThreads, 1)
mlp_bwd_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
              const __nv_bfloat16* __restrict__ b1, __nv_bfloat16* __restrict__ h,
              __nv_bfloat16* __restrict__ dz, float* __restrict__ db1_part, int T, int W, int H,
              int act) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    // stage s: x [128][64], dY [128][64], W1 [128][64] (K-major), W2 as two
    // 64-column atoms [2][64 of W][64 of H]; every tile 128-byte swizzled
    uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStage);
    uint64_t* empty = full + kStages;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
    const int n_k = ceil_div(W, kBK);
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
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
                const int s = j % kStages;
                uint8_t* st = base + s * kStage;
                mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                mbar_expect_tx(&full[s], kStage);
                tma_load_2d(st, &xmap, &full[s], j * kBK, m0);
                tma_load_2d(st + kTile, &ymap, &full[s], j * kBK, m0);
                tma_load_2d(st + 2 * kTile, &w1map, &full[s], j * kBK, n0);
                tma_load_2d(st + 3 * kTile, &w2map, &full[s], n0, j * kBK);
                tma_load_2d(st + 3 * kTile + kTile / 2, &w2map, &full[s], n0 + 64, j * kBK);
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int lane = tid % 32;
    float z[kBN / 2], g[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) z[i] = g[i] = 0.f;
    const uint32_t s0 = smem_addr(base);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        const uint32_t st = s0 + s * kStage;
        mbar_wait(&full[s], (j / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {   // k16 steps: 32 bytes into the swizzled rows
            const uint32_t a_x = st + wg * 64 * kBK * 2 + kk * 32;
            WgmmaSS<kBN>::run(z, gmma_desc(a_x, 16, 1024, 1),
                              gmma_desc(st + 2 * kTile + kk * 32, 16, 1024, 1), 1);
            // W2's tile MN-major: 16 rows of W a step, its two 64-column
            // atoms 8 KB apart
            WgmmaSSMn128::run(g, gmma_desc(a_x + kTile, 16, 1024, 1),
                              gmma_desc(st + 3 * kTile + kk * 16 * 128, kTile / 2, 1024, 1), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();   // step j - 1's products are done: release its stage
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
        }
    }
    wgmma_wait<0>();
    fence_operand(z);
    fence_operand(g);

    // ---- epilogue ----
    epilogue(z, g, base, b1, h, dz, db1_part, T, H, H, m0, n0, act, wg, tid);
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

// ---------------------------------------------------------------------------
// fp32 on the tensor cores: the split mode
// ---------------------------------------------------------------------------

// The bf16 kernel's tile and epilogue on the split pass's bf16 parts: x and
// dY [3][T][Wp] (this call's split pass), W1 [3][H][Wp] and W2 [3][W][Hp]
// (the weights' parts, fused_mlp.cu's, cached by the tower). A stage holds
// every part of a 32-deep step (64-byte swizzle, as the forward's split
// GEMM): x, dY and W1 tiles [3][128][32] K-major and W2's [3][32 of W][128
// of H] as four 32-column atoms, read MN-major; 96 KB a stage, two stages.
// Each k16 step runs the six part products for each accumulator
// (hopper.cuh::split_part, smallest first) into the same fp32 registers.
constexpr int kSK = 32;                          // reduction step of the split mode
constexpr int kSStages = 2;
constexpr int kSPart = kBM * kSK * 2;            // 8 KB: one part of a tile
constexpr int kSStage = 12 * kSPart;             // x, dY, W1, W2: three parts each
constexpr int kSSmem = 1024 + kSStages * kSStage + 16 * kSStages;
static_assert(2 * kBM * kLdc * 4 + 16 * kBN * 4 <= kSStages * kSStage, "epilogue fits the ring");
static_assert(kSSmem <= 232448, "shared memory of a CTA");

__global__ void __launch_bounds__(kTcThreads, 1)
mlp_bwd_split(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
              const float* __restrict__ b1, float* __restrict__ h, float* __restrict__ dz,
              float* __restrict__ db1_part, int T, int Wp, int H, int Hp, int act) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    // stage s: x, dY, W1 parts [3][128][32] at part slots 0-2, 3-5, 6-8;
    // W2's parts [3][4 atoms][32 of W][32 of H] at slots 9-11
    uint64_t* full = reinterpret_cast<uint64_t*>(base + kSStages * kSStage);
    uint64_t* empty = full + kSStages;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
    const int n_k = ceil_div(Wp, kSK);
    if (threadIdx.x == 0) {
        for (int s = 0; s < kSStages; ++s) {
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
                const int s = j % kSStages;
                uint8_t* st = base + s * kSStage;
                mbar_wait(&empty[s], ((j / kSStages) & 1) ^ 1);
                mbar_expect_tx(&full[s], kSStage);
#pragma unroll
                for (int p = 0; p < 3; ++p) {
                    tma_load_3d(st + p * kSPart, &xmap, &full[s], j * kSK, m0, p);
                    tma_load_3d(st + (3 + p) * kSPart, &ymap, &full[s], j * kSK, m0, p);
                    tma_load_3d(st + (6 + p) * kSPart, &w1map, &full[s], j * kSK, n0, p);
#pragma unroll
                    for (int a = 0; a < kBN / 32; ++a)
                        tma_load_3d(st + (9 + p) * kSPart + a * kSK * 64, &w2map, &full[s],
                                    n0 + 32 * a, j * kSK, p);
                }
            }
        }
        return;
    }

    // ---- consumer warpgroup: rows m0 + 64 wg .. + 64 ----
    const int lane = tid % 32;
    float z[kBN / 2], g[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) z[i] = g[i] = 0.f;
    const uint32_t s0 = smem_addr(base);
    for (int j = 0; j < n_k; ++j) {
        const int s = j % kSStages;
        const uint32_t st = s0 + s * kSStage;
        mbar_wait(&full[s], (j / kSStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < kSplitTerms; ++t)
#pragma unroll
            for (int kk = 0; kk < kSK / 16; ++kk) {   // k16 steps: 32 bytes into the swizzled rows
                const uint32_t a_off = split_part(t, 0) * kSPart + wg * 64 * kSK * 2 + kk * 32;
                const uint32_t b_part = split_part(t, 1) * kSPart;
                WgmmaSS<kBN>::run(z, gmma_desc(st + a_off, 16, 8 * kSK * 2, 2),
                                  gmma_desc(st + 6 * kSPart + b_part + kk * 32, 16, 8 * kSK * 2, 2),
                                  1);
                // W2's tile MN-major: 16 rows of W a step, its four 32-column
                // atoms kSK * 64 bytes apart
                WgmmaSSMn128::run(g, gmma_desc(st + 3 * kSPart + a_off, 16, 8 * kSK * 2, 2),
                                  gmma_desc(st + 9 * kSPart + b_part + kk * 16 * 64, kSK * 64,
                                            8 * 64, 2),
                                  1);
            }
        wgmma_commit();
        wgmma_wait<1>();   // step j - 1's products are done: release its stage
        if (j > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[(j - 1) % kSStages]);
        }
    }
    wgmma_wait<0>();
    fence_operand(z);
    fence_operand(g);
    epilogue(z, g, base, b1, h, dz, db1_part, T, H, Hp, m0, n0, act, wg, tid);
}

}  // namespace mbwd
}  // namespace rv

// bf16 x, dy [T, W], w1 [H, W], w2 [W, H], b1 [H], contiguous, W, H % 8 ==
// 0, x, dy, w1, w2, h and dz 16-byte aligned (the wrapper pads other widths
// and passes fresh or `_aligned` tensors); h, dz [T, H] bf16 out; db1_part
// [ceil(T / 128), H] fp32 out: each 128-row tile's column sums of dz.
extern "C" int rv_fused_mlp_bwd_tc(const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* dy, void* h, void* dz,
                                   void* db1_part, int T, int W, int H, int act, void* stream) {
    using namespace rv::mbwd;
    if (T < 0 || W < 1 || H < 1 || W % 8 || H % 8 || (act != kGelu && act != kQuickGelu))
        return rv::kUnsupported;
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (!(a16(x) && a16(w1) && a16(w2) && a16(dy) && a16(h) && a16(dz))) return rv::kUnsupported;
    if (T == 0) return 0;
    CUtensorMap xm, ym, w1m, w2m;
    if (!make_map_2d(&xm, x, W, T, kBM) || !make_map_2d(&ym, dy, W, T, kBM) ||
        !make_map_2d(&w1m, w1, W, H, kBN) || !make_map_2d(&w2m, w2, H, W, kBK))
        return rv::tc::kMapError;
    cudaError_t err = cudaFuncSetAttribute(mlp_bwd_wgmma,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rv::ceil_div(H, kBN), rv::ceil_div(T, kBM));
    mlp_bwd_wgmma<<<grid, kTcThreads, kTcSmem, static_cast<cudaStream_t>(stream)>>>(
        xm, ym, w1m, w2m, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(h),
        static_cast<__nv_bfloat16*>(dz), static_cast<float*>(db1_part), T, W, H, act);
    return (int)cudaGetLastError();
}

extern "C" {
int rv_split_parts(const void* x, void* out, int rows, int cols, int out_rows, int pitch,
                   int parts, int dtype, void* stream);   // fused_mlp.cu
}

// fp32 x, dy [T, W] (contiguous, any alignment); w1p [3][H][Wp] and w2p
// [3][W][Hp], the weights' parts (ops/fused_mlp.py::split_mlp_weights; Wp,
// Hp: W, H rounded up to 8); b1 [H] fp32; scratch xp, dyp [3][T][Wp] bf16;
// h, dz [T, Hp] fp32 out (the pad columns zero); db1_part [ceil(T / 128),
// Hp] fp32 out: each 128-row tile's column sums of dz. The parts, the
// scratch, h and dz 16-byte aligned. w_pitch, h_pitch: the caller's Wp and
// Hp, the pitches it allocated the parts, scratch and outputs at, which
// must be this file's (else unsupported, nothing written). Three launches:
// the split pass of x and of dY (rv_split_parts), then the kernel.
extern "C" int rv_fused_mlp_bwd_split(const void* x, const void* w1p, const void* b1,
                                      const void* w2p, const void* dy, void* xp, void* dyp,
                                      void* h, void* dz, void* db1_part, int T, int W, int H,
                                      int act, int w_pitch, int h_pitch, void* stream) {
    using namespace rv::mbwd;
    if (T < 0 || W < 1 || H < 1 || (act != kGelu && act != kQuickGelu)) return rv::kUnsupported;
    const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (!(a16(w1p) && a16(w2p) && a16(xp) && a16(dyp) && a16(h) && a16(dz)))
        return rv::kUnsupported;
    const int Wp = (W + 7) / 8 * 8, Hp = (H + 7) / 8 * 8;
    if (w_pitch != Wp || h_pitch != Hp) return rv::kUnsupported;
    if (T == 0) return 0;
    int status = rv_split_parts(x, xp, T, W, T, Wp, 3, rv::kFloat32, stream);
    if (status == 0) status = rv_split_parts(dy, dyp, T, W, T, Wp, 3, rv::kFloat32, stream);
    if (status != 0) return status;
    CUtensorMap xm, ym, w1m, w2m;
    using rv::tc::make_map_parts;
    if (!make_map_parts(&xm, xp, Wp, T, kBM) || !make_map_parts(&ym, dyp, Wp, T, kBM) ||
        !make_map_parts(&w1m, w1p, Wp, H, kBN) || !make_map_parts(&w2m, w2p, Hp, W, kSK))
        return rv::tc::kMapError;
    cudaError_t err = cudaFuncSetAttribute(mlp_bwd_split,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(rv::ceil_div(Hp, kBN), rv::ceil_div(T, kBM));
    mlp_bwd_split<<<grid, kTcThreads, kSSmem, static_cast<cudaStream_t>(stream)>>>(
        xm, ym, w1m, w2m, static_cast<const float*>(b1), static_cast<float*>(h),
        static_cast<float*>(dz), static_cast<float*>(db1_part), T, Wp, H, Hp, act);
    return (int)cudaGetLastError();
}
