// Backward of the heads-in-lanes attention (K3's gradient) in bf16, on
// Hopper's tensor cores: wgmma + TMA.
//
// Replaces: no TPU kernel. reverso_tpu/ops/attention.py::_flash_heads_kernel
// (K3, pallas_call at :467) has no backward (jax.grad through it fails to
// linearize). This file gives the port's bf16 K3 forward its gradient at
// head dims % 16 == 0, <= 128 with 16-byte aligned bases
// (ops/attention.py::heads_bwd_route); fp32 and other head dims keep
// flash_heads_bwd.cu's CUDA-core kernels.
//
// What it computes, per (b, head), at the forward's rounding points
// (flash_tc.cuh): qr = bf16(rot(q) * scale) and kr = bf16(rot(k)) with
// RoPE (else qr = q, kr = k and the scale multiplies the fp32 scores), s =
// qr kr^T in fp32, P = exp(s - lse) with the forward's log-sum-exp (base 2,
// rv_flash_heads_tc's lse output), keys at or past kv_valid masked, dP = dO
// v^T, D = rowsum(fp32(dO) fp32(o)) from the forward's bf16 output, dS = P
// (dP - D); P and dS rounded to bf16 before their products, fp32 sums;
// dq = rot^T(scale dS kr), dk = rot^T(dS^T qr) (times the scale without
// RoPE), dv = P^T dO, each rounded once to bf16. Keys at or past kv_valid
// get dk = dv = 0. ops/attention.py::flash_attention_heads_grad_tc_ref
// spells this arithmetic out.
//
// Layout: FlashAttention-2's scheme, three kernels a call, no atomics:
//   1. prep_kernel, one CTA per 8 rows of [B * S, W]: qr and kr rotated
//      once into [B, S, W] scratch (RoPE only) and D per (row, head), so
//      that the products read plain bf16 tiles and no kernel sweeps the keys
//      for statistics;
//   2. dq_kernel, one CTA per (64 query rows a consumer warpgroup, head,
//      b): S = qr kr^T and dP = dO v^T (SS), dS in registers, dq += dS kr
//      (RS, kr MN-major), over the key tiles;
//   3. dkv_kernel, one CTA per (64 keys a consumer warpgroup, head, b):
//      S^T = kr qr^T and dP^T = v dO^T (SS), dv += P^T dO and dk += dS^T qr
//      (RS, P^T and dS^T taken from the accumulators' registers as the
//      forward takes p), over the query tiles.
// Each of the two product kernels has a producer warpgroup (one thread
// issues TMA loads with 3-D [B, S, W] maps and a one-head box, so the
// hardware zero-fills rows past S and nothing is padded in memory; in the
// dk/dv kernel one warp also brings each query tile's lse and D, a tile
// ahead) and consumer warpgroups of 64 rows, which keep their own tiles
// (qr and dO, or kr and v) resident and stream the other side through a
// four-stage mbarrier ring: one a CTA and two CTAs an SM up to head dim
// 80, two a CTA above (Cfg). The products of a tile are the forward's
// helpers (flash_tc.cuh::qk_tile, pv_tile). Each loop starts tile j + 1's
// two SS products (a commit group each) before the RS products of tile j,
// and computes tile j + 1's P as soon as S lands and dS as soon as dP
// does, while the products behind them run. A consumer holds dk, dv, S^T
// and dP^T and the bf16 fragments of P^T and dS^T (setmaxnreg: 216
// registers a thread with one consumer warpgroup, 232 with two). The
// epilogue parks each fp32 tile in the ring's shared memory, applies
// rot^T with the partner column hd / 4 away in the same row, and stores
// bf16 rows 16 bytes at a time, two units' loads in flight a thread.
//
// What bounds it on the H100: seven products of B H S^2 hd multiply-adds
// (five for the gradient, s and dP recomputed in the dk/dv kernel) on the
// bf16 tensor cores, against q, k, v, o, dO read and dq, dk, dv written
// once: at PE-L14's training shape (B = 16, S = 577, W = 1024, 16 heads of
// 64) the 64-row tiles make 10 x 10 tile pairs per (b, head), 94 GFLOP,
// 0.095 ms at 989 TFLOP/s, far above the bytes (0.04 ms). Above that
// (scripts/heads_bwd_probe.py at that shape on the H100): with neither
// products nor arithmetic the dq and dk / dv kernels still took 0.0687
// and 0.0953 ms of 0.1015 and 0.1492 (each CTA streams its head's other
// side from L2, and its prologue and epilogue), and the prep pass, bound
// by its 114 MB (0.034 ms), 0.048.
#include "common.cuh"
#include "flash_tc.cuh"

namespace rv {
namespace hbwd {

using namespace tc;

constexpr int kRows = 64;             // rows of a tile: queries or keys (wgmma M)
constexpr int kProducerRegs = 40;
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

struct TcParams {
    const float* cos_t;   // [S, hd] fp32 (RoPE only)
    const float* sin_t;
    const float* lse;     // [B * heads, S]: the forward's log-sum-exp, base 2
    const float* dsum;    // [B * heads, S]: D
    __nv_bfloat16* dq;
    __nv_bfloat16* dk;
    __nv_bfloat16* dv;
    int S, W, heads, kv;
    int rope;
    float score_mul;      // the forward's: log2(e), times the scale without RoPE
    float dq_mul;         // the scale
    float dk_mul;         // 1 with RoPE (the scale is in qr), else the scale
};

// the rotated value of x (against its partner xp, both fp32) by the
// tables' cos and sin at its column, as flash_tc.cuh::rope_tile computes
// it: lower quarters x cos - xp sin, upper x cos + xp sin
__device__ __forceinline__ float rot1(float x, float xp, float cs, float sn, bool lower) {
    return __fadd_rn(__fmul_rn(x, cs), __fmul_rn(lower ? -xp : xp, sn));
}

// qr = bf16(rot(q) * scale) and kr = bf16(rot(k)) with RoPE, against the
// partner hd / 4 away in fp32, as flash_tc.cuh::rope_tile rounds them, and
// D = rowsum(fp32(dO) * fp32(o)) of each (row, head). A CTA takes
// kPrepRows rows of [B * S, W]; a thread takes 8 adjacent columns at a
// time (16-byte loads of q, k, their partners (where a quarter of the head
// is whole 8-column units, else element by element), the tables, o and dO;
// 16-byte stores of qr and kr) and parks its 8 columns' part of D in
// shared memory, which one thread a (row, head) then adds in column order.
constexpr int kPrepRows = 8;

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dO,
            const float* __restrict__ cos_t, const float* __restrict__ sin_t,
            __nv_bfloat16* __restrict__ qr, __nv_bfloat16* __restrict__ kr,
            float* __restrict__ dsum, int rows, int S, int W, int heads, float scale, int rope) {
    extern __shared__ float part[];   // [kPrepRows][W / 8]
    const int hd = W / heads, qtr = hd / 4, units = W / 8;
    const int row0 = blockIdx.x * kPrepRows;
    const int n = min(kPrepRows, rows - row0) * units;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n; idx += kPrepThreads) {
        const int row = row0 + idx / units, c = (idx % units) * 8;
        const size_t off = (size_t)row * W + c;
        float x[8], xp[8];
        load8(o + off, x);
        load8(dO + off, xp);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(xp[e], x[e], acc);
        part[idx] = acc;
        if (!rope) continue;
        const int d = c % hd;
        float cs[8], sn[8];
        load8(cos_t + (size_t)(row % S) * hd + d, cs);
        load8(sin_t + (size_t)(row % S) * hd + d, sn);
#pragma unroll
        for (int t = 0; t < 2; ++t) {   // q, then k
            const __nv_bfloat16* src = t ? k : q;
            load8(src + off, x);
            if (qtr % 8 == 0) {
                const bool lower = (d / qtr) % 2 == 0;
                load8(src + off + (lower ? qtr : -qtr), xp);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const bool lower = ((d + e) / qtr) % 2 == 0;
                    xp[e] = __bfloat162float((src + off)[e + (lower ? qtr : -qtr)]);
                }
            }
            const float mul = t ? 1.f : scale;
            uint32_t y[4];
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
                const bool lo0 = ((d + e) / qtr) % 2 == 0, lo1 = ((d + e + 1) / qtr) % 2 == 0;
                y[e / 2] = pack_bf16(__fmul_rn(rot1(x[e], xp[e], cs[e], sn[e], lo0), mul),
                                     __fmul_rn(rot1(x[e + 1], xp[e + 1], cs[e + 1], sn[e + 1],
                                                    lo1), mul));
            }
            *reinterpret_cast<uint4*>((t ? kr : qr) + off) = make_uint4(y[0], y[1], y[2], y[3]);
        }
    }
    __syncthreads();
    const int per_head = hd / 8;
    for (int idx = threadIdx.x; idx < kPrepRows * heads; idx += kPrepThreads) {
        const int row = row0 + idx / heads, h = idx % heads;
        if (row >= rows) break;
        const float* pr = part + (idx / heads) * units + h * per_head;
        float acc = 0.f;
        for (int u = 0; u < per_head; ++u) acc += pr[u];
        dsum[((size_t)(row / S) * heads + h) * S + row % S] = acc;
    }
}

// A CTA's shape and shared memory by head dim. Up to head dim 80, one
// consumer warpgroup a CTA and two CTAs an SM, so that one CTA's prologue
// (the resident tiles, the ring's first loads) and epilogue overlap the
// other's products; above, two consumer warpgroups (128 rows) in one CTA
// an SM share the streamed tiles (scripts/heads_bwd_probe.py on the H100:
// at PE-L14's head dim 64 the first took 0.3011 ms against 0.3333, at
// PE-G14's head dim 96 the second 0.2910 against 0.3888, where one
// warpgroup's dk / dv kernel spilled). The producer warpgroup keeps kProducerRegs
// registers a thread and hands the rest of the CTA's share of the register
// file to the consumers (setmaxnreg). Shared memory: each consumer
// warpgroup's two resident tiles, the ring's two arrays of tiles, the
// dk/dv kernel's lse and D a stage, the barriers; the epilogue's fp32
// tiles reuse the ring.
template <int HD>
struct Cfg {
    static constexpr int NWG = HD <= 80 ? 1 : 2;          // consumer warpgroups a CTA
    static constexpr int CTAS = HD <= 80 ? 2 : 1;         // CTAs an SM (the launch bound)
    static constexpr int STAGES = 4;                      // the ring's depth
    static constexpr int THREADS = (NWG + 1) * kWgThreads;
    static constexpr int CONSUMER_REGS = cmin(
        256, ((65536 / CTAS / THREADS) / 8 * 8 * (NWG + 1) - kProducerRegs) / NWG / 8 * 8);
    static constexpr int TILE = kRows * HD * 2;           // one bf16 [64][HD] tile
    static constexpr int SIDE = NWG * 2 * TILE;           // resident: two tiles a warpgroup
    static constexpr int RING = 2 * STAGES * TILE;
    static constexpr int STATS = STAGES * 2 * kRows * 4;
    static constexpr int LD = HD + 4;                     // the epilogue's fp32 row pitch
    static constexpr int BYTES = 1024 + SIDE + RING + STATS + 8 * (1 + 2 * STAGES);
    static_assert(CTAS * (BYTES + 1024) <= 233472, "CTAS CTAs fit an SM");
    static_assert(NWG * kRows * LD * 4 <= RING, "the epilogue's tiles fit the ring");
};

__device__ __forceinline__ uint8_t* smem_base() {
    extern __shared__ uint8_t smem_raw[];
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));
}

// the two resident tiles of each consumer warpgroup (rows row0 + 64 g of
// amap and bmap, every atom of the head's columns) onto one barrier
template <int HD>
__device__ __forceinline__ void load_side(uint8_t* side, uint64_t* bar, const CUtensorMap* amap,
                                          const CUtensorMap* bmap, int col0, int row0, int z) {
    using G = Geo<HD>;
    using L = Cfg<HD>;
    mbar_expect_tx(bar, L::SIDE);
#pragma unroll
    for (int g = 0; g < L::NWG; ++g)
#pragma unroll
        for (int a = 0; a < G::NATOM; ++a) {
            const int off = a * kRows * G::ATOM_BYTES;
            tma_load_3d(side + 2 * g * L::TILE + off, amap, bar, col0 + a * G::ATOM,
                        row0 + g * kRows, z);
            tma_load_3d(side + (2 * g + 1) * L::TILE + off, bmap, bar, col0 + a * G::ATOM,
                        row0 + g * kRows, z);
        }
}

// a consumer's fp32 accumulator [64][HD] (rows warp * 16 + g and + 8,
// columns 8n + 2t and + 1) times `mul` into buf [64][LD]
template <int HD>
__device__ __forceinline__ void park(float* buf, const float (&acc)[HD / 2], float mul, int warp,
                                     int g, int t) {
    constexpr int LD = Cfg<HD>::LD;
    float* ra = buf + (warp * 16 + g) * LD;
    float* rb = ra + 8 * LD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        const int c = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(ra + c) = make_float2(acc[4 * n] * mul, acc[4 * n + 1] * mul);
        *reinterpret_cast<float2*>(rb + c) =
            make_float2(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
    }
}

// buf's rows (rows row0.. of one head; dst at the head's first column of
// row 0, row stride W) to bf16, 8 columns a thread and one 16-byte store,
// through the transpose of the rotation with ROPE: rot^T(y)[d] = cos[d]
// y[d] - sgn(d) sin[p(d)] y[p(d)] (flash_heads_bwd.cu::store_tile's
// order of operations); rows at or past S are not written. A thread
// loads two units (their values, partners and table rows: 16-byte loads
// where a quarter of the head is whole units) before it computes either,
// so that the table reads overlap.
// 8 fp32 values from shared memory (16-byte aligned)
__device__ __forceinline__ void smem8(const float* p, float (&x)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* buf, int row0,
                                           const TcParams& p, bool rope, int tid) {
    constexpr int LD = Cfg<HD>::LD, UPR = HD / 8, QTR = HD / 4;
    constexpr int ITERS = kRows * UPR / kWgThreads;   // units a thread
    constexpr int BATCH = ITERS < 2 ? ITERS : 2;
    constexpr bool VEC = QTR % 8 == 0;                // a unit lies in one quarter
    static_assert(kRows * UPR % kWgThreads == 0, "whole units a thread");
#pragma unroll 1
    for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
        float y[BATCH][8], yp[BATCH][8], cs[BATCH][8], sn[BATCH][8];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int u = tid + (it0 + b) * kWgThreads;
            const int r = u / UPR, c = (u % UPR) * 8, row = row0 + r;
            if (it0 + b >= ITERS || row >= p.S) continue;
            smem8(buf + r * LD + c, y[b]);
            if (VEC && rope) {
                const int pc = (c / QTR) % 2 == 0 ? c + QTR : c - QTR;
                smem8(buf + r * LD + pc, yp[b]);
                load8(p.cos_t + (size_t)row * HD + c, cs[b]);
                load8(p.sin_t + (size_t)row * HD + pc, sn[b]);
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int u = tid + (it0 + b) * kWgThreads;
            const int r = u / UPR, c = (u % UPR) * 8, row = row0 + r;
            if (it0 + b >= ITERS || row >= p.S) continue;
            float* v = y[b];
            if (rope) {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int d = c + e;
                    const bool lower = (d / QTR) % 2 == 0;
                    if (VEC) {
                        v[e] = __fsub_rn(__fmul_rn(v[e], cs[b][e]),
                                         __fmul_rn(lower ? -yp[b][e] : yp[b][e], sn[b][e]));
                    } else {
                        const int pd = lower ? d + QTR : d - QTR;
                        const size_t t = (size_t)row * HD;
                        const float ypd = buf[r * LD + pd];
                        v[e] = __fsub_rn(__fmul_rn(v[e], __ldg(p.cos_t + t + d)),
                                         __fmul_rn(lower ? -ypd : ypd, __ldg(p.sin_t + t + pd)));
                    }
                }
            }
            *reinterpret_cast<uint4*>(dst + (size_t)row * p.W + c) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                           pack_bf16(v[6], v[7]));
        }
    }
}

// dq: one CTA per (64 query rows a consumer warpgroup, head, b); maps over
// qr, kr, v and dO
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::CTAS)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
          const TcParams p) {
    using L = Cfg<HD>;
    constexpr int kStages = L::STAGES, kNwg = L::NWG;
    uint8_t* side = smem_base();                  // [kNwg][qr, dO]
    uint8_t* ks = side + L::SIDE;                     // [kStages] kr tiles
    uint8_t* vs = ks + kStages * L::TILE;             // [kStages] v tiles
    uint64_t* bar = reinterpret_cast<uint64_t*>(vs + kStages * L::TILE + L::STATS);
    uint64_t* full = bar + 1;
    uint64_t* empty = full + kStages;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * kNwg * kRows, col0 = h * HD;
    const int n_tiles = ceil_div(p.kv, kRows);
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kNwg * 4);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == kNwg) {
        // ---- producer: one thread keeps the ring full ----
        setmaxnreg_dec<kProducerRegs>();
        if (tid == 0) {
            load_side<HD>(side, bar, &qmap, &omap, col0, q0, b);
            for (int j = 0; j < n_tiles; ++j)
                load_kv<HD, kRows, kStages>(j, ks, vs, full, empty, &kmap, &vmap, col0, b);
        }
        return;
    }

    // ---- consumer warpgroup: query rows q0 + 64 wg .. + 64 ----
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + wg * kRows + warp * 16 + g;   // this thread's rows r0 and r0 + 8
    const size_t srow = ((size_t)b * p.heads + h) * p.S;
    // rows past S: P = 0 (their scratch is never read)
    const float lse0 = r0 < p.S ? p.lse[srow + r0] : CUDART_INF_F;
    const float lse1 = r0 + 8 < p.S ? p.lse[srow + r0 + 8] : CUDART_INF_F;
    const float d0 = r0 < p.S ? p.dsum[srow + r0] : 0.f;
    const float d1 = r0 + 8 < p.S ? p.dsum[srow + r0 + 8] : 0.f;
    const float mul = p.score_mul;
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    float sc[kRows / 2], dp[kRows / 2];
    uint32_t pa[1][kRows / 16][4];
    const uint32_t q_addr = smem_addr(side + 2 * wg * L::TILE);
    const uint32_t o_addr = q_addr + L::TILE;
    auto k_addr = [&](int j) { return smem_addr(ks + (j % kStages) * L::TILE); };
    auto v_addr = [&](int j) { return smem_addr(vs + (j % kStages) * L::TILE); };
    auto wait_tile = [&](int j) { mbar_wait(&full[j % kStages], (j / kStages) & 1); };
    auto release = [&](int j) {   // this warp is done with tile j's stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };
    // tile j's P = 2^(s * mul - lse), in place in sc; keys at or past
    // kv_valid score -inf (P = 0)
    auto probs = [&](int j) {
        const int kb = j * kRows;
        if (kb + kRows > p.kv) {
#pragma unroll
            for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (kb + 8 * n + 2 * t + e >= p.kv)
                        sc[4 * n + e] = sc[4 * n + 2 + e] = -CUDART_INF_F;
        }
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], mul, -lse0));
                sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], mul, -lse1));
            }
    };
    // then dS = P (dP - D), in place in sc
    auto grad_scores = [&]() {
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[4 * n + e] *= dp[4 * n + e] - d0;
                sc[4 * n + 2 + e] *= dp[4 * n + 2 + e] - d1;
            }
    };

    mbar_wait(bar, 0);
    // with dS_j in registers, start S, then dP of tile j + 1 (a commit
    // group each), then dq += dS_j kr_j; P_{j+1} as soon as S lands, dS_{j+1}
    // as soon as dP does, while the products behind them run
    wait_tile(0);
    wgmma_fence();
    qk_tile<HD, kRows, 1>(sc, q_addr, k_addr(0));
    qk_tile<HD, kRows, 1>(dp, o_addr, v_addr(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);
    probs(0);
    grad_scores();
    pack_p<kRows, 1>(sc, pa);
    for (int j = 0; j + 1 < n_tiles; ++j) {
        wait_tile(j + 1);
        wgmma_fence();
        qk_tile<HD, kRows, 1>(sc, q_addr, k_addr(j + 1));
        wgmma_commit();
        qk_tile<HD, kRows, 1>(dp, o_addr, v_addr(j + 1));
        wgmma_commit();
        pv_tile<HD, kRows, 1>(dq, pa, k_addr(j));
        wgmma_commit();
        wgmma_wait<2>();
        fence_operand(sc);
        probs(j + 1);
        wgmma_wait<1>();
        fence_operand(dp);
        grad_scores();
        wgmma_wait<0>();
        fence_operand(dq);
        release(j);
        pack_p<kRows, 1>(sc, pa);
    }
    wgmma_fence();
    pv_tile<HD, kRows, 1>(dq, pa, k_addr(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dq);
    release(n_tiles - 1);

    // epilogue: every consumer is done with the ring, which takes the
    // fp32 tiles; dq = rot^T(scale dS kr)
    named_bar_sync(1, kNwg * kWgThreads);
    float* buf = reinterpret_cast<float*>(ks) + wg * kRows * L::LD;
    park<HD>(buf, dq, p.dq_mul, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_rows<HD>(p.dq + (size_t)b * p.S * p.W + col0, buf, q0 + wg * kRows, p, p.rope != 0,
                   tid);
}

// dk, dv: one CTA per (64 keys a consumer warpgroup, head, b); the same
// maps
template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::CTAS)
dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
           const TcParams p) {
    using G = Geo<HD>;
    using L = Cfg<HD>;
    constexpr int kStages = L::STAGES, kNwg = L::NWG;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int h = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * kNwg * kRows, col0 = h * HD;
    const size_t ob = (size_t)b * p.S * p.W + col0;
    if (k0 >= p.kv) {
        // every key of this CTA is at or past kv_valid: dk = dv = 0
        constexpr int UPR = HD / 8;
        for (int u = threadIdx.x; u < kNwg * kRows * UPR; u += L::THREADS) {
            const int row = k0 + u / UPR, c = (u % UPR) * 8;
            if (row >= p.S) continue;
            *reinterpret_cast<uint4*>(p.dk + ob + (size_t)row * p.W + c) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(p.dv + ob + (size_t)row * p.W + c) = make_uint4(0, 0, 0, 0);
        }
        return;
    }
    uint8_t* side = smem_base();                  // [kNwg][kr, v]
    uint8_t* qs = side + L::SIDE;                     // [kStages] qr tiles
    uint8_t* os = qs + kStages * L::TILE;             // [kStages] dO tiles
    float* stats = reinterpret_cast<float*>(os + kStages * L::TILE);   // [kStages][lse, D][64]
    uint64_t* bar = reinterpret_cast<uint64_t*>(os + kStages * L::TILE + L::STATS);
    uint64_t* full = bar + 1;       // the TMA bytes and the 32 lanes' lse and D
    uint64_t* empty = full + kStages;
    const int n_tiles = ceil_div(p.S, kRows);
    const size_t srow = ((size_t)b * p.heads + h) * p.S;
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 32);
            mbar_init(&empty[s], kNwg * 4);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == kNwg) {
        // ---- producer: warp 0; lane 0 loads the tiles, every lane writes
        // its rows' lse and D (rows past S: lse = +inf, so P = 0) before it
        // arrives on the stage's full barrier ----
        setmaxnreg_dec<kProducerRegs>();
        if (tid >= 32) return;
        const int lane = tid;
        if (lane == 0) load_side<HD>(side, bar, &kmap, &vmap, col0, k0, b);
        // this lane's rows of a tile's lse and D, loaded a tile ahead so
        // that their latency passes while the producer waits for a stage
        float nl[2], nd[2];
        auto fetch = [&](int i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = i * kRows + lane + 32 * h;
                nl[h] = row < p.S ? p.lse[srow + row] : CUDART_INF_F;
                nd[h] = row < p.S ? p.dsum[srow + row] : 0.f;
            }
        };
        fetch(0);
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % kStages;
            mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
            float* st = stats + s * 2 * kRows;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                st[lane + 32 * h] = nl[h];
                st[kRows + lane + 32 * h] = nd[h];
            }
            if (i + 1 < n_tiles) fetch(i + 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
                for (int a = 0; a < G::NATOM; ++a) {
                    const int off = s * L::TILE + a * kRows * G::ATOM_BYTES;
                    tma_load_3d(qs + off, &qmap, &full[s], col0 + a * G::ATOM, i * kRows, b);
                    tma_load_3d(os + off, &omap, &full[s], col0 + a * G::ATOM, i * kRows, b);
                }
            } else {
                mbar_arrive(&full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroup: keys k0 + 64 wg .. + 64 ----
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = k0 + wg * kRows + warp * 16 + g;   // this thread's keys r0 and r0 + 8
    const bool live0 = r0 < p.kv, live1 = r0 + 8 < p.kv;
    const float mul = p.score_mul;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float st_[kRows / 2], dpt[kRows / 2];   // S^T, then P^T; dP^T, then dS^T
    uint32_t pf[1][kRows / 16][4], df[1][kRows / 16][4];
    const uint32_t k_addr = smem_addr(side + 2 * wg * L::TILE);
    const uint32_t v_addr = k_addr + L::TILE;
    auto q_addr = [&](int i) { return smem_addr(qs + (i % kStages) * L::TILE); };
    auto o_addr = [&](int i) { return smem_addr(os + (i % kStages) * L::TILE); };
    auto wait_tile = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
    auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
    };
    // query tile i's P^T, in place in st_: columns are queries, with their
    // lse from the stage; keys at or past kv_valid get P = 0
    auto probs = [&](int i) {
        const float* st = stats + (i % kStages) * 2 * kRows;
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
            const float lc[2] = {l2.x, l2.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                st_[4 * n + e] = live0 ? ex2(fmaf(st_[4 * n + e], mul, -lc[e])) : 0.f;
                st_[4 * n + 2 + e] = live1 ? ex2(fmaf(st_[4 * n + 2 + e], mul, -lc[e])) : 0.f;
            }
        }
    };
    // then dS^T = P^T (dP^T - D), in place in dpt, with D from the stage
    auto grad_scores = [&](int i) {
        const float* st = stats + (i % kStages) * 2 * kRows + kRows;
#pragma unroll
        for (int n = 0; n < kRows / 8; ++n) {
            const float2 d2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * t);
            const float dc[2] = {d2.x, d2.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                dpt[4 * n + e] = st_[4 * n + e] * (dpt[4 * n + e] - dc[e]);
                dpt[4 * n + 2 + e] = st_[4 * n + 2 + e] * (dpt[4 * n + 2 + e] - dc[e]);
            }
        }
    };

    mbar_wait(bar, 0);
    // as the dq kernel: S^T and dP^T of tile i + 1 (a commit group each),
    // then dv += P^T_i dO_i and dk += dS^T_i qr_i, each step's elementwise
    // work as soon as its product lands
    wait_tile(0);
    wgmma_fence();
    qk_tile<HD, kRows, 1>(st_, k_addr, q_addr(0));
    qk_tile<HD, kRows, 1>(dpt, v_addr, o_addr(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(st_);
    fence_operand(dpt);
    probs(0);
    grad_scores(0);
    pack_p<kRows, 1>(st_, pf);
    pack_p<kRows, 1>(dpt, df);
    for (int i = 0; i + 1 < n_tiles; ++i) {
        wait_tile(i + 1);
        wgmma_fence();
        qk_tile<HD, kRows, 1>(st_, k_addr, q_addr(i + 1));
        wgmma_commit();
        qk_tile<HD, kRows, 1>(dpt, v_addr, o_addr(i + 1));
        wgmma_commit();
        pv_tile<HD, kRows, 1>(dv, pf, o_addr(i));
        pv_tile<HD, kRows, 1>(dk, df, q_addr(i));
        wgmma_commit();
        wgmma_wait<2>();
        fence_operand(st_);
        probs(i + 1);
        wgmma_wait<1>();
        fence_operand(dpt);
        grad_scores(i + 1);
        wgmma_wait<0>();
        fence_operand(dv);
        fence_operand(dk);
        release(i);
        pack_p<kRows, 1>(st_, pf);
        pack_p<kRows, 1>(dpt, df);
    }
    wgmma_fence();
    pv_tile<HD, kRows, 1>(dv, pf, o_addr(n_tiles - 1));
    pv_tile<HD, kRows, 1>(dk, df, q_addr(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dv);
    fence_operand(dk);
    release(n_tiles - 1);

    // epilogue: dv as it is, then dk = rot^T(dS^T qr) (times the scale
    // without RoPE), each through the ring's shared memory
    named_bar_sync(1, kNwg * kWgThreads);
    float* buf = reinterpret_cast<float*>(qs) + wg * kRows * L::LD;
    const int row0 = k0 + wg * kRows;
    park<HD>(buf, dv, 1.f, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_rows<HD>(p.dv + ob, buf, row0, p, false, tid);
    named_bar_sync(2 + wg, kWgThreads);
    park<HD>(buf, dk, p.dk_mul, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_rows<HD>(p.dk + ob, buf, row0, p, p.rope != 0, tid);
}

template <int HD>
int launch_bwd(const void* qs, const void* ks, const void* v, const void* dO, const TcParams& p,
           int B, cudaStream_t stream) {
    using L = Cfg<HD>;
    CUtensorMap qm, km, vm, om;
    if (!make_map<HD>(&qm, qs, p.W, p.S, B, kRows) || !make_map<HD>(&km, ks, p.W, p.S, B, kRows)
        || !make_map<HD>(&vm, v, p.W, p.S, B, kRows) || !make_map<HD>(&om, dO, p.W, p.S, B, kRows))
        return kMapError;
    auto* k1 = dq_kernel<HD>;
    auto* k2 = dkv_kernel<HD>;
    cudaError_t err =
        cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (L::CTAS > 1 && err == cudaSuccess)   // room for every CTA an SM holds
        err = cudaFuncSetAttribute(k1, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (L::CTAS > 1 && err == cudaSuccess)
        err = cudaFuncSetAttribute(k2, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(p.S, L::NWG * kRows), p.heads, B);
    k1<<<grid, L::THREADS, L::BYTES, stream>>>(qm, km, vm, om, p);
    k2<<<grid, L::THREADS, L::BYTES, stream>>>(qm, km, vm, om, p);
    return (int)cudaGetLastError();
}

}  // namespace hbwd
}  // namespace rv

// bf16 q, k, v, o (the forward's output), dO [B, S, W] (W = heads * hd,
// contiguous, 16-byte aligned), lse [B * heads, S] fp32 (the forward's,
// rv_flash_heads_tc), cos_t, sin_t [S, hd] fp32 (RoPE only); scratch qr, kr
// [B, S, W] bf16 (RoPE only) and dsum [B * heads, S] fp32; dq, dk, dv [B,
// S, W] bf16 out. hd % 16 == 0, hd <= 128, 1 <= kv_valid <= S.
extern "C" int rv_flash_heads_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                                     const void* dO, const void* lse, const void* cos_t,
                                     const void* sin_t, void* qr, void* kr, void* dsum, void* dq,
                                     void* dk, void* dv, int B, int S, int W, int heads,
                                     int kv_valid, float scale, int use_rope, void* stream) {
    using namespace rv::hbwd;
    if (B < 1 || S < 1 || heads < 1 || W % heads) return rv::kUnsupported;
    const int hd = W / heads;
    if (hd % 16 || hd > 128 || kv_valid < 1 || kv_valid > S) return rv::kUnsupported;
    if (use_rope && (cos_t == nullptr || sin_t == nullptr || qr == nullptr || kr == nullptr))
        return rv::kUnsupported;
    using rv::tc::aligned16;
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(dO) &&
          aligned16(dq) && aligned16(dk) && aligned16(dv)))
        return rv::kUnsupported;
    const auto st = static_cast<cudaStream_t>(stream);
    using bf = __nv_bfloat16;
    prep_kernel<<<rv::ceil_div(B * S, kPrepRows), kPrepThreads, kPrepRows * (W / 8) * 4, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(o),
        static_cast<const bf*>(dO), static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), static_cast<bf*>(qr), static_cast<bf*>(kr),
        static_cast<float*>(dsum), B * S, S, W, heads, scale, use_rope);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    TcParams p;
    p.cos_t = static_cast<const float*>(cos_t);
    p.sin_t = static_cast<const float*>(sin_t);
    p.lse = static_cast<const float*>(lse);
    p.dsum = static_cast<const float*>(dsum);
    p.dq = static_cast<bf*>(dq);
    p.dk = static_cast<bf*>(dk);
    p.dv = static_cast<bf*>(dv);
    p.S = S;
    p.W = W;
    p.heads = heads;
    p.kv = kv_valid;
    p.rope = use_rope;
    p.score_mul = use_rope ? kLog2e : kLog2e * scale;   // as flash_tc.cuh's launch
    p.dq_mul = scale;
    p.dk_mul = use_rope ? 1.f : scale;
    const void* qs = use_rope ? qr : q;
    const void* ks = use_rope ? kr : k;
#define RV_BWD_CASE(HD) \
    case HD: return launch_bwd<HD>(qs, ks, v, dO, p, B, st);
    switch (hd) {
        RV_BWD_CASE(16) RV_BWD_CASE(32) RV_BWD_CASE(48) RV_BWD_CASE(64)
        RV_BWD_CASE(80) RV_BWD_CASE(96) RV_BWD_CASE(112) RV_BWD_CASE(128)
        default: return rv::kUnsupported;
    }
#undef RV_BWD_CASE
}
