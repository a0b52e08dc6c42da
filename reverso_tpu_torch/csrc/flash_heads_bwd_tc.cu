// Backward of the heads-in-lanes attention (K3's gradient) on Hopper's
// tensor cores, wgmma + TMA: bf16, and fp32 in the split mode (three bf16
// parts a value, six products, the forward's fp32 contract).
//
// Replaces: no TPU kernel. reverso_tpu/ops/attention.py::_flash_heads_kernel
// (K3, pallas_call at :467) has no backward (jax.grad through it fails to
// linearize). This file gives the port's K3 forward its gradient at every
// head dim <= 128 (ops/attention.py::heads_bwd_route): bf16 at head dims %
// 16 == 0 with 16-byte aligned bases reads q, k, v and dO as they are
// (rv_flash_heads_bwd_tc); fp32 (the split mode) and bf16 at other head
// dims or bases read the prep pass's zero-padded parts
// (rv_flash_heads_bwd_parts).
//
// What it computes, per (b, head), at the forward's rounding points
// (flash_tc.cuh): in bf16, qr = bf16(rot(q) * scale) and kr = bf16(rot(k))
// with RoPE (else qr = q, kr = k and the scale multiplies the fp32
// scores); in the split mode qr = rot(q) * scale (q * scale without RoPE)
// and kr = rot(k) in fp32, as the split forward folds the scale in. s =
// qr kr^T, P = exp(s - lse) with the forward's log-sum-exp (base 2,
// rv_flash_heads_tc's and rv_flash_heads_split's lse output), keys at or
// past kv_valid masked, dP = dO v^T, D = rowsum(dO o) in fp32 from the
// forward's output, dS = P (dP - D); dq = rot^T(scale dS kr), dk =
// rot^T(dS^T qr) (times the scale in bf16 without RoPE), dv = P^T dO. In
// bf16, P and dS round to bf16 before their products and each output
// rounds once to bf16; in the split mode every operand of every product
// is three bf16 parts (hi, mid, lo) and each product the six part
// products that matter (hopper.cuh::split_part), P and dS are split in
// registers as the split forward splits p, and the outputs are fp32.
// Keys at or past kv_valid get dk = dv = 0. ops/attention.py::
// flash_attention_heads_grad_tc_ref and ::flash_attention_heads_grad_split_ref
// spell the two out.
//
// Layout: FlashAttention-2's scheme, three kernels a call, no atomics:
//   1. a prep kernel, one CTA per 8 rows of [B * S, W]: D per (row, head)
//      and, in bf16 with RoPE, qr and kr rotated once into [B, S, W]
//      scratch; on the parts routes every operand of the products (qr, kr,
//      v and dO) rotated, scaled and split (or rounded to bf16) once into
//      bf16 parts [PARTS][B][S][Wp] (Wp: heads times the head dim padded
//      with zeros to a multiple of 16), so that TMA brings every part tile,
//      no CTA splits a tile again (re-splitting each K/V tile in every CTA
//      is 17-24% of the split forward's time) and head dims that are not a
//      multiple of 16, and bases TMA cannot take, take the same kernels;
//   2. dq_kernel, one CTA per (64 query rows a consumer warpgroup, head,
//      b): S = qr kr^T and dP = dO v^T (SS), dS in registers, dq += dS kr
//      (RS, kr MN-major), over the key tiles;
//   3. dkv_kernel, one CTA per (64 keys a consumer warpgroup, head, b):
//      S^T = kr qr^T and dP^T = v dO^T (SS), dv += P^T dO and dk += dS^T qr
//      (RS, P^T and dS^T taken from the accumulators' registers as the
//      forward takes p), over the query tiles.
// Each of the two product kernels has a producer warpgroup (one thread
// issues TMA loads with 3-D maps, [B, S, W], or [3B, S, Wp] over the
// parts, with a one-head box, so the hardware zero-fills rows past S and
// nothing is padded in memory along S; in the dk/dv kernel one warp also
// brings each query tile's lse and D, a tile ahead) and consumer
// warpgroups of 64 rows, which keep their own tiles (qr and dO, or kr and
// v, every part) resident and stream the other side through an mbarrier
// ring (Cfg). The products of a tile are the forward's helpers
// (flash_tc.cuh::qk_tile, pv_tile, pack_p, one term or the split mode's
// six). Each loop starts tile j + 1's two SS products (a commit group
// each) before the RS products of tile j, and computes tile j + 1's P as
// soon as S lands and dS as soon as dP does, while the products behind
// them run. The epilogue parks each fp32 tile in the ring's shared memory,
// applies rot^T with the partner column hd / 4 away in the same row, and
// stores rows (bf16, 16 bytes a thread, two units' loads in flight; fp32,
// 16 bytes a thread).
//
// What bounds it on the H100: seven products of B H S^2 hd multiply-adds
// (five for the gradient, s and dP recomputed in the dk/dv kernel) on the
// tensor cores, against q, k, v, o, dO read and dq, dk, dv written once.
// In bf16 at PE-L14's training shape (B = 16, S = 577, W = 1024, 16 heads
// of 64) the 64-row tiles make 10 x 10 tile pairs per (b, head), 94 GFLOP,
// 0.095 ms at 989 TFLOP/s, far above the bytes (0.04 ms). Above that
// (scripts/heads_bwd_probe.py at that shape on the H100): with neither
// products nor arithmetic the dq and dk / dv kernels still took 0.0687
// and 0.0953 ms of 0.1015 and 0.1492 (each CTA streams its head's other
// side from L2, and its prologue and epilogue), and the prep pass, bound
// by its 114 MB (0.034 ms), 0.048. The split mode runs six products where
// bf16 runs one, at 989 / 6 = 164.8 TFLOP/s: at B = 2 the five gradient
// products are 0.0414 ms of that rate, 0.058 ms with s and dP recomputed.
#include "common.cuh"
#include "flash_tc.cuh"

namespace rv {
namespace hbwd {

using namespace tc;

constexpr int kRows = 64;             // rows of a resident tile: queries or keys (wgmma M)
constexpr int kProducerRegs = 40;
constexpr int kPrepThreads = 256;
constexpr int kSmemCta = 232448;      // dynamic shared memory a CTA may take
constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

struct TcParams {
    const float* cos_t;   // [S, hd] fp32 (RoPE only)
    const float* sin_t;
    const float* lse;     // [B * heads, S]: the forward's log-sum-exp, base 2
    const float* dsum;    // [B * heads, S]: D
    void* dq;             // [B, S, W]: bf16, or fp32 in the split mode
    void* dk;
    void* dv;
    int B, S, W, heads, kv;
    int hd;               // the head dim (the parts routes pad it to HD)
    int rope;
    float score_mul;      // the forward's: log2(e), times the scale in bf16 without RoPE
    float dq_mul;         // the scale
    float dk_mul;         // 1 with the scale in qr, else the scale
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

// The parts prep: q, k, v, dO, o [B * S, W] (T: fp32 for the split mode,
// bf16 for the padded route; any head dim hd % 4 == 0, any alignment) into
// the products' operands as bf16 parts, parts [4][PARTS][B * S][Wp] (qr,
// kr, v, dO; Wp = heads * HD, HD the head dim rounded up to 16): qr =
// rot(q) * scale and kr = rot(k) in fp32 with the forward's roundings
// (flash_tc.cuh::lane_tile_rope; without RoPE q * scale in the split mode,
// q as it is in bf16, whose forward scales the scores), then split into
// hi, mid and lo as ops/split.py::split3 splits (PARTS = 3) or rounded
// once to bf16 (PARTS = 1); the head's columns hd .. HD are zeros. And D =
// rowsum(dO * o) of each (row, head) in fp32. A CTA takes kPrepRows rows;
// a thread takes 8 adjacent columns of one head at a time (16-byte loads
// where the rows and the head allow, else element by element; one 16-byte
// store a part) and parks its columns' part of D in shared memory, which
// one thread a (row, head) adds in column order.
template <typename T, int PARTS>
__global__ void __launch_bounds__(kPrepThreads)
prep_parts_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dO, const T* __restrict__ o,
                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                  __nv_bfloat16* __restrict__ parts, float* __restrict__ dsum, int rows, int S,
                  int W, int heads, int HD, float scale, int rope, int vec) {
    extern __shared__ float part[];   // [kPrepRows][heads * HD / 8]
    const int hd = W / heads, qtr = hd / 4, upr = HD / 8, units = heads * upr;
    const int Wp = heads * HD;
    const size_t plane = (size_t)rows * Wp;   // elements of one part of one operand
    const int row0 = blockIdx.x * kPrepRows;
    const int n = min(kPrepRows, rows - row0) * units;
    const bool whole = vec && hd % 8 == 0;    // every live unit is 8 aligned columns
    const float q_mul = PARTS == 3 || rope ? scale : 1.f;
    for (int idx = threadIdx.x; idx < n; idx += kPrepThreads) {
        const int row = row0 + idx / units, u = idx % units;
        const int h = u / upr, c = (u % upr) * 8;   // c: the unit's first column in the head
        const size_t off = (size_t)row * W + h * hd + c;
        __nv_bfloat16* dst = parts + (size_t)row * Wp + h * HD + c;
        if (c >= hd) {   // the pad: zeros in every part of every operand
#pragma unroll
            for (int t = 0; t < 4 * PARTS; ++t)
                *reinterpret_cast<uint4*>(dst + t * plane) = make_uint4(0, 0, 0, 0);
            part[idx] = 0.f;
            continue;
        }
        const int n_live = min(8, hd - c);
        auto load = [&](const T* src, float (&x)[8]) {   // the unit's 8 values, zeros past hd
            if (whole) {
                load8(src, x);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) x[e] = e < n_live ? to_f<T>(src[e]) : 0.f;
            }
        };
        float x[8], y[8];
        load(o + off, x);
        load(dO + off, y);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(y[e], x[e], acc);
        part[idx] = acc;
        auto store = [&](int t, const float (&val)[8]) {   // operand t's parts
            __nv_bfloat16* p0 = dst + (size_t)(PARTS * t) * plane;
            if constexpr (PARTS == 3) {
                uint4 hi, mid, lo;
                split2(val[0], val[1], hi.x, mid.x, lo.x);
                split2(val[2], val[3], hi.y, mid.y, lo.y);
                split2(val[4], val[5], hi.z, mid.z, lo.z);
                split2(val[6], val[7], hi.w, mid.w, lo.w);
                *reinterpret_cast<uint4*>(p0) = hi;
                *reinterpret_cast<uint4*>(p0 + plane) = mid;
                *reinterpret_cast<uint4*>(p0 + 2 * plane) = lo;
            } else {
                *reinterpret_cast<uint4*>(p0) =
                    make_uint4(pack_bf16(val[0], val[1]), pack_bf16(val[2], val[3]),
                               pack_bf16(val[4], val[5]), pack_bf16(val[6], val[7]));
            }
        };
        store(3, y);
        load(v + off, x);
        store(2, x);
        const size_t trow = (size_t)(row % S) * hd + c;
#pragma unroll
        for (int t = 0; t < 2; ++t) {   // qr, then kr
            const T* src = t ? k : q;
            load(src + off, x);
            const float mul = t ? 1.f : q_mul;
            if (rope) {
                float xp[8], cs[8], sn[8];
                if (whole && qtr % 8 == 0) {   // the partner unit hd / 4 away, whole
                    load8(src + off + ((c / qtr) % 2 == 0 ? qtr : -qtr), xp);
                    load8(cos_t + trow, cs);
                    load8(sin_t + trow, sn);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const bool live = e < n_live, lower = ((c + e) / qtr) % 2 == 0;
                        xp[e] = live ? to_f<T>(src[off + e + (lower ? qtr : -qtr)]) : 0.f;
                        cs[e] = live ? __ldg(cos_t + trow + e) : 0.f;
                        sn[e] = live ? __ldg(sin_t + trow + e) : 0.f;
                    }
                }
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    x[e] = rot1(x[e], xp[e], cs[e], sn[e], ((c + e) / qtr) % 2 == 0);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], mul);
            store(t, x);
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kPrepRows * heads; idx += kPrepThreads) {
        const int row = row0 + idx / heads, h = idx % heads;
        if (row >= rows) break;
        const float* pr = part + (idx / heads) * units + h * upr;
        float acc = 0.f;
        for (int u = 0; u < upr; ++u) acc += pr[u];
        dsum[((size_t)(row / S) * heads + h) * S + row % S] = acc;
    }
}

// A CTA's shape and shared memory by head dim and mode (PARTS bf16 parts
// an operand value: 1 in bf16, 3 in the split mode). bf16: up to head dim
// 80, one consumer warpgroup a CTA and two CTAs an SM, so that one CTA's
// prologue (the resident tiles, the ring's first loads) and epilogue
// overlap the other's products; above, two consumer warpgroups (128 rows)
// in one CTA an SM share the streamed tiles (scripts/heads_bwd_probe.py on
// the H100: at PE-L14's head dim 64 the first took 0.3011 ms against
// 0.3333, at PE-G14's head dim 96 the second 0.2910 against 0.3888, where
// one warpgroup's dk / dv kernel spilled); a ring of four 64-row stages.
// The split mode keeps three parts of every tile: one consumer warpgroup,
// 32-row streamed tiles (the accumulators of a tile's scores and the
// three parts of P and dS in registers beside dk and dv), two CTAs an SM
// with a ring of two stages up to head dim 64 (99.9 KB a CTA at 64), one
// CTA with as many stages as fit (up to four) above. Where a CTA shares
// its SM or its consumers, the producer warpgroup keeps kProducerRegs
// registers a thread and hands the rest of the CTA's share of the register
// file to the consumers (setmaxnreg); a lone consumer warpgroup takes what
// the launch bound gives it. Shared memory: each consumer warpgroup's two
// resident tiles, the ring's two arrays of streamed tiles, the dk/dv
// kernel's lse and D a stage, the barriers; the epilogue's fp32 tiles
// reuse the ring.
template <int HD, int PARTS>
struct Cfg {
    static constexpr bool SPLIT = PARTS == 3;
    static constexpr int BK = SPLIT ? 32 : kRows;             // rows of a streamed tile
    static constexpr int NWG = !SPLIT && HD > 80 ? 2 : 1;     // consumer warpgroups a CTA
    static constexpr int CTAS = (SPLIT ? HD <= 64 : HD <= 80) ? 2 : 1;   // CTAs an SM
    static constexpr int THREADS = (NWG + 1) * kWgThreads;
    static constexpr int TILE = kRows * HD * 2;               // one part of a resident tile
    static constexpr int STILE = BK * HD * 2;                 // one part of a streamed tile
    static constexpr int SIDE = NWG * 2 * PARTS * TILE;       // resident: two tiles a warpgroup
    static constexpr int STAGE = 2 * PARTS * STILE;           // the ring: two tiles a stage
    static constexpr int STAT = 2 * BK * 4;                   // lse and D of a stage's rows
    static constexpr int STAGES = !SPLIT ? 4 : CTAS == 2 ? 2
        : cmin(4, (kSmemCta - 2048 - SIDE) / (STAGE + STAT + 16));
    static constexpr int RING = STAGES * STAGE;
    static constexpr int STATS = STAGES * STAT;
    static constexpr bool HANDOVER = NWG > 1 || CTAS > 1;     // setmaxnreg
    static constexpr int CONSUMER_REGS = cmin(
        256, ((65536 / CTAS / THREADS) / 8 * 8 * (NWG + 1) - kProducerRegs) / NWG / 8 * 8);
    static constexpr int LD = HD + 4;                         // the epilogue's fp32 row pitch
    static constexpr int BYTES = 1024 + SIDE + RING + STATS + 8 * (1 + 2 * STAGES);
    static_assert(STAGES >= 2 && BYTES <= kSmemCta, "a CTA's shared memory");
    static_assert(CTAS * (BYTES + 1024) <= 233472, "CTAS CTAs fit an SM");
    static_assert(NWG * kRows * LD * 4 <= RING, "the epilogue's tiles fit the ring");
    static_assert(BK % 32 == 0, "whole rows of lse and D a producer lane");
};

__device__ __forceinline__ uint8_t* smem_base() {
    extern __shared__ uint8_t smem_raw[];
    return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));
}

// one [rows][HD] tile of a map, every part (part p of batch b at z = p *
// B + b; bf16: z = b) and every atom of the head's columns, to dst (part p
// at dst + p * rows * HD * 2), onto `bar`
template <int HD, int PARTS, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col0, int row0, int b, int B) {
    using G = Geo<HD>;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
#pragma unroll
        for (int a = 0; a < G::NATOM; ++a)
            tma_load_3d(dst + p * ROWS * HD * 2 + a * ROWS * G::ATOM_BYTES, map, bar,
                        col0 + a * G::ATOM, row0, p * B + b);
}

// the two resident tiles of each consumer warpgroup (rows row0 + 64 g of
// amap and bmap) onto one barrier
template <int HD, int PARTS>
__device__ __forceinline__ void load_side(uint8_t* side, uint64_t* bar, const CUtensorMap* amap,
                                          const CUtensorMap* bmap, int col0, int row0, int b,
                                          int B) {
    using L = Cfg<HD, PARTS>;
    mbar_expect_tx(bar, L::SIDE);
#pragma unroll
    for (int g = 0; g < L::NWG; ++g) {
        uint8_t* s = side + 2 * g * PARTS * L::TILE;
        load_tile<HD, PARTS, kRows>(s, amap, bar, col0, row0 + g * kRows, b, B);
        load_tile<HD, PARTS, kRows>(s + PARTS * L::TILE, bmap, bar, col0, row0 + g * kRows, b, B);
    }
}

// a consumer's fp32 accumulator [64][HD] (rows warp * 16 + g and + 8,
// columns 8n + 2t and + 1) times `mul` into buf [64][HD + 4]
template <int HD>
__device__ __forceinline__ void park(float* buf, const float (&acc)[HD / 2], float mul, int warp,
                                     int g, int t) {
    constexpr int LD = HD + 4;
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

// 8 fp32 values from shared memory (16-byte aligned)
__device__ __forceinline__ void smem8(const float* p, float (&x)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// buf's rows (rows row0.. of one head; dst at the head's first column of
// row 0, row stride W) to bf16, 8 columns a thread and one 16-byte store,
// through the transpose of the rotation with ROPE: rot^T(y)[d] = cos[d]
// y[d] - sgn(d) sin[p(d)] y[p(d)] (ops/attention.py::_rot_t's order of
// operations); rows at or past S are not written. A thread
// loads two units (their values, partners and table rows: 16-byte loads
// where a quarter of the head is whole units) before it computes either,
// so that the table reads overlap.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float* buf, int row0,
                                           const TcParams& p, bool rope, int tid) {
    constexpr int LD = HD + 4, UPR = HD / 8, QTR = HD / 4;
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

// The parts routes' store: the first p.hd columns of buf's rows (rows
// row0.. of one head; dst at the head's first column of row 0, row stride
// W) as T (fp32 in the split mode; bf16 at a padded head dim), 4 columns a
// thread and one store (16 bytes of fp32, 8 of bf16), through rot^T with
// ROPE, element by element against the partner hd / 4 away (as store_rows
// computes it); rows at or past S are not written.
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <int HD, typename T>
__device__ __forceinline__ void store_rows_hd(T* dst, const float* buf, int row0,
                                              const TcParams& p, bool rope, int tid) {
    constexpr int LD = HD + 4;
    const int hd = p.hd, qtr = hd / 4, upr = hd / 4;   // 4-column units a row
#pragma unroll 2
    for (int u = tid; u < kRows * upr; u += kWgThreads) {
        const int r = u / upr, c = (u % upr) * 4, row = row0 + r;
        if (row >= p.S) break;
        const float4 y4 = *reinterpret_cast<const float4*>(buf + r * LD + c);
        float v[4] = {y4.x, y4.y, y4.z, y4.w};
        if (rope) {
            const size_t t = (size_t)row * hd;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = c + e;
                const bool lower = (d / qtr) % 2 == 0;
                const int pd = lower ? d + qtr : d - qtr;
                const float ypd = buf[r * LD + pd];
                v[e] = __fsub_rn(__fmul_rn(v[e], __ldg(p.cos_t + t + d)),
                                 __fmul_rn(lower ? -ypd : ypd, __ldg(p.sin_t + t + pd)));
            }
        }
        store4(dst + (size_t)row * p.W + c, v);
    }
}

// buf's rows to the output of the mode: bf16 at the head dim HD
// (store_rows), bf16 at a padded head dim or fp32 (store_rows_hd); dst
// at the head's column h * hd
template <int HD, int PARTS>
__device__ __forceinline__ void store_out(void* out, const float* buf, int b, int h, int row0,
                                          const TcParams& p, bool rope, int tid) {
    const size_t base = (size_t)b * p.S * p.W + (size_t)h * p.hd;
    if constexpr (PARTS == 3) {
        store_rows_hd<HD>(static_cast<float*>(out) + base, buf, row0, p, rope, tid);
    } else {
        auto* o = static_cast<__nv_bfloat16*>(out) + base;
        if (p.hd == HD)
            store_rows<HD>(o, buf, row0, p, rope, tid);
        else
            store_rows_hd<HD>(o, buf, row0, p, rope, tid);
    }
}

// dq: one CTA per (64 query rows a consumer warpgroup, head, b); maps over
// qr and dO (64-row boxes) and kr and v (BK-row boxes)
template <int HD, int PARTS>
__global__ void __launch_bounds__(Cfg<HD, PARTS>::THREADS, Cfg<HD, PARTS>::CTAS)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
          const TcParams p) {
    using L = Cfg<HD, PARTS>;
    constexpr int kStages = L::STAGES, kNwg = L::NWG, BK = L::BK;
    uint8_t* side = smem_base();                        // [kNwg][qr, dO][PARTS]
    uint8_t* ks = side + L::SIDE;                       // [kStages][PARTS] kr tiles
    uint8_t* vs = ks + kStages * PARTS * L::STILE;      // [kStages][PARTS] v tiles
    uint64_t* bar = reinterpret_cast<uint64_t*>(vs + kStages * PARTS * L::STILE + L::STATS);
    uint64_t* full = bar + 1;
    uint64_t* empty = full + kStages;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * kNwg * kRows, col0 = h * HD;
    const int n_tiles = ceil_div(p.kv, BK);
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
        if constexpr (L::HANDOVER) setmaxnreg_dec<kProducerRegs>();
        if (tid == 0) {
            load_side<HD, PARTS>(side, bar, &qmap, &omap, col0, q0, b, p.B);
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % kStages;
                mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                mbar_expect_tx(&full[s], L::STAGE);
                load_tile<HD, PARTS, BK>(ks + s * PARTS * L::STILE, &kmap, &full[s], col0,
                                         j * BK, b, p.B);
                load_tile<HD, PARTS, BK>(vs + s * PARTS * L::STILE, &vmap, &full[s], col0,
                                         j * BK, b, p.B);
            }
        }
        return;
    }

    // ---- consumer warpgroup: query rows q0 + 64 wg .. + 64 ----
    if constexpr (L::HANDOVER) setmaxnreg_inc<L::CONSUMER_REGS>();
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
    float sc[BK / 2], dp[BK / 2];
    uint32_t pa[PARTS][BK / 16][4];
    const uint32_t q_addr = smem_addr(side + 2 * wg * PARTS * L::TILE);
    const uint32_t o_addr = q_addr + PARTS * L::TILE;
    auto k_addr = [&](int j) { return smem_addr(ks + (j % kStages) * PARTS * L::STILE); };
    auto v_addr = [&](int j) { return smem_addr(vs + (j % kStages) * PARTS * L::STILE); };
    auto wait_tile = [&](int j) { mbar_wait(&full[j % kStages], (j / kStages) & 1); };
    auto release = [&](int j) {   // this warp is done with tile j's stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };
    // tile j's P = 2^(s * mul - lse), in place in sc; keys at or past
    // kv_valid score -inf (P = 0)
    auto probs = [&](int j) {
        const int kb = j * BK;
        if (kb + BK > p.kv) {
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (kb + 8 * n + 2 * t + e >= p.kv)
                        sc[4 * n + e] = sc[4 * n + 2 + e] = -CUDART_INF_F;
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], mul, -lse0));
                sc[4 * n + 2 + e] = ex2(fmaf(sc[4 * n + 2 + e], mul, -lse1));
            }
    };
    // then dS = P (dP - D), in place in sc
    auto grad_scores = [&]() {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
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
    qk_tile<HD, BK, PARTS>(sc, q_addr, k_addr(0));
    qk_tile<HD, BK, PARTS>(dp, o_addr, v_addr(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);
    probs(0);
    grad_scores();
    pack_p<BK, PARTS>(sc, pa);
    for (int j = 0; j + 1 < n_tiles; ++j) {
        wait_tile(j + 1);
        wgmma_fence();
        qk_tile<HD, BK, PARTS>(sc, q_addr, k_addr(j + 1));
        wgmma_commit();
        qk_tile<HD, BK, PARTS>(dp, o_addr, v_addr(j + 1));
        wgmma_commit();
        pv_tile<HD, BK, PARTS>(dq, pa, k_addr(j));
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
        pack_p<BK, PARTS>(sc, pa);
    }
    wgmma_fence();
    pv_tile<HD, BK, PARTS>(dq, pa, k_addr(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dq);
    release(n_tiles - 1);

    // epilogue: every consumer is done with the ring, which takes the
    // fp32 tiles; dq = rot^T(scale dS kr)
    named_bar_sync(1, kNwg * kWgThreads);
    float* buf = reinterpret_cast<float*>(ks) + wg * kRows * (HD + 4);
    park<HD>(buf, dq, p.dq_mul, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_out<HD, PARTS>(p.dq, buf, b, h, q0 + wg * kRows, p, p.rope != 0, tid);
}

// dk, dv: one CTA per (64 keys a consumer warpgroup, head, b); maps over
// kr and v (64-row boxes) and qr and dO (BK-row boxes)
template <int HD, int PARTS>
__global__ void __launch_bounds__(Cfg<HD, PARTS>::THREADS, Cfg<HD, PARTS>::CTAS)
dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
           const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
           const TcParams p) {
    using L = Cfg<HD, PARTS>;
    constexpr int kStages = L::STAGES, kNwg = L::NWG, BK = L::BK;
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int h = blockIdx.y, b = blockIdx.z;
    const int k0 = blockIdx.x * kNwg * kRows, col0 = h * HD;
    if (k0 >= p.kv) {
        // every key of this CTA is at or past kv_valid: dk = dv = 0
        const size_t ob = (size_t)b * p.S * p.W + (size_t)h * p.hd;
        const int upr = p.hd / 4;   // 4-column units a row: 16 bytes of fp32, 8 of bf16
        constexpr int SIZE = PARTS == 3 ? 4 : 2;
        for (int u = threadIdx.x; u < kNwg * kRows * upr; u += L::THREADS) {
            const int row = k0 + u / upr;
            if (row >= p.S) continue;
            const size_t off = (ob + (size_t)row * p.W + (u % upr) * 4) * SIZE;
#pragma unroll
            for (int t = 0; t < 2; ++t) {   // dk, then dv
                uint8_t* d = static_cast<uint8_t*>(t ? p.dv : p.dk) + off;
                if constexpr (SIZE == 4)
                    *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
                else
                    *reinterpret_cast<uint2*>(d) = make_uint2(0, 0);
            }
        }
        return;
    }
    uint8_t* side = smem_base();                        // [kNwg][kr, v][PARTS]
    uint8_t* qs = side + L::SIDE;                       // [kStages][PARTS] qr tiles
    uint8_t* os = qs + kStages * PARTS * L::STILE;      // [kStages][PARTS] dO tiles
    // [kStages][lse, D][BK]
    float* stats = reinterpret_cast<float*>(os + kStages * PARTS * L::STILE);
    uint64_t* bar = reinterpret_cast<uint64_t*>(os + kStages * PARTS * L::STILE + L::STATS);
    uint64_t* full = bar + 1;       // the TMA bytes and the 32 lanes' lse and D
    uint64_t* empty = full + kStages;
    const int n_tiles = ceil_div(p.S, BK);
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
        if constexpr (L::HANDOVER) setmaxnreg_dec<kProducerRegs>();
        if (tid >= 32) return;
        const int lane = tid;
        constexpr int RPL = BK / 32;   // rows a lane
        if (lane == 0) load_side<HD, PARTS>(side, bar, &kmap, &vmap, col0, k0, b, p.B);
        // this lane's rows of a tile's lse and D, loaded a tile ahead so
        // that their latency passes while the producer waits for a stage
        float nl[RPL], nd[RPL];
        auto fetch = [&](int i) {
#pragma unroll
            for (int r = 0; r < RPL; ++r) {
                const int row = i * BK + lane + 32 * r;
                nl[r] = row < p.S ? p.lse[srow + row] : CUDART_INF_F;
                nd[r] = row < p.S ? p.dsum[srow + row] : 0.f;
            }
        };
        fetch(0);
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % kStages;
            mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
            float* st = stats + s * 2 * BK;
#pragma unroll
            for (int r = 0; r < RPL; ++r) {
                st[lane + 32 * r] = nl[r];
                st[BK + lane + 32 * r] = nd[r];
            }
            if (i + 1 < n_tiles) fetch(i + 1);
            if (lane == 0) {
                mbar_expect_tx(&full[s], L::STAGE);
                load_tile<HD, PARTS, BK>(qs + s * PARTS * L::STILE, &qmap, &full[s], col0,
                                         i * BK, b, p.B);
                load_tile<HD, PARTS, BK>(os + s * PARTS * L::STILE, &omap, &full[s], col0,
                                         i * BK, b, p.B);
            } else {
                mbar_arrive(&full[s]);
            }
        }
        return;
    }

    // ---- consumer warpgroup: keys k0 + 64 wg .. + 64 ----
    if constexpr (L::HANDOVER) setmaxnreg_inc<L::CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int r0 = k0 + wg * kRows + warp * 16 + g;   // this thread's keys r0 and r0 + 8
    const bool live0 = r0 < p.kv, live1 = r0 + 8 < p.kv;
    const float mul = p.score_mul;
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    float st_[BK / 2], dpt[BK / 2];   // S^T, then P^T; dP^T, then dS^T
    uint32_t pf[PARTS][BK / 16][4], df[PARTS][BK / 16][4];
    const uint32_t k_addr = smem_addr(side + 2 * wg * PARTS * L::TILE);
    const uint32_t v_addr = k_addr + PARTS * L::TILE;
    auto q_addr = [&](int i) { return smem_addr(qs + (i % kStages) * PARTS * L::STILE); };
    auto o_addr = [&](int i) { return smem_addr(os + (i % kStages) * PARTS * L::STILE); };
    auto wait_tile = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
    auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[i % kStages]);
    };
    // query tile i's P^T, in place in st_: columns are queries, with their
    // lse from the stage; keys at or past kv_valid get P = 0
    auto probs = [&](int i) {
        const float* st = stats + (i % kStages) * 2 * BK;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
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
        const float* st = stats + (i % kStages) * 2 * BK + BK;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
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
    qk_tile<HD, BK, PARTS>(st_, k_addr, q_addr(0));
    qk_tile<HD, BK, PARTS>(dpt, v_addr, o_addr(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(st_);
    fence_operand(dpt);
    probs(0);
    grad_scores(0);
    pack_p<BK, PARTS>(st_, pf);
    pack_p<BK, PARTS>(dpt, df);
    for (int i = 0; i + 1 < n_tiles; ++i) {
        wait_tile(i + 1);
        wgmma_fence();
        qk_tile<HD, BK, PARTS>(st_, k_addr, q_addr(i + 1));
        wgmma_commit();
        qk_tile<HD, BK, PARTS>(dpt, v_addr, o_addr(i + 1));
        wgmma_commit();
        pv_tile<HD, BK, PARTS>(dv, pf, o_addr(i));
        pv_tile<HD, BK, PARTS>(dk, df, q_addr(i));
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
        pack_p<BK, PARTS>(st_, pf);
        pack_p<BK, PARTS>(dpt, df);
    }
    wgmma_fence();
    pv_tile<HD, BK, PARTS>(dv, pf, o_addr(n_tiles - 1));
    pv_tile<HD, BK, PARTS>(dk, df, q_addr(n_tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(dv);
    fence_operand(dk);
    release(n_tiles - 1);

    // epilogue: dv as it is, then dk = rot^T(dS^T qr) (times dk_mul), each
    // through the ring's shared memory
    named_bar_sync(1, kNwg * kWgThreads);
    float* buf = reinterpret_cast<float*>(qs) + wg * kRows * (HD + 4);
    const int row0 = k0 + wg * kRows;
    park<HD>(buf, dv, 1.f, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_out<HD, PARTS>(p.dv, buf, b, h, row0, p, false, tid);
    named_bar_sync(2 + wg, kWgThreads);
    park<HD>(buf, dk, p.dk_mul, warp, g, t);
    named_bar_sync(2 + wg, kWgThreads);
    store_out<HD, PARTS>(p.dk, buf, b, h, row0, p, p.rope != 0, tid);
}

// the two product kernels over q, k, v, dO [Z][S][pitch] (bf16: the
// inputs, Z = B; the split mode: the parts, Z = 3B), each kernel's
// resident side in 64-row boxes and its streamed side in BK-row boxes
template <int HD, int PARTS>
int launch_bwd(const void* qs, const void* ks, const void* v, const void* dO, const TcParams& p,
               int pitch, cudaStream_t stream) {
    using L = Cfg<HD, PARTS>;
    const int z = PARTS * p.B;
    // each operand's map in 64-row boxes (r) and BK-row boxes (b)
    CUtensorMap qr, kr, vr, orr, qb, kb, vb, ob;
    auto map = [&](CUtensorMap* m, const void* ptr, int rows) {
        return make_map<HD>(m, ptr, pitch, p.S, z, rows);
    };
    if (!map(&qr, qs, kRows) || !map(&kr, ks, kRows) || !map(&vr, v, kRows) ||
        !map(&orr, dO, kRows) || !map(&qb, qs, L::BK) || !map(&kb, ks, L::BK) ||
        !map(&vb, v, L::BK) || !map(&ob, dO, L::BK))
        return kMapError;
    auto* k1 = dq_kernel<HD, PARTS>;
    auto* k2 = dkv_kernel<HD, PARTS>;
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
    const dim3 grid(ceil_div(p.S, L::NWG * kRows), p.heads, p.B);
    k1<<<grid, L::THREADS, L::BYTES, stream>>>(qr, kb, vb, orr, p);
    k2<<<grid, L::THREADS, L::BYTES, stream>>>(qb, kr, vr, ob, p);
    return (int)cudaGetLastError();
}

template <int PARTS>
int dispatch(const void* qs, const void* ks, const void* v, const void* dO, const TcParams& p,
             int HD, int pitch, cudaStream_t stream) {
#define RV_BWD_CASE(H) \
    case H: return launch_bwd<H, PARTS>(qs, ks, v, dO, p, pitch, stream);
    switch (HD) {
        RV_BWD_CASE(16) RV_BWD_CASE(32) RV_BWD_CASE(48) RV_BWD_CASE(64)
        RV_BWD_CASE(80) RV_BWD_CASE(96) RV_BWD_CASE(112) RV_BWD_CASE(128)
        default: return kUnsupported;
    }
#undef RV_BWD_CASE
}

static TcParams make_params(const void* lse, const void* dsum, const void* cos_t, const void* sin_t,
                     void* dq, void* dk, void* dv, int B, int S, int W, int heads, int kv,
                     int use_rope) {
    TcParams p;
    p.cos_t = static_cast<const float*>(cos_t);
    p.sin_t = static_cast<const float*>(sin_t);
    p.lse = static_cast<const float*>(lse);
    p.dsum = static_cast<const float*>(dsum);
    p.dq = dq;
    p.dk = dk;
    p.dv = dv;
    p.B = B;
    p.S = S;
    p.W = W;
    p.heads = heads;
    p.kv = kv;
    p.hd = W / heads;
    p.rope = use_rope;
    return p;
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
    TcParams p = make_params(lse, dsum, cos_t, sin_t, dq, dk, dv, B, S, W, heads, kv_valid,
                             use_rope);
    p.score_mul = use_rope ? kLog2e : kLog2e * scale;   // as flash_tc.cuh's launch
    p.dq_mul = scale;
    p.dk_mul = use_rope ? 1.f : scale;
    return dispatch<1>(use_rope ? qr : q, use_rope ? kr : k, v, dO, p, hd, W, st);
}

// q, k, v, o (the forward's output), dO [B, S, W] of one dtype (W = heads
// * hd, contiguous, any alignment), lse [B * heads, S] fp32 (the
// forward's: rv_flash_heads_split, rv_flash_heads_tc), cos_t, sin_t [S,
// hd] fp32 (RoPE only, 16-byte aligned); scratch parts [4][PARTS][B][S]
// [heads * HD] bf16 (16-byte aligned; HD: hd rounded up to 16; PARTS 3 in
// fp32, the split mode, 1 in bf16) and dsum [B * heads, S] fp32; dq, dk,
// dv [B, S, W] of the dtype out, 16-byte aligned. hd % 4 == 0, hd <= 128,
// 1 <= kv_valid <= S. parts_pitch: the caller's last dimension of the
// scratch, which must be heads * HD (else unsupported, nothing written).
extern "C" int rv_flash_heads_bwd_parts(const void* q, const void* k, const void* v,
                                        const void* o, const void* dO, const void* lse,
                                        const void* cos_t, const void* sin_t, void* parts,
                                        void* dsum, void* dq, void* dk, void* dv, int B, int S,
                                        int W, int heads, int kv_valid, float scale,
                                        int use_rope, int dtype, int parts_pitch,
                                        void* stream) {
    using namespace rv::hbwd;
    if (B < 1 || S < 1 || heads < 1 || W % heads) return rv::kUnsupported;
    const int hd = W / heads, HD = (hd + 15) / 16 * 16;
    if (hd % 4 || hd > 128 || kv_valid < 1 || kv_valid > S) return rv::kUnsupported;
    if (parts_pitch != heads * HD) return rv::kUnsupported;
    if (dtype != rv::kFloat32 && dtype != rv::kBFloat16) return rv::kUnsupported;
    if (use_rope && (cos_t == nullptr || sin_t == nullptr)) return rv::kUnsupported;
    using rv::tc::aligned16;
    if (!(aligned16(parts) && aligned16(dq) && aligned16(dk) && aligned16(dv) &&
          (!use_rope || (aligned16(cos_t) && aligned16(sin_t)))))
        return rv::kUnsupported;
    const auto st = static_cast<cudaStream_t>(stream);
    const bool split = dtype == rv::kFloat32;
    const int Wp = heads * HD;
    const int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                    aligned16(dO);
    const dim3 grid(rv::ceil_div(B * S, kPrepRows));
    const int smem = kPrepRows * (Wp / 8) * 4;
    auto* pp = static_cast<__nv_bfloat16*>(parts);
    const auto* cs = static_cast<const float*>(cos_t);
    const auto* sn = static_cast<const float*>(sin_t);
    auto* ds = static_cast<float*>(dsum);
    if (split) {
        using f = float;
        prep_parts_kernel<f, 3><<<grid, kPrepThreads, smem, st>>>(
            static_cast<const f*>(q), static_cast<const f*>(k), static_cast<const f*>(v),
            static_cast<const f*>(dO), static_cast<const f*>(o), cs, sn, pp, ds, B * S, S, W,
            heads, HD, scale, use_rope, vec);
    } else {
        using bf = __nv_bfloat16;
        prep_parts_kernel<bf, 1><<<grid, kPrepThreads, smem, st>>>(
            static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
            static_cast<const bf*>(dO), static_cast<const bf*>(o), cs, sn, pp, ds, B * S, S, W,
            heads, HD, scale, use_rope, vec);
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    TcParams p = make_params(lse, dsum, cos_t, sin_t, dq, dk, dv, B, S, W, heads, kv_valid,
                             use_rope);
    // the forward's scale: folded into qr in the split mode and with RoPE,
    // on the scores otherwise (rv_flash_heads_tc's launch)
    const bool folded = split || use_rope;
    p.score_mul = folded ? kLog2e : kLog2e * scale;
    p.dq_mul = scale;
    p.dk_mul = folded ? 1.f : scale;
    const int parts_n = split ? 3 : 1;
    const size_t plane = (size_t)parts_n * B * S * Wp;   // one operand's parts
    if (split) return dispatch<3>(pp, pp + plane, pp + 2 * plane, pp + 3 * plane, p, HD, Wp, st);
    return dispatch<1>(pp, pp + plane, pp + 2 * plane, pp + 3 * plane, p, HD, Wp, st);
}
