// One flash-attention core on Hopper's tensor cores, shared by the
// [B, H, S, D] kernel (K7, flash_attn.cu), the heads-in-lanes kernel with
// 2D RoPE (K3, flash_heads.cu), the [B, H, S, D] kernel with SAM's
// decomposed relative-position bias (K6, flash_attn.cu), and all three
// with fp32 operands (the split mode, flash_attn_split.cu and
// flash_heads_split.cu).
//
// Contract (reverso_tpu/ops/attention.py:48-75, :131-200 and :337-403):
// non-causal attention with fp32 accumulation; keys at or past kv_valid
// score -inf. Without RoPE the score is f32(q.k) * scale; with RoPE q is
// rotated in fp32 with the scale folded in and rounded to bf16, k is
// rotated and rounded to bf16, and the score is f32(q_rot.k_rot). With the
// rel-pos bias (the TPU kernel's one bf16 MXU pass, `dot_prec = DEFAULT if
// rel_grid`) the score is f32(q.k) * scale + (bh[q, k / G] + bw[q, k % G])
// with the bias in fp32, added inside the tile (the [Sq, Skv] bias never
// exists); ops/attention.py folds the scale into q as the TPU kernel does
// (bf16(q * scale)) and passes scale 1. p = exp(s - m) in fp32, the row sum
// l adds the fp32 p, p rounds to bf16 for the PV product, and the output
// is acc / l rounded to bf16, or stored as fp32 (the bias mode's fp32
// callers). The softmax is online: p is rounded against the running max,
// and the fp32 accumulator is rescaled when the max moves (the one point
// where the kernel knowingly differs from the one-pass reference;
// tests/test_torch_flash_tc.py measures it).
//
// The split mode is the TPU kernel's fp32 contract, Precision.HIGHEST
// (reverso_tpu/ops/topk.py:42-48, used at reverso_tpu/ops/attention.py:
// 62-74): each fp32 operand x becomes three bf16 parts, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid) (hi + mid + lo == x exactly where
// the parts are normal), q after the scale is folded in (fp32 q * scale),
// and each product is six bf16 products, lo.hi, hi.lo, mid.mid, mid.hi,
// hi.mid and hi.hi, the small terms first, in one fp32 accumulator (the
// dropped mid.lo, lo.mid and lo.lo are below 2^-23 of the product). p
// stays fp32 (the plain version rounds it to the input dtype, a no-op in
// fp32) and is split the same way in registers for the PV product; the
// output is acc / l in fp32 (ops/attention.py::attention_split_ref).
//
// Design:
//   * a CTA holds NWG consumer warpgroups of 64 query rows each and one
//     producer warpgroup; the consumers wait on a ring of STAGES K/V
//     stages' "full" barriers and release a stage through its "empty"
//     barrier;
//   * operands reach the ring one of three ways (OPS): bf16 tiles through
//     TMA (kOpsTma: one producer thread brings the q tile and the K/V
//     tiles, cp.async.bulk.tensor with 3-D tensor maps and mbarrier
//     completion); bf16 rows TMA cannot take (a row stride that is not a
//     multiple of 16 bytes, an unaligned base) copied by the producer
//     warpgroup's 128 lanes into the same swizzled tiles (kOpsCopy); fp32
//     rows read by those lanes and split into three bf16 tiles (kOpsSplit).
//     In the lane modes each consumer warpgroup loads (and splits) its own
//     q rows once in the prologue, and the four producer warps load (and
//     split) each K and V tile into its stage, fence the async proxy and
//     arrive on the stage's full barrier while the consumers work on
//     earlier stages; keys past kv_valid are never read (zeros). Heads in
//     lanes read one head's rows straight out of [B, S, W] (row stride W,
//     the head's first column h * d);
//   * the maps are 3-D ([BH, S, D] for K6/K7, [B, S, W] for K3 with a box
//     of one head's columns), so a tile past a head's last row is
//     zero-filled by the hardware and never reads the next head; the ragged
//     last query and key tiles need no padded copies in device memory;
//   * a head dim D that is not a multiple of 16 is zero-padded to the next
//     one (HD) in shared memory: the TMA box reads past the map's inner
//     extent D, which the hardware fills with zeros (D % 8 == 0 for a
//     16-byte row stride), and the lanes write zeros; the epilogue stores
//     the first D columns;
//   * S = Q K^T is wgmma m64nBKk16 with Q and K in shared memory, both
//     K-major (K is stored [BK][D]); O += P V is wgmma m64nDk16 with P
//     taken from the S accumulator's registers, converted to bf16 in place
//     (the accumulator layout of m64nN is the register-A layout of k16; in
//     the split mode each of p's three parts is such a fragment), and V
//     the B operand in its MN-major (transposed) mode;
//   * tiles are stored in swizzle atoms of 64, 32 or 16 columns (128-, 64-
//     or 32-byte swizzle, the widest that divides D): D = 96 is three
//     32-column atoms, D = 16 one 16-column atom;
//   * with RoPE through TMA, each consumer warpgroup rotates its q rows
//     once in the prologue, and producer warps 1-3 take the landed K tiles
//     in turn and rotate each in place (fp32 math, bf16 result) before
//     they arrive on the stage's "rotated" barrier, while the consumers
//     work on earlier tiles; warp 0 only starts TMA loads, so no load
//     waits on a rotation. In the lane modes the lanes rotate each element
//     as they load it, against its partner d / 4 away and the tables' row,
//     in fp32, then round it once to bf16 (copy) or split it (split: q
//     rotated, times the scale, then split, as the TPU kernel rotates in
//     fp32 before its HIGHEST products);
//   * with the bias at G == BK (SAM's G = 64), a BK-key tile is one row of the key
//     lattice, so the bw terms of a thread's 16 columns are the same in
//     every tile: they sit in shared memory (which keeps the kernel within
//     the 128 registers a thread that two CTAs an SM allow) and start each
//     S accumulator, so the product lands on them; bh is one value per row and tile, loaded
//     before the tile's product, that joins the running max and the
//     exponent's offset. The softmax then runs as without the bias. Other
//     G add each key's bh and bw after the product (kBiasAny);
//   * given an lse pointer (K3's forward under autograd, bf16 or the split
//     mode), the epilogue also writes each query row's log-sum-exp in the
//     core's base-2 units, m + log2(l), which flash_heads_bwd_tc.cu reads;
//   * in the split mode each tile's PV product lands in a fresh
//     accumulator that the CUDA cores add to the running output (fp32,
//     round to nearest): the tensor cores' fp32 accumulation does not
//     round to nearest, and summed over every tile in one accumulator its
//     error grew with the keys (on the H100: 5.0e-6 at S = 1297 and 1.1e-5
//     at S = 4096 against the fp32 plain version, 1.1e-6 and 1.6e-6 with
//     the per-tile sums; six products against nine changed neither). The
//     producer warpgroup keeps 120 registers a thread and hands the rest
//     to the consumers (setmaxnreg), which hold o, that tile product, the
//     scores and p's three parts.
//
// What bounds it on the H100 at the main paths' shapes: bytes and
// products alike for K3 (B = 8, S = 577, hd 64: 0.0114 ms of bytes, 0.0110
// ms of products at 3.35 TB/s and 989 TFLOP/s), products for K7 (B = 8,
// S = 1297: 0.056 ms) and K6 (B = 4, H = 12, S = 4096: 206 GFLOP, 0.208
// ms); what the card spends above that is per-tile latency (the softmax
// between the products, which the loop overlaps with the PV product) and,
// with RoPE, the rotation pass and its fp32 table reads (8 bytes per bf16
// element of K, per CTA). The split mode runs six products where the bf16
// core runs one, so products bound it at 989 / 6 = 164.8 TFLOP/s (K7 in
// fp32 at B = 2, S = 1297: 0.0836 ms; K6 at SAM's shape: 1.26 ms), far
// above its bytes; above that it pays the split pass of the producer lanes
// over every K and V element in each CTA that reads them (K and V read
// from L2 in fp32, three bf16 parts written to shared memory), which the
// three-stage ring overlaps with the consumers' products, and p's split
// between the two products. On the H100 (PERF.md §6) the products
// alone take 1.5x / 1.2x that bound at the K7 / K6 shapes, the split pass
// adds 17% / 24% of the time and p's split 7%; the softmax hides behind
// the PV product. Two consumer warpgroups (128 query rows) share each
// split K/V tile at D <= 64, which halves the split pass per query row.
#pragma once

#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace rv {
namespace tc {

constexpr int kQRows = 64;        // query rows of a consumer warpgroup (wgmma M)
constexpr int kRotWarps = 3;      // producer warps 1-3: the RoPE pass on K tiles

// D (+)= A B, A (bf16 pairs, the k16 register fragment) in registers, B
// MN-major (transposed) in shared memory; scale_d = 0 overwrites D
template <int N> struct WgmmaRS;

template <> struct WgmmaRS<16> {
    static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<32> {
    static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<48> {
    static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
            "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<64> {
    static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<80> {
    static __device__ __forceinline__ void run(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
            "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<96> {
    static __device__ __forceinline__ void run(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
            "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<112> {
    static __device__ __forceinline__ void run(float (&d)[56], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
            "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct WgmmaRS<128> {
    static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d = 1) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};


// ---- tile geometry -----------------------------------------------------------

// A tile of R rows x HD bf16 columns is stored as HD / ATOM atoms of
// [R][ATOM], each swizzled as TMA writes it (the widest of 128-, 64- and
// 32-byte swizzle whose atom divides the head dim).
template <int HD>
struct Geo {
    static constexpr int ATOM = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
    static constexpr int ATOM_BYTES = ATOM * 2;
    static constexpr int NATOM = HD / ATOM;
    static constexpr uint64_t LAYOUT = ATOM_BYTES == 128 ? 1 : ATOM_BYTES == 64 ? 2 : 3;
};

// the byte a swizzled atom keeps (row, byte-in-row) at: 16-byte chunks XOR
// the row bits (Swizzle<3|2|1, 4, 3>), with atoms 1024-byte aligned
template <int ATOM_BYTES>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
    constexpr uint32_t mask = ATOM_BYTES / 16 - 1;
    return off ^ ((off >> 3) & (mask << 4));
}

template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
    using G = Geo<HD>;
    return (uint32_t)((c / G::ATOM) * rows * G::ATOM_BYTES)
         + swizzle<G::ATOM_BYTES>((uint32_t)(r * G::ATOM_BYTES + (c % G::ATOM) * 2));
}

// ---- operand modes -------------------------------------------------------------

// how operands reach shared memory: bf16 tiles through TMA; bf16 rows copied
// by the producer warpgroup's lanes (row strides TMA cannot take); fp32
// rows read by those lanes and split into three bf16 tiles (the split mode)
constexpr int kOpsTma = 0, kOpsCopy = 1, kOpsSplit = 2;

template <int OPS>
struct Ops {
    static constexpr int PARTS = OPS == kOpsSplit ? 3 : 1;   // bf16 tiles per operand tile
    static constexpr bool LANE_LOADS = OPS != kOpsTma;       // the producer lanes load the tiles
    using T = typename std::conditional<OPS == kOpsSplit, float, __nv_bfloat16>::type;
};

// One 8-column unit (8 values of a row) into its place in PARTS swizzled
// bf16 tiles (part p at out + p * PART): times `mul` and split into hi,
// mid and lo (PARTS = 3), or rounded once to bf16 (PARTS = 1; times `mul`
// where SCALE says so)
template <int PARTS, bool SCALE, uint32_t PART>
__device__ __forceinline__ void store_unit(uint8_t* out, float (&x)[8], float mul) {
    if constexpr (PARTS == 3) {
        uint4 hi, mid, lo;
        split2(__fmul_rn(x[0], mul), __fmul_rn(x[1], mul), hi.x, mid.x, lo.x);
        split2(__fmul_rn(x[2], mul), __fmul_rn(x[3], mul), hi.y, mid.y, lo.y);
        split2(__fmul_rn(x[4], mul), __fmul_rn(x[5], mul), hi.z, mid.z, lo.z);
        split2(__fmul_rn(x[6], mul), __fmul_rn(x[7], mul), hi.w, mid.w, lo.w);
        *reinterpret_cast<uint4*>(out) = hi;
        *reinterpret_cast<uint4*>(out + PART) = mid;
        *reinterpret_cast<uint4*>(out + 2 * PART) = lo;
    } else {
        if constexpr (SCALE) {
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], mul);
        }
        *reinterpret_cast<uint4*>(out) =
            make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                       pack_bf16(x[6], x[7]));
    }
}

// The lane modes' loads: rows [0, n_rows) of NTILES tiles of ROWS x HD
// (tile i's row r at src_i + r * ld, columns [0, d)) into PARTS swizzled
// bf16 tiles each (part p at dst_i + p * ROWS * HD * 2), zeros past the
// rows and columns: bf16 rows as they are (PARTS = 1), fp32 rows times
// `mul` split into hi, mid and lo (PARTS = 3). NT threads take 8-column
// units in turn; each loads a batch of up to 8 units (16-byte loads where
// `vec` says the rows are 16-byte aligned) before it stores any, so the
// loads overlap.
template <typename T, int PARTS, int HD, int ROWS, int NT, int NTILES>
__device__ __forceinline__ void lane_tiles(uint8_t* dst0, uint8_t* dst1, const T* src0,
                                           const T* src1, int ld, int n_rows, int d, float mul,
                                           bool vec, int tid) {
    constexpr int CPR = HD / 8;                 // units a row
    constexpr int UNITS = ROWS * CPR;           // units a tile
    constexpr int ITERS = (NTILES * UNITS + NT - 1) / NT;
    constexpr int BATCH = ITERS < 8 ? ITERS : 8;
    constexpr uint32_t PART = ROWS * HD * 2;
#pragma unroll 1
    for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
        float x[BATCH][8];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int u = tid + (it0 + b) * NT;
            const int w = u % UNITS, r = w / CPR, c = (w % CPR) * 8;
            const bool live = u < NTILES * UNITS && r < n_rows;
            const T* row = (u < UNITS ? src0 : src1) + (size_t)r * ld;
            if (live && vec && c + 8 <= d) {
                load8(row + c, x[b]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) x[b][e] = live && c + e < d ? to_f<T>(row[c + e]) : 0.f;
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int u = tid + (it0 + b) * NT;
            if (u >= NTILES * UNITS) continue;
            const int w = u % UNITS, r = w / CPR, c = (w % CPR) * 8;
            store_unit<PARTS, false, PART>((u < UNITS ? dst0 : dst1) + tile_offset<HD>(ROWS, r, c),
                                           x[b], mul);
        }
    }
}

// The lane modes' loads with RoPE: rows [0, n_rows) of one tile (q, or K)
// rotated as they load by the 2D RoPE tables' rows trow0.. ([S, d] fp32,
// 16-byte aligned): the quarter-split axial rotate [a, b | c, e] -> x *
// cos + [-b, a | -e, c] * sin in fp32, each product and the sum rounded
// on its own as the plain version computes them, then times `mul` and
// split (PARTS = 3) or rounded once to bf16. The partner of column col is
// col + d / 4 in quarters 0 and 2, col - d / 4 in 1 and 3. Where the head
// fills HD, its quarters are whole 8-column units and the rows are
// 16-byte aligned, a unit's partner is the unit d / 4 away: each thread
// loads two units with their partners and table values (16-byte loads)
// before it computes either. Elsewhere (padded head dims, unaligned rows)
// each element reads its own partner and table values.
template <typename T, int PARTS, int HD, int ROWS, int NT>
__device__ __forceinline__ void lane_tile_rope(uint8_t* dst, const T* src, int ld, int n_rows,
                                               int d, float mul, bool vec, int tid,
                                               const float* __restrict__ cos_t,
                                               const float* __restrict__ sin_t, int trow0) {
    constexpr int CPR = HD / 8;                 // units a row
    constexpr int UNITS = ROWS * CPR;           // units a tile
    constexpr int ITERS = (UNITS + NT - 1) / NT;
    constexpr int BATCH = ITERS < 2 ? ITERS : 2;
    constexpr int QH = HD / 4;
    constexpr uint32_t PART = ROWS * HD * 2;
    if (QH % 8 == 0 && d == HD && vec) {
#pragma unroll 1
        for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
            float x[BATCH][8], pr[BATCH][8], cs[BATCH][8], sn[BATCH][8];
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int u = tid + (it0 + b) * NT;
                const int r = u / CPR, c = (u % CPR) * 8;
                const int pc = (c / QH) % 2 == 0 ? c + QH : c - QH;
                if (u < UNITS && r < n_rows) {
                    const T* row = src + (size_t)r * ld;
                    const size_t t = (size_t)(trow0 + r) * HD + c;
                    load8(row + c, x[b]);
                    load8(row + pc, pr[b]);
                    load8(cos_t + t, cs[b]);
                    load8(sin_t + t, sn[b]);
                } else {
#pragma unroll
                    for (int e = 0; e < 8; ++e) x[b][e] = pr[b][e] = cs[b][e] = sn[b][e] = 0.f;
                }
            }
#pragma unroll
            for (int b = 0; b < BATCH; ++b) {
                const int u = tid + (it0 + b) * NT;
                if (u >= UNITS) continue;
                const int r = u / CPR, c = (u % CPR) * 8;
                const bool lower = (c / QH) % 2 == 0;
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    x[b][e] = __fadd_rn(__fmul_rn(x[b][e], cs[b][e]),
                                        __fmul_rn(lower ? -pr[b][e] : pr[b][e], sn[b][e]));
                store_unit<PARTS, true, PART>(dst + tile_offset<HD>(ROWS, r, c), x[b], mul);
            }
        }
        return;
    }
    const int qh = d / 4;
#pragma unroll 1
    for (int u = tid; u < UNITS; u += NT) {
        const int r = u / CPR, c = (u % CPR) * 8;
        float x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int col = c + e;
            x[e] = 0.f;
            if (r < n_rows && col < d) {
                const T* row = src + (size_t)r * ld;
                const bool lower = (col / qh) % 2 == 0;
                const float partner = to_f<T>(row[lower ? col + qh : col - qh]);
                const size_t t = (size_t)(trow0 + r) * d + col;
                x[e] = __fadd_rn(__fmul_rn(to_f<T>(row[col]), __ldg(cos_t + t)),
                                 __fmul_rn(lower ? -partner : partner, __ldg(sin_t + t)));
            }
        }
        store_unit<PARTS, true, PART>(dst + tile_offset<HD>(ROWS, r, c), x, mul);
    }
}

// Rotate rows [0, n_rows) of a [ROWS][HD] tile in place by the 2D RoPE
// tables' rows row0.. (quarter-split axial rotate [a, b | c, e] ->
// x * cos + [-b, a | -e, c] * sin), times `mul`, in fp32 with the plain
// version's roundings, rounded to bf16. NT threads share the tile; each
// loads a batch of its units (pairs of 4 or 8 columns) before it computes
// and stores any, so the table reads overlap.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void rope_tile(uint8_t* tile, int n_rows, int row0,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, float mul, int tid) {
    constexpr int QH = HD / 4;
    constexpr int VEC = QH % 8 == 0 ? 8 : 4;       // columns per unit (one 16- or 8-byte load)
    constexpr int PER_HALF = QH / VEC;
    constexpr int UNITS = 2 * PER_HALF;            // per row: (a, b) and (c, e) pairs
    constexpr int ITERS = (ROWS * UNITS + NT - 1) / NT;
    constexpr int BATCH = ITERS < 2 ? ITERS : 2;  // units in flight per thread (registers)
    using Raw = typename std::conditional<VEC == 8, uint4, uint2>::type;
#pragma unroll 1
    for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
        Raw xl[BATCH], xh[BATCH];
        float4 cl[BATCH][VEC / 4], sl[BATCH][VEC / 4], ch[BATCH][VEC / 4], sh[BATCH][VEC / 4];
        uint32_t off_lo[BATCH], off_hi[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int idx = tid + (it0 + b) * NT;
            if (idx >= n_rows * UNITS) continue;
            const int r = idx / UNITS, u = idx - r * UNITS;
            const int c_lo = (u / PER_HALF) * 2 * QH + (u % PER_HALF) * VEC;
            const int c_hi = c_lo + QH;
            off_lo[b] = tile_offset<HD>(ROWS, r, c_lo);
            off_hi[b] = tile_offset<HD>(ROWS, r, c_hi);
            xl[b] = *reinterpret_cast<const Raw*>(tile + off_lo[b]);
            xh[b] = *reinterpret_cast<const Raw*>(tile + off_hi[b]);
            const float4* cs = reinterpret_cast<const float4*>(cos_t + (size_t)(row0 + r) * HD);
            const float4* sn = reinterpret_cast<const float4*>(sin_t + (size_t)(row0 + r) * HD);
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
                cl[b][e] = __ldg(cs + c_lo / 4 + e);
                sl[b][e] = __ldg(sn + c_lo / 4 + e);
                ch[b][e] = __ldg(cs + c_hi / 4 + e);
                sh[b][e] = __ldg(sn + c_hi / 4 + e);
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            if (tid + (it0 + b) * NT >= n_rows * UNITS) continue;
            const __nv_bfloat16* a16 = reinterpret_cast<const __nv_bfloat16*>(&xl[b]);
            const __nv_bfloat16* b16 = reinterpret_cast<const __nv_bfloat16*>(&xh[b]);
            const float* clf = reinterpret_cast<const float*>(cl[b]);
            const float* slf = reinterpret_cast<const float*>(sl[b]);
            const float* chf = reinterpret_cast<const float*>(ch[b]);
            const float* shf = reinterpret_cast<const float*>(sh[b]);
            Raw yl, yh;
            __nv_bfloat16* ya = reinterpret_cast<__nv_bfloat16*>(&yl);
            __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(&yh);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                const float a = __bfloat162float(a16[e]), bv = __bfloat162float(b16[e]);
                const float na = __fadd_rn(__fmul_rn(a, clf[e]), __fmul_rn(-bv, slf[e]));
                const float nb = __fadd_rn(__fmul_rn(bv, chf[e]), __fmul_rn(a, shf[e]));
                ya[e] = __float2bfloat16(__fmul_rn(na, mul));
                yb[e] = __float2bfloat16(__fmul_rn(nb, mul));
            }
            *reinterpret_cast<Raw*>(tile + off_lo[b]) = yl;
            *reinterpret_cast<Raw*>(tile + off_hi[b]) = yh;
        }
    }
}

// ---- the kernel ----------------------------------------------------------------

struct Params {
    void* o;                // bf16, or fp32 with out_f32
    const void* q_src;      // the lane modes: q [Z][s_q][d], k and v [Z][s_kv][d]
    const void* k_src;
    const void* v_src;
    const float* cos_t;     // [S, HD] fp32 (RoPE only)
    const float* sin_t;
    const float* bh;        // [BH, s_q, grid] fp32 (rel-pos bias only): bias_h[q, k / grid]
    const float* bw;        // [BH, s_q, grid]: bias_w[q, k % grid]
    int grid;               // keys on a grid x grid lattice (rel-pos bias only)
    int out_f32;            // store the output as fp32 (else bf16)
    int s_q, s_kv, kv_valid;  // query and key rows per (batch, head); keys that score
    int d;                  // the head dim (HD zero-pads it; its first d columns are stored)
    int vec;                // the lane modes: rows 16-byte aligned (16-byte loads)
    int lanes;              // 1: [B, S, W], grid (q tiles, heads, B); 0: [BH, S, D], grid (q tiles, BH)
    int row_stride;         // output row stride in elements (W or D)
    float score_mul;        // log2(e) * scale; log2(e) with the scale folded into q
    float q_scale;          // the softmax scale (RoPE and split: folded into q)
    float bias_mul;         // the bias in units of the product: 1 / scale, 1 with q scaled
    float* lse;             // null, or each query row's log-sum-exp [Z * heads, s_q] (K3's
                            // backward reads it), in base 2: log2(sum_k 2^(s_k * score_mul))
};

// rel-pos bias modes: none; every tile one row of the key lattice (G ==
// BK); any lattice width G (each key's lattice row and column computed)
constexpr int kBiasNone = 0, kBiasRow = 1, kBiasAny = 2;

template <int HD, int BK, int NWG, int STAGES, int BIAS, int PARTS>
struct Smem {
    static constexpr int Q_BYTES = NWG * PARTS * kQRows * HD * 2;
    static constexpr int KV_BYTES = PARTS * BK * HD * 2;   // one K or V tile, all its parts
    // rel-pos bias: each consumer thread's bw terms of its BK / 2 fragment
    // positions (the same in every tile when a tile is one lattice row)
    static constexpr int BW_BYTES = BIAS == kBiasRow ? NWG * kWgThreads * (BK / 2) * 4 : 0;
    static constexpr int BYTES =
        1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BW_BYTES + 8 * (1 + 3 * STAGES);
};


__device__ __forceinline__ float ex2(float x) {   // 2^x on the SFU; 2^-inf = 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// S = Q K^T of one tile, started (not waited for): for each term (one in
// the bf16 modes, kSplitTerms in the split mode, smallest first) HD / 16
// k16 steps; ONTO adds the products to the values already in sc (the bias
// mode's column terms), else the first step overwrites them
template <int HD, int BK, int PARTS, bool ONTO = false>
__device__ __forceinline__ void qk_tile(float (&sc)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
    using G = Geo<HD>;
    constexpr int T0 = PARTS == 3 ? 0 : kSplitTerms - 1;
    constexpr uint32_t QP = kQRows * HD * 2, KP = BK * HD * 2;   // bytes of one part
#pragma unroll
    for (int t = T0; t < kSplitTerms; ++t)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            const int a = kk * 16 / G::ATOM;
            const uint32_t kin = (kk * 16 % G::ATOM) * 2;
            const uint64_t da = gmma_desc(q_addr + split_part(t, 0) * QP
                                              + a * kQRows * G::ATOM_BYTES + kin,
                                          16, 8 * G::ATOM_BYTES, G::LAYOUT);
            const uint64_t db = gmma_desc(k_addr + split_part(t, 1) * KP
                                              + a * BK * G::ATOM_BYTES + kin,
                                          16, 8 * G::ATOM_BYTES, G::LAYOUT);
            WgmmaSS<BK>::run(sc, da, db, ONTO || t > T0 || kk > 0);
        }
}

// Online softmax of one score tile, in place, for rows g and g + 8 of a
// warp's 16 (thread t holds columns 8n + 2t, 8n + 2t + 1 of each 8-column
// block n): keys at or past kv_valid score -inf; the running maxima m (in
// units of log2: scores times `mul` = log2(e) * scale, plus with ROW_TERMS
// the rows' terms ha, hb, the bias mode's bh * log2(e)) move to the tile's,
// c = 2^(m_old - m_new), sc becomes p = 2^(s * mul + h - m) in fp32, and
// rs its row sums.
template <int BK, bool ROW_TERMS = false>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float mul, int kb,
                                             int kv_valid, int t, float& m0, float& m1,
                                             float& c0, float& c1, float& rs0, float& rs1,
                                             float ha = 0.f, float hb = 0.f) {
    if (kb + BK > kv_valid) {
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (kb + 8 * n + 2 * t + e >= kv_valid)
                    sc[4 * n + e] = sc[4 * n + 2 + e] = -CUDART_INF_F;
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n + 0], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // mul > 0: max(s) * mul is max(s * mul) exactly
    const float mn0 = fmaxf(m0, ROW_TERMS ? fmaf(mx0, mul, ha) : mx0 * mul);
    const float mn1 = fmaxf(m1, ROW_TERMS ? fmaf(mx1, mul, hb) : mx1 * mul);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // the exponent's offsets (finite: tile 0 holds key 0)
    const float o0 = ROW_TERMS ? ha - mn0 : -mn0, o1 = ROW_TERMS ? hb - mn1 : -mn1;
    rs0 = rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        sc[4 * n + 0] = ex2(fmaf(sc[4 * n + 0], mul, o0));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], mul, o0));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], mul, o1));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], mul, o1));
        rs0 += sc[4 * n + 0] + sc[4 * n + 1];
        rs1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
}

// p into the k16 register fragments of the PV product, rounded to bf16
// (PARTS = 1) or split into hi, mid and lo (PARTS = 3): fragment n / 2
// takes registers 0, 1 from block 2kk and 2, 3 from 2kk + 1 (the m64nN
// accumulator layout is the k16 register-A layout)
template <int BK, int PARTS>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[PARTS][BK / 16][4]) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        const int f = n / 2, r = (n % 2) * 2;
        if constexpr (PARTS == 3) {
            split2(sc[4 * n + 0], sc[4 * n + 1], pa[0][f][r], pa[1][f][r], pa[2][f][r]);
            split2(sc[4 * n + 2], sc[4 * n + 3], pa[0][f][r + 1], pa[1][f][r + 1],
                   pa[2][f][r + 1]);
        } else {
            pa[0][f][r] = pack_bf16(sc[4 * n + 0], sc[4 * n + 1]);
            pa[0][f][r + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
        }
    }
}

// O += P V of one tile, started: for each term BK / 16 k16 steps, V
// MN-major (its rows are the keys, D contiguous); FRESH: O = P V (the first
// step overwrites O)
template <int HD, int BK, int PARTS, bool FRESH = false>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2], const uint32_t (&pa)[PARTS][BK / 16][4],
                                        uint32_t v_addr) {
    using G = Geo<HD>;
    constexpr int T0 = PARTS == 3 ? 0 : kSplitTerms - 1;
    constexpr uint32_t VP = BK * HD * 2;
#pragma unroll
    for (int t = T0; t < kSplitTerms; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t dv = gmma_desc(v_addr + split_part(t, 1) * VP + kk * 16 * G::ATOM_BYTES,
                                          BK * G::ATOM_BYTES, 8 * G::ATOM_BYTES, G::LAYOUT);
            WgmmaRS<HD>::run(o, pa[split_part(t, 0)][kk], dv, !FRESH || t > T0 || kk > 0);
        }
}

// SAM's decomposed relative-position bias at a lattice width G other than
// BK (a tile spans parts of lattice rows): each in-range key's lattice row
// and column are computed and its bias added to the product in the
// product's units (times 1 / scale where the scale is applied after the
// product), so that softmax_tile's s * mul is (q.k * scale + bh[q, k / G]
// + bw[q, k % G]) * log2(e); rows a = g and b = g + 8 of the warp's 16,
// thread t's columns 8n + 2t and 8n + 2t + 1
template <int BK>
__device__ __forceinline__ void add_bias_keys(float (&sc)[BK / 2], float bias_mul, int kb,
                                              int kv_valid, int grid, const float* bh_a,
                                              const float* bh_b, const float* bw_a,
                                              const float* bw_b, int t) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int key = kb + 8 * n + 2 * t + e;
            if (key < kv_valid) {   // the rest score -inf in the softmax
                const int ky = key / grid, kx = key - ky * grid;
                sc[4 * n + e] =
                    fmaf(__ldg(bh_a + ky) + __ldg(bw_a + kx), bias_mul, sc[4 * n + e]);
                sc[4 * n + 2 + e] =
                    fmaf(__ldg(bh_b + ky) + __ldg(bw_b + kx), bias_mul, sc[4 * n + 2 + e]);
            }
        }
}

// one output element, fp32 or bf16
__device__ __forceinline__ void store_one(void* o, bool f32, size_t idx, float a) {
    if (f32)
        static_cast<float*>(o)[idx] = a;
    else
        static_cast<__nv_bfloat16*>(o)[idx] = __float2bfloat16(a);
}

// output columns c and c + 1 of one row where c + 1 is below the head dim
// (`two`), else column c alone: one store of the pair where an even row
// stride keeps it aligned (`pair`), else one element at a time
__device__ __forceinline__ void store_cols(void* o, bool f32, size_t idx, float a, float b,
                                           bool two, bool pair) {
    if (two && pair) {
        if (f32)
            *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) = make_float2(a, b);
        else
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) + idx) = pack_bf16(a, b);
        return;
    }
    store_one(o, f32, idx, a);
    if (two) store_one(o, f32, idx + 1, b);
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], float c0, float c1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 0] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
    }
}

// o = (o + ot) * c on the CUDA cores (ot: a tile's PV product)
template <int HD>
__device__ __forceinline__ void add_rescale(float (&o)[HD / 2], const float (&ot)[HD / 2],
                                            float c0, float c1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 0] = __fmul_rn(__fadd_rn(o[4 * n + 0], ot[4 * n + 0]), c0);
        o[4 * n + 1] = __fmul_rn(__fadd_rn(o[4 * n + 1], ot[4 * n + 1]), c0);
        o[4 * n + 2] = __fmul_rn(__fadd_rn(o[4 * n + 2], ot[4 * n + 2]), c1);
        o[4 * n + 3] = __fmul_rn(__fadd_rn(o[4 * n + 3], ot[4 * n + 3]), c1);
    }
}

// producer: wait until tile j's stage is free, then bring its K and V
// tiles (every atom of the head's columns) onto the stage's full barrier
template <int HD, int BK, int STAGES>
__device__ __forceinline__ void load_kv(int j, uint8_t* ks, uint8_t* vs, uint64_t* full,
                                        uint64_t* empty, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int col0, int z) {
    using G = Geo<HD>;
    constexpr int KV_BYTES = BK * HD * 2;
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[s], 2 * KV_BYTES);
#pragma unroll
    for (int a = 0; a < G::NATOM; ++a) {
        const int off = s * KV_BYTES + a * BK * G::ATOM_BYTES;
        tma_load_3d(ks + off, kmap, &full[s], col0 + a * G::ATOM, j * BK, z);
        tma_load_3d(vs + off, vmap, &full[s], col0 + a * G::ATOM, j * BK, z);
    }
}

// Tile choice (measured on the H100, see PERF.md): 64-key tiles (128-key
// tiles measured slower: twice the score registers). Without RoPE one
// consumer warpgroup (64 query rows) per CTA and a ring of four stages:
// twice the CTAs of 128-row tiles fill the 132 SMs more evenly. With RoPE
// two consumer warpgroups (128 rows) share each K tile's rotation, which
// halves the RoPE pass's table reads per query row, and, through TMA, a
// ring of six stages gives the three rotating warps room to run ahead. The
// ring's depth is a multiple of the rotating warps, so each warp owns the
// same stages throughout and waits on every phase of their barriers in
// order (a parity wait cannot tell a phase from the one two before it).
// The lanes' copy with RoPE keeps four stages, the split mode its own. The
// split mode keeps three bf16 parts of every tile: at HD <= 64 two
// consumer warpgroups share each split K/V tile (half the split pass per
// query row; one warpgroup measured 1.4x slower); at HD > 64 one
// warpgroup and 32-key tiles. Its ring has three stages (225 KB with SAM's
// bias terms at HD = 64): a consumer holds two stages at once (the scores
// of tile j + 1 beside the PV product of tile j), so with two the lanes
// could not split a tile ahead (measured 1.25x slower). Its producer
// warpgroup hands registers to the consumers (setmaxnreg), which hold o, a
// tile's PV product, the scores and p's three parts; the lanes keep 120
// (136 at HD = 48, whose 6-unit rows take more address registers), enough
// for a batch of eight 8-column loads without spills (with RoPE a batch of
// two units, each with its partner and table values).
constexpr int kBK = 64;
template <int HD, bool ROPE, int OPS> struct Tiles {
    static constexpr bool SPLIT = OPS == kOpsSplit;
    static constexpr bool ROTATING_WARPS = ROPE && OPS == kOpsTma;   // K tiles rotated in place
    static constexpr int BK = SPLIT && HD > 64 ? 32 : kBK;
    static constexpr int NWG = SPLIT ? (HD <= 64 ? 2 : 1) : ROPE ? 2 : 1;
    static constexpr int STAGES = ROTATING_WARPS ? 6 : SPLIT ? 3 : 4;
    static constexpr int PRODUCER_REGS = SPLIT && NWG == 2 ? (HD % 32 ? 136 : 120) : 0;
};

// what each consumer thread may take when the producer warpgroup keeps
// `producer` registers of the launch-bound share (65536 over (NWG + 1) x
// 128 threads, in steps of 8)
__host__ __device__ constexpr int consumer_regs(int nwg, int producer) {
    return ((65536 / ((nwg + 1) * kWgThreads)) / 8 * 8 * (nwg + 1) - producer) / nwg / 8 * 8;
}

// SAM's bias mode (one consumer warpgroup, head dim 64, bf16) is held to
// two CTAs an SM (at most 128 registers a thread), as the bias-free kernel
// is
template <int HD, int BK, int NWG, int STAGES, bool ROPE, int BIAS, int OPS>
__global__ void __launch_bounds__((NWG + 1) * kWgThreads,
                                  BIAS == kBiasRow && NWG == 1 && HD <= 64 && OPS != kOpsSplit
                                      ? 2 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Params p) {
    using G = Geo<HD>;
    using O = Ops<OPS>;
    using T = typename O::T;
    constexpr int PARTS = O::PARTS;
    // the split mode takes each tile's PV product in a fresh accumulator and
    // adds it to the running output on the CUDA cores (fp32, round to
    // nearest): the tensor cores' fp32 accumulation is not rounded to
    // nearest, and in one accumulator its error grows with the tiles summed
    constexpr bool PROMOTE = PARTS == 3;
    constexpr int PRODUCER_REGS = Tiles<HD, ROPE, OPS>::PRODUCER_REGS;
    using L = Smem<HD, BK, NWG, STAGES, BIAS, PARTS>;
    constexpr float kLog2e = 1.4426950408889634f;
    static_assert(HD % 16 == 0 && HD <= 128 && BK % 16 == 0, "tile shape");
    static_assert(O::LANE_LOADS || !ROPE || STAGES % kRotWarps == 0,
                  "each rotating warp owns its stages");
    static_assert(!(ROPE && BIAS), "RoPE and the rel-pos bias are separate modes");
    extern __shared__ uint8_t smem_raw[];
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = base;                                // [NWG][PARTS][NATOM][64][ATOM]
    uint8_t* ks = qs + L::Q_BYTES;                     // [STAGES][PARTS][NATOM][BK][ATOM]
    uint8_t* vs = ks + STAGES * L::KV_BYTES;
    float4* bws = reinterpret_cast<float4*>(vs + STAGES * L::KV_BYTES);   // [NWG][BK / 8][128]
    uint64_t* qbar = reinterpret_cast<uint64_t*>(vs + STAGES * L::KV_BYTES + L::BW_BYTES);
    uint64_t* full = qbar + 1;      // K and V of a stage landed (TMA bytes, or every lane)
    uint64_t* empty = full + STAGES;  // every consumer warp is done with a stage
    uint64_t* rot = empty + STAGES;   // RoPE: the stage's K tile is rotated

    const int wg = threadIdx.x / kWgThreads;
    const int tid = threadIdx.x % kWgThreads;
    const int q0 = blockIdx.x * NWG * kQRows;
    const int col0 = p.lanes ? blockIdx.y * p.d : 0;   // heads in lanes: the head's first column
    const int z = p.lanes ? blockIdx.z : blockIdx.y;
    const int n_tiles = ceil_div(p.kv_valid, BK);

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], O::LANE_LOADS ? kWgThreads : 1);
            mbar_init(&empty[s], NWG * 4);
            mbar_init(&rot[s], 32);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == NWG) {
        // ---- producer warpgroup ----
        if constexpr (PRODUCER_REGS > 0) setmaxnreg_dec<PRODUCER_REGS>();
        if constexpr (O::LANE_LOADS) {
            // the four warps load (and split) each K and V tile into its
            // stage, keys past kv_valid as zeros, then arrive on its full
            // barrier
            const T* kp = static_cast<const T*>(p.k_src);
            const T* vp = static_cast<const T*>(p.v_src);
            for (int j = 0; j < n_tiles; ++j) {
                const int s = j % STAGES;
                mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
                const size_t off = ((size_t)z * p.s_kv + (size_t)j * BK) * p.row_stride + col0;
                const int n_rows = min(BK, p.kv_valid - j * BK);
                if constexpr (ROPE) {   // K rotated as it loads, V as it is
                    lane_tile_rope<T, PARTS, HD, BK, kWgThreads>(
                        ks + s * L::KV_BYTES, kp + off, p.row_stride, n_rows, p.d, 1.f,
                        p.vec != 0, tid, p.cos_t, p.sin_t, j * BK);
                    lane_tiles<T, PARTS, HD, BK, kWgThreads, 1>(
                        vs + s * L::KV_BYTES, vs + s * L::KV_BYTES, vp + off, vp + off,
                        p.row_stride, n_rows, p.d, 1.f, p.vec != 0, tid);
                } else {
                    lane_tiles<T, PARTS, HD, BK, kWgThreads, 2>(
                        ks + s * L::KV_BYTES, vs + s * L::KV_BYTES, kp + off, vp + off,
                        p.row_stride, n_rows, p.d, 1.f, p.vec != 0, tid);
                }
                fence_proxy_async();
                mbar_arrive(&full[s]);
            }
        } else {
            if (tid == 0) {
                mbar_expect_tx(qbar, L::Q_BYTES);
                for (int g = 0; g < NWG; ++g)
#pragma unroll
                    for (int a = 0; a < G::NATOM; ++a)
                        tma_load_3d(qs + (g * G::NATOM + a) * kQRows * G::ATOM_BYTES, &qmap,
                                    qbar, col0 + a * G::ATOM, q0 + g * kQRows, z);
            }
            // warp 0 loads, as far ahead as the ring allows. With RoPE, warps
            // 1-3 take the landed K tiles in turn (warp w rotates tiles j with
            // j % 3 == w - 1, in place: the stages j % STAGES it owns), so three
            // tiles rotate at once, each warp's L2 reads of the tables
            // overlapping the others'
            const int warp = tid / 32;
            if (tid == 0) {
                for (int j = 0; j < n_tiles; ++j)
                    load_kv<HD, BK, STAGES>(j, ks, vs, full, empty, &kmap, &vmap, col0, z);
            } else if (ROPE && warp > 0) {
                for (int j = warp - 1; j < n_tiles; j += kRotWarps) {
                    const int s = j % STAGES;
                    mbar_wait(&full[s], (j / STAGES) & 1);
                    rope_tile<HD, BK, 32>(ks + s * L::KV_BYTES, min(BK, p.kv_valid - j * BK),
                                          j * BK, p.cos_t, p.sin_t, 1.f, tid % 32);
                    fence_proxy_async();
                    mbar_arrive(&rot[s]);
                }
            }
        }
    } else {
        // ---- consumer warpgroup: 64 query rows ----
        if constexpr (PRODUCER_REGS > 0)
            setmaxnreg_inc<consumer_regs(NWG, PRODUCER_REGS)>();
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane / 4, t = lane % 4;
        uint8_t* my_q = qs + wg * PARTS * kQRows * HD * 2;
        float o[HD / 2], ot[HD / 2];   // ot: a tile's PV product (PROMOTE)
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
        float c0 = 1.f, c1 = 1.f, rs0 = 0.f, rs1 = 0.f;

        // rel-pos bias: this thread's rows r0 and r0 + 8 (rows past s_q read
        // row s_q - 1 and are never stored). When a tile is one lattice row
        // (kBiasRow), the bw terms of the thread's columns are the same in
        // every tile: they go to shared memory once (in the product's units;
        // the thread's own float4 slots, so no barrier) and start each S
        // accumulator, so the product lands on them; bh is one value per
        // row and tile, loaded ahead of the tile's product, that joins the
        // running max and the exponent's offset in log2 units.
        const int r0 = q0 + wg * kQRows + warp * 16 + g;
        float sc[BK / 2];
        float4* bw4 = bws + wg * (BK / 8) * kWgThreads + tid;   // [BK / 8] at stride 128
        size_t off_a = 0, off_b = 0;
        float ha = 0.f, hb = 0.f;
        if constexpr (BIAS != kBiasNone) {
            off_a = ((size_t)z * p.s_q + min(r0, p.s_q - 1)) * p.grid;
            off_b = ((size_t)z * p.s_q + min(r0 + 8, p.s_q - 1)) * p.grid;
        }
        if constexpr (BIAS == kBiasRow) {
            const float mul = p.bias_mul;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n) {
                const int c = 8 * n + 2 * t;
                const float2 wa = __ldg(reinterpret_cast<const float2*>(p.bw + off_a + c));
                const float2 wb = __ldg(reinterpret_cast<const float2*>(p.bw + off_b + c));
                bw4[n * kWgThreads] = make_float4(wa.x * mul, wa.y * mul, wb.x * mul, wb.y * mul);
            }
        }
        auto bias_rows = [&](int j) {   // tile j's bh terms, loaded ahead of its product
            if constexpr (BIAS == kBiasRow) {
                ha = __ldg(p.bh + off_a + j) * kLog2e;
                hb = __ldg(p.bh + off_b + j) * kLog2e;
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {   // the S accumulator starts at bw
                    const float4 w = bw4[n * kWgThreads];
                    sc[4 * n + 0] = w.x;
                    sc[4 * n + 1] = w.y;
                    sc[4 * n + 2] = w.z;
                    sc[4 * n + 3] = w.w;
                }
            }
        };
        // tile j's scores -> p (fp32), the running max and row sums
        auto softmax = [&](int j) {
            if constexpr (BIAS == kBiasAny)
                add_bias_keys<BK>(sc, p.bias_mul, j * BK, p.kv_valid, p.grid,
                                  p.bh + off_a, p.bh + off_b, p.bw + off_a, p.bw + off_b, t);
            softmax_tile<BK, BIAS == kBiasRow>(sc, p.score_mul, j * BK, p.kv_valid, t, m0, m1,
                                               c0, c1, rs0, rs1, ha, hb);
        };

        if constexpr (O::LANE_LOADS) {
            // this warpgroup's q rows, loaded once (with RoPE rotated; split
            // or with RoPE: times the scale; split: then split)
            const int row0 = q0 + wg * kQRows;
            const T* src =
                static_cast<const T*>(p.q_src) + ((size_t)z * p.s_q + row0) * p.row_stride + col0;
            if constexpr (ROPE)
                lane_tile_rope<T, PARTS, HD, kQRows, kWgThreads>(
                    my_q, src, p.row_stride, min(kQRows, p.s_q - row0), p.d, p.q_scale,
                    p.vec != 0, tid, p.cos_t, p.sin_t, row0);
            else
                lane_tiles<T, PARTS, HD, kQRows, kWgThreads, 1>(
                    my_q, my_q, src, src, p.row_stride, min(kQRows, p.s_q - row0), p.d,
                    OPS == kOpsSplit ? p.q_scale : 1.f, p.vec != 0, tid);
            fence_proxy_async();
            named_bar_sync(1 + wg, kWgThreads);
        } else {
            mbar_wait(qbar, 0);
            if constexpr (ROPE) {
                const int row0 = q0 + wg * kQRows;
                rope_tile<HD, kQRows, kWgThreads>(my_q, min(kQRows, p.s_q - row0), row0,
                                                  p.cos_t, p.sin_t, p.q_scale, tid);
                fence_proxy_async();
                named_bar_sync(1 + wg, kWgThreads);
            }
        }
        const uint32_t q_addr = smem_addr(my_q);
        auto wait_tile = [&](int j) {
            const uint32_t ph = (j / STAGES) & 1;
            mbar_wait(&full[j % STAGES], ph);
            if constexpr (ROPE && !O::LANE_LOADS) mbar_wait(&rot[j % STAGES], ph);
        };
        auto k_addr = [&](int j) { return smem_addr(ks + (j % STAGES) * L::KV_BYTES); };
        auto v_addr = [&](int j) { return smem_addr(vs + (j % STAGES) * L::KV_BYTES); };
        auto release = [&](int j) {   // this warp is done with tile j's stage
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[j % STAGES]);
        };

        // The loop keeps the tensor cores fed: with P_j in registers it
        // starts S_{j+1} = Q K_{j+1}^T, then O += P_j V_j, and runs tile
        // j + 1's softmax while the PV product is in flight; only the
        // rescale of O and the packing (split) of P_{j+1} wait for it. No
        // wgmma is started under a branch (the last tile is peeled), so
        // ptxas keeps the products asynchronous.
        uint32_t pa[PARTS][BK / 16][4];
        if (n_tiles > 0) {
            bias_rows(0);
            wait_tile(0);
            wgmma_fence();
            qk_tile<HD, BK, PARTS, BIAS == kBiasRow>(sc, q_addr, k_addr(0));
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(sc);
            softmax(0);
            l0 = rs0;
            l1 = rs1;
            pack_p<BK, PARTS>(sc, pa);
            for (int j = 0; j + 1 < n_tiles; ++j) {
                bias_rows(j + 1);
                wait_tile(j + 1);
                wgmma_fence();
                qk_tile<HD, BK, PARTS, BIAS == kBiasRow>(sc, q_addr, k_addr(j + 1));
                wgmma_commit();
                pv_tile<HD, BK, PARTS, PROMOTE>(PROMOTE ? ot : o, pa, v_addr(j));
                wgmma_commit();
                wgmma_wait<1>();
                fence_operand(sc);
                softmax(j + 1);
                wgmma_wait<0>();
                fence_operand(PROMOTE ? ot : o);
                release(j);
                l0 = l0 * c0 + rs0;
                l1 = l1 * c1 + rs1;
                if constexpr (PROMOTE)
                    add_rescale<HD>(o, ot, c0, c1);
                else
                    rescale<HD>(o, c0, c1);
                pack_p<BK, PARTS>(sc, pa);
            }
            wgmma_fence();
            pv_tile<HD, BK, PARTS, PROMOTE>(PROMOTE ? ot : o, pa, v_addr(n_tiles - 1));
            wgmma_commit();
            wgmma_wait<0>();
            fence_operand(PROMOTE ? ot : o);
            release(n_tiles - 1);
            if constexpr (PROMOTE)
                add_rescale<HD>(o, ot, 1.f, 1.f);
        }

        // epilogue: acc / l (the quad's partial sums added), rounded to bf16
        // or stored as fp32, the head dim's columns only
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        // the log-sum-exp the backward reads, in the same base-2 units as m:
        // the scores times score_mul (log2(e), times the scale unless it
        // was folded into q)
        if (p.lse != nullptr && t == 0) {
            float* lse = p.lse + (size_t)(p.lanes ? blockIdx.z * gridDim.y + blockIdx.y
                                                  : blockIdx.y) * p.s_q;
            if (r0 < p.s_q) lse[r0] = m0 + log2f(l0);
            if (r0 + 8 < p.s_q) lse[r0 + 8] = m1 + log2f(l1);
        }
        const size_t ob = (size_t)z * p.s_q * p.row_stride + col0;
        const bool f32 = p.out_f32 != 0;
        // every column pair stored whole where the head dim fills HD and an
        // even row stride keeps the pairs aligned
        const bool whole = p.d == HD && p.row_stride % 2 == 0;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            const int c = 8 * n + 2 * t;
            if (!whole && c >= p.d) continue;
            const bool two = whole || c + 1 < p.d;
            const bool pair = whole || p.row_stride % 2 == 0;
            if (r0 < p.s_q)
                store_cols(p.o, f32, ob + (size_t)r0 * p.row_stride + c, o[4 * n + 0] / l0,
                           o[4 * n + 1] / l0, two, pair);
            if (r0 + 8 < p.s_q)
                store_cols(p.o, f32, ob + (size_t)(r0 + 8) * p.row_stride + c,
                           o[4 * n + 2] / l1, o[4 * n + 3] / l1, two, pair);
        }
    }
}

// ---- host side -------------------------------------------------------------------


// a 3-D bf16 map over [d2][d1][d0] (d0 contiguous), box [1][rows][ATOM],
// swizzled as the wgmma descriptors read it; out-of-bounds rows and
// columns (a box past d0 when HD pads the head dim) read zero
template <int HD>
static inline bool make_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
                            int rows) {
    using G = Geo<HD>;
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
    const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
    const cuuint32_t box[3] = {(cuuint32_t)G::ATOM, (cuuint32_t)rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUtensorMapSwizzle sw = G::ATOM_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::ATOM_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

static inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Call {
    const void *q, *k, *v;
    void* o;
    const void *cos_t, *sin_t, *bh, *bw;
    int d, lanes, d0, z, heads, s_q, s_kv, kv_valid, rel_grid, out_f32;
    float scale;
    cudaStream_t stream;
    float* lse = nullptr;   // each query row's log-sum-exp (Params::lse), or none
};

template <int HD, bool ROPE, int OPS, int BIAS>
static int launch(const Call& c) {
    using Tl = Tiles<HD, ROPE, OPS>;
    constexpr int NWG = Tl::NWG, STAGES = Tl::STAGES, BK = Tl::BK;
    using L = Smem<HD, BK, NWG, STAGES, BIAS, Ops<OPS>::PARTS>;
    using T = typename Ops<OPS>::T;
    CUtensorMap qm, km, vm;
    if constexpr (OPS == kOpsTma) {
        if (!make_map<HD>(&qm, c.q, c.d0, c.s_q, c.z, kQRows)
            || !make_map<HD>(&km, c.k, c.d0, c.s_kv, c.z, BK)
            || !make_map<HD>(&vm, c.v, c.d0, c.s_kv, c.z, BK))
            return kMapError;
    } else {
        memset(&qm, 0, sizeof(qm));
        memset(&km, 0, sizeof(km));
        memset(&vm, 0, sizeof(vm));
    }
    auto kernel = flash_tc_kernel<HD, BK, NWG, STAGES, ROPE, BIAS, OPS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    constexpr float kLog2e = 1.4426950408889634f;
    const bool folded = ROPE || OPS == kOpsSplit;   // the scale is folded into q
    Params p;
    p.o = c.o;
    p.q_src = c.q;
    p.k_src = c.k;
    p.v_src = c.v;
    p.cos_t = static_cast<const float*>(c.cos_t);
    p.sin_t = static_cast<const float*>(c.sin_t);
    p.bh = static_cast<const float*>(c.bh);
    p.bw = static_cast<const float*>(c.bw);
    p.grid = c.rel_grid;
    p.out_f32 = c.out_f32;
    p.s_q = c.s_q;
    p.s_kv = c.s_kv;
    p.kv_valid = c.kv_valid;
    p.d = c.d;
    // 16-byte row loads: the head's columns and the row stride whole 16-byte
    // units (heads in lanes: the head's first column too), aligned bases
    p.vec = (c.d * (int)sizeof(T)) % 16 == 0 && (c.d0 * (int)sizeof(T)) % 16 == 0 &&
            aligned16(c.q) && aligned16(c.k) && aligned16(c.v);
    p.lanes = c.lanes;
    p.row_stride = c.d0;
    p.score_mul = folded ? kLog2e : kLog2e * c.scale;
    p.q_scale = c.scale;
    p.bias_mul = folded ? 1.f : 1.f / c.scale;
    p.lse = c.lse;
    dim3 grid(ceil_div(c.s_q, NWG * kQRows), c.lanes ? c.heads : c.z, c.lanes ? c.z : 1);
    kernel<<<grid, (NWG + 1) * kWgThreads, L::BYTES, c.stream>>>(qm, km, vm, p);
    return (int)cudaGetLastError();
}

// the bias mode by the tile: one lattice row a tile where G == BK
template <int HD, bool ROPE, int OPS, bool BIASED>
static int launch_bias(const Call& c) {
    if constexpr (BIASED) {
        if (c.rel_grid == Tiles<HD, ROPE, OPS>::BK) return launch<HD, ROPE, OPS, kBiasRow>(c);
        return launch<HD, ROPE, OPS, kBiasAny>(c);
    } else {
        return launch<HD, ROPE, OPS, kBiasNone>(c);
    }
}

// q [Z][s_q][d0], k and v [Z][s_kv][d0] (bf16; fp32 in the split mode);
// `lanes` = 1 reads head y's d columns at y * d of d0 = W (grid.z = batch;
// d % 16 == 0 through TMA), 0 reads d0 = d (grid.y = batch * head); any d
// <= 128 is zero-padded to a multiple of 16 in shared memory. ROPE: cos_t,
// sin_t [s_q][d] fp32, 16-byte aligned, d % 4 == 0 (s_q == s_kv). BIASED:
// bh, bw [Z][s_q][rel_grid] fp32 (lanes = 0). out_f32: the output is fp32,
// else bf16.
template <bool ROPE, int OPS, bool BIASED>
static int dispatch(const Call& c) {
    if (c.d <= 0 || c.d > 128 || (c.lanes && OPS == kOpsTma && c.d % 16)) return kUnsupported;
    // RoPE rotates quarters of the head; the lanes read the tables' rows
    // 16 bytes at a time
    if (ROPE && (c.d % 4 || (Ops<OPS>::LANE_LOADS && !(aligned16(c.cos_t) && aligned16(c.sin_t)))))
        return kUnsupported;
    if (BIASED && (c.lanes || c.rel_grid <= 0 || (long long)c.rel_grid * c.rel_grid < c.kv_valid))
        return kUnsupported;
#define RV_TC_CASE(HD) \
    case HD: return launch_bias<HD, ROPE, OPS, BIASED>(c);
    switch ((c.d + 15) / 16 * 16) {
        RV_TC_CASE(16) RV_TC_CASE(32) RV_TC_CASE(48) RV_TC_CASE(64)
        RV_TC_CASE(80) RV_TC_CASE(96) RV_TC_CASE(112) RV_TC_CASE(128)
        default: return kUnsupported;
    }
#undef RV_TC_CASE
}

}  // namespace tc
}  // namespace rv
