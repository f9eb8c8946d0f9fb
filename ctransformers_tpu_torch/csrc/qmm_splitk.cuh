// The decode GEMVs at m <= 32 on the factored int8 grids (Q6_K: group 16, no
// mins; Q5_K: group 32, with mins), ct_qmm_g8 (mode "g") and ct_qmm_f (mode
// "") of qmm_float.cu; on every int8 grid (those two, and the legacy Q8_0,
// Q5_0 and Q5_1 with plain f32 planes at group 32), ct_qmm_q8 and
// ct_qmm_q8_legacy (mode "q" on activations quantized outside) of
// qmm_grid.cu, and ct_qmm_rb8 and ct_qmm_rb8_legacy (mode "rb", the bf16
// function of "b") of qmm_grid.cu; on the Q4_K adjk nibbles (group 32, with
// mins), ct_qmm_qx (mode "qx") of qmm_decode.cu and ct_qmm_g (mode "g") of
// qmm_float.cu; and on the ksplit nibbles of every kind, ct_qmm_f_ks (mode
// ""), ct_qmm_s_ks (mode "s"), ct_qmm_b_ks (mode "b") and ct_qmm_rb_ks
// (mode "rb", the function of "b") of qmm_ksplit.cu: each symbol takes this
// design there, its file's own (qmm_float.cuh for f_ks and s_ks, the Hopper
// core of qmm_wgmma.cuh for the rb8, b_ks and rb_ks ones) above.
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py (what they compute is the
// files' first designs', unchanged):
//   _qmm_g_kernel (:1206) on the grids -> ct_qmm_g8
//       out = sum_g s[g,n] * dot_g(bf16(x), q)[t,n] + xsum @ M (Q5_K)
//   _qmm_kernel mode "" (:734) on the grids -> ct_qmm_f
//       out = x @ (q * s + m), all f32
//   _qmm_rb_kernel mode "rb" (:1459) on every int8 grid -> ct_qmm_rb8,
//       ct_qmm_rb8_legacy
//       out = bf16(x) @ bf16(q * s + m), f32 sums (the function of "b")
//   _qmm_q_kernel (:1288) with packed4=False -> ct_qmm_q8, ct_qmm_q8_legacy
//       out = sum_g (dot_g(xq, q)[t,n] * sx[t,g]) * s[g,n] + xsum @ M, the
//       group dots exact in int32, xq, sx and xsum given per (token, group)
//   _qmm_qx_kernel (:1370) on Q4_K -> ct_qmm_qx
//       out = sum_g (dot_g(xq, w4)[t,n] * sx[t,g]) * s[g,n] + xsum @ B, the
//       group dots exact in int32, x quantized per (token, group of 32)
//   _qmm_g_kernel (:1206) on Q4_K -> ct_qmm_g
//       out = sum_g s[g,n] * dot_g(bf16(x), w4)[t,n] + xsum @ B
//   _qmm_pack4_kernel (:783) -> ct_qmm_f_ks
//       out = x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), all f32
//   _qmm_pack4_s_kernel (:957) mode "s" -> ct_qmm_s_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + x_lo @ (l * s) + x_hi @ (f * s)
//   _qmm_pack4_kernel (:783) mode "b", _qmm_pack4_rb_kernel (:872) mode
//   "rb" -> ct_qmm_b_ks, ct_qmm_rb_ks
//       out = bf16(x) @ bf16(v * s + B), f32 sums (v = l in the low half,
//       f in the high one)
// with w4 the stored nibble and B = 8 s + m; on ksplit (qmm_common.cuh) l
// and f the low and high nibble's values, x_lo and x_hi the halves of x,
// xs their group sums, B_lo = -zp s + m, B_hi = (8 - zp) s + m.
//
// Bound on an H100: the weight's bytes (1 B a grid weight or 0.5 B a
// nibble, 1/G B of sub-scales, 4/256 B of factors) at m = 1; at m = 8 the
// f32 pipes come near (two f32 operations a weight byte a row: 67 TFLOP/s
// over 3.35 TB/s is 20). The files' first designs held a block to 32
// columns and all of K: 128 blocks at N = 4096, each chunk's weights loaded
// only after the barrier that staged its x, 16 KB in flight an SM, so the
// narrow long-K shapes ran at 2.6-3.6x their bound.
//
// Design (both layouts):
//   - A block owns 128 output columns (a warp's 32 threads x 4) and a range
//     of K. Its 8 warps are K lanes: on a grid warp w takes rows [16 w,
//     16 w + 16) of each 128-row stage, so a Q6_K group is one warp's and a
//     Q5_K group two warps'; on nibbles a stage is one superblock (256 rows,
//     128 byte rows) and warp w takes its group w, whose dot stays in one
//     thread's registers. Each thread's cp.async copies are fixed chunks of
//     the stage. m = 1 runs one row of x a block, m > 1 eight (kMT).
//   - K is split over a thread-block cluster of P blocks along x: block r
//     of the cluster takes stages [r nst / P, (r + 1) nst / P) of the nst
//     stages, and the cluster adds its P partial tiles through
//     distributed shared memory in rank order, each output element by one
//     thread: runs are bitwise repeatable, a replayed CUDA graph too.
//   - plan() chooses P on the host from the shape alone: the first of 8, 6,
//     4, 3, 2 (up to kMaxP and nst) whose clusters all fit on the card at
//     once (cudaOccupancyMaxActiveClusters, asked per instantiation), else
//     1, so that no partial second wave doubles the time: at N = 4096 and
//     m = 1 P = 8, at N = 32768 P = 1 or 2.
//   - The weight stream is kept in flight: a ring of kStages stages in
//     shared memory, each filled by cp.async (16 bytes a copy, L2 only) with
//     its weights, its sub-scales (and sub-mins) and its superblock row of
//     factors (the grids: its x rows too, zero past m). The loads of stage
//     i + kStages - 1 are issued right after the barrier that opens stage i,
//     before its compute: kStages - 1 stages are in flight a block while it
//     computes (the design's 2: 18-19 KB a block at m = 1, up to four
//     blocks an SM, 22 KB at 8 rows of x; 3 and 4 stages ran 3-6% slower on
//     the grids on an H100, PERF.md).
//   - The int8 grid becomes f32 without a conversion instruction (16 a
//     clock an SM, the stream needs ~15 bytes a clock): each byte, biased
//     by 128, is permuted into the mantissa of 2^23 and 2^23 + 128 is
//     subtracted, exactly.
//   - grid "g": x is rounded to bf16 in place once a stage (after the group
//     sums of the unrounded x, Q5_K), the exact products summed in f32 over
//     a group, the sum multiplied once by s = sd * sub_s; a Q5_K group's
//     second warp hands its sum to the first through shared memory before
//     that multiply. "": each weight dequantized as __fmul_rn(q, s) (then
//     __fadd_rn(., m), Q5_K) and multiplied in f32 (no TF32).
//   - grid "b" (ct_qmm_rb8; PLAIN_S, ct_qmm_rb8_legacy: the stage carries
//     the rows of the f32 planes s and mn, as q8_kernel's does): each weight
//     dequantized as "" does, then rounded once to bf16; x rounded to bf16
//     once a stage. At m = 1 the exact products of the two bf16 operands
//     are summed in f32, as "". At m > 1 (8 rows of x) on tensor cores:
//     mma.sync m16n8k16 with the dequantized weights as A and x as B. A
//     lane (4 g + t) dequantizes 16 columns [16 g, 16 g + 16) x its warp's
//     4 K rows 4 t .. 4 t + 3 (one 16-byte load a row; the stage's 16-byte
//     chunk j of row r lies at j ^ 2 (r / 4 % 4), so that the lanes' loads
//     meet 32 banks), whose bf16 pairs are A's registers as they stand:
//     A's row g of tile j is column 16 g + j, row g + 8 column 16 g + 8 + j,
//     and its K slots 2t, 2t + 1, 2t + 8, 2t + 9 the K rows 4 t .. 4 t + 3,
//     which B (x row g, those K rows, rounded as it is read) takes in the
//     same order. Eight tiles a warp and stage; the tensor core's f32 sums
//     run over the block's whole K range.
//   - Nibbles: the block stages x for its own K range once, in windows of
//     kWinRows (a block's whole range but at the longest K), while the
//     ring's first copies are in flight: "qx" quantizes it (xq, sx, the
//     group sums xs and 8 sum(xq)), "g" rounds it to bf16 (xs of the
//     unrounded x). A nibble stream runs out of instructions before bytes
//     (~30 nibbles a clock an SM against 64 integer operations), so a
//     weight costs few: each word of 4 columns x 2 rows becomes its
//     unsigned nibbles u = w4 + 8 in two words of bytes (a mask and a shift
//     and a mask); "qx" transposes four byte rows' words with 8 byte
//     permutes into K-contiguous words a column and takes dp4a against x
//     (stored as the even rows, then the odd ones, of each 8), the exact
//     dot sum(xq u) - 8 sum(xq); "g" at m = 1 permutes each u into the
//     mantissa of 2^23 and subtracts 2^23 + 8 (no I2F, a quarter-rate
//     conversion). Then one f32 rescale a group, as the first design.
//   - "q" on the grids (q8_kernel): the stage carries its xq rows (int8),
//     sx and (with mins) xsum for its groups, and its scale planes: the
//     factored sub-scales and factor row, or the legacy grids' rows of the
//     f32 s and mn planes. Each thread's 4 x 4 grid bytes (4 columns, 4 K
//     rows) are transposed with 8 byte permutes into K-contiguous words a
//     column and dotted with dp4a against xq's word of those rows, exactly
//     in int32. At group 32 the second warp of a group hands its int32 dot
//     to the first through shared memory (a barrier of the pair), so each
//     group has one whole dot and one f32 rescale, as the first design:
//     (dot * sx) * s, then + xsum * m.
//   - ksplit (ksplit_kernel, modes "", "s" and "b", every layout of
//     ctq::ksplit_layout): the grids' stage of 128 byte rows, warp w's 16
//     byte rows carrying logical rows r of the low half and kp / 2 + r of
//     the high one; the ring carries, besides the bytes, both halves'
//     plane rows (the factored sub-scales and sub-mins of their groups and
//     the factor row of each half's superblock, which differ where a small
//     weight's superblock spans both halves; or the plain f32 s and m
//     rows), each thread's plane copies set up once. x is staged once a
//     block for its range, both halves, in windows of kKsWinRows ("s": the
//     group sums of each half as it is staged). A word of 4 bytes gives 4
//     low nibbles l (a mask) and 4 unsigned high ones f + 8 (a shift, a
//     mask and an xor), each put into the mantissa of 2^23; 2^23 + 8
//     subtracted from the high one, exactly: no I2F (the low one's l * s is
//     one fma of 2^23 + l with s and -2^23 s, rounded once as __fmul_rn
//     rounds it). Each weight is dequantized once, __fmul_rn(v, s) ("":
//     then __fadd_rn(., B)), and multiplied into f32
//     accumulators for every row of x (no TF32); "s" adds each half's
//     xs * B once a group, by the group's first warp (a group of 64 or 128
//     rows spans 4 or 8 warps).
//   - ksplit "b" (ct_qmm_b_ks, ct_qmm_rb_ks): each weight dequantized as ""
//     does, then rounded once to bf16; x rounded to bf16 as it is staged.
//     At m = 1 the exact products of the two bf16 operands are summed in
//     f32, as "". At m > 1 (8 rows of x) on tensor cores, mma.sync m16n8k16
//     as the grids' "b", one k16 tile a half: a warp's 16 byte rows are 16
//     K rows of the low half and the same 16 of the high one, so lane
//     (4 g + t) dequantizes byte rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 (A's
//     K slots as they stand) x 16 columns [16 g, 16 g + 16) once, the low
//     nibbles into one tile against x's low-half rows and the high ones
//     into another against its high-half rows; no MMA mixes the halves,
//     both add into the same f32 sums. x is staged as bf16 pairs, each
//     half's rows apart, rows padded to meet 32 banks; the byte rows'
//     16-byte chunk j of row r lies at j ^ 2 (r / 2 % 4).
//   - "g" at m > 1 (8 rows of x) runs out of f32 pipes (8 products a
//     weight), so it multiplies on tensor cores: mma.sync m16n8k16 with 16
//     columns x 16 K rows of nibbles as A, one adjk byte a register (K rows
//     2r, 2r + 1 of a column: u into the mantissa of 128, minus 136, exact
//     in bf16), x as bf16 pairs for B; two k steps a group, whose f32 sum
//     is multiplied once by s. The products are exact, the tensor core's f32
//     sums of a group are in its own order. The stage's byte rows are
//     swizzled (chunk j of row r at j ^ 2 (r % 4)) so that the A loads and
//     the padded x rows meet 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_wgmma.cuh"

namespace ctsk {

// scripts/torch_qmm_split_ablate.py builds variants of these
constexpr int kStages = 2;  // stages in the ring
constexpr int kMaxP = 8;    // the largest cluster
constexpr int kMT = 8;      // rows of x a block at m > 1
// the nibble kernels' forms: "qx" dp4a on transposed bytes (false: a shift
// pair and a multiply-add a nibble, the first design's), "g" at m = 1 and
// the ksplit kernels the nibble put into the mantissa of 2^23 (false: an
// I2F a nibble), "g" at m > 1 bf16 mma.sync on tensor cores (false: f32
// products, as at m = 1)
constexpr bool kNibbleDp4a = true;
constexpr bool kNibbleMagic = true;
constexpr bool kNibbleMma = true;
// "q" on the grids: dp4a on transposed grid bytes (false: a byte extract and
// a multiply-add a weight and row of x, the first design's form)
constexpr bool kGridDp4a = true;
// "b" on the grids and on ksplit at m > 1: bf16 mma.sync on tensor cores
// (false: f32 products, as at m = 1)
constexpr bool kGridMma = true;
// the ksplit kernels' low nibble: l * s as one fma of 2^23 + l with s and
// -2^23 s (exact: the fma rounds l * s once, as __fmul_rn does, one f32
// operation fewer; false: the subtraction, then the multiply)
constexpr bool kKsLoFma = true;
constexpr int kTN = 128;             // output columns a block
constexpr int kWarps = 8;            // K lanes
constexpr int kThreads = 32 * kWarps;
constexpr int kLR = 16;              // K rows a lane and stage
constexpr int kKR = kWarps * kLR;    // K rows a stage
constexpr int kMaxM = 32;            // the m this design serves
static_assert(kStages >= 2 && kMaxP >= 1 && kMaxP <= 8,
              "a ring of two stages or more, a portable cluster (8 blocks at most)");
// the cluster sizes plan() tries, largest first: 6 and 3 where the card
// holds just too few clusters of 8 or 4 for a shape (the GPCs' SMs are not
// multiples of 4)
constexpr int kPlanParts[] = {8, 6, 4, 3, 2};
static_assert(kMT == 2 || kMT == 4 || kMT == 8, "2, 4 or 8 rows of x a block at m > 1");

// blocks an SM asked of the compiler: three at m = 1 (85 registers a
// thread), two at 8 rows of x (the f32 products take 128)
template <int MT>
constexpr int kMinBlocks = MT >= 8 ? 2 : 3;

// the grid kernel's modes: "" (f32 products of the dequantized weight),
// "g" (exact bf16 products summed over a group, then one rescale), "b" (the
// dequantized weight and x rounded to bf16, f32 sums)
enum GridMode { kGridF, kGridG, kGridB };

// byte offsets of one stage's parts (each a multiple of 16): the factored
// planes' sub-scales, sub-mins and factor rows, or (PLAIN_S) the rows of
// the f32 planes s and mn at kSub and kSubM
template <int MT, int G, bool HAS_MINS, bool PLAIN_S>
struct Stage {
  static constexpr int kGS = kKR / G;                            // groups a stage
  static constexpr int kPlaneRow = PLAIN_S ? 4 * kTN : kTN;      // bytes a row of s (sub_s)
  static constexpr int kW = 0;                                   // int8 [kKR][kTN]
  static constexpr int kX = kW + kKR * kTN;                      // f32 [MT][kKR]
  static constexpr int kSub = kX + MT * kKR * 4;                 // [kGS][kTN]
  static constexpr int kSubM = kSub + kGS * kPlaneRow;           // [kGS][kTN]
  static constexpr int kSd = kSubM + (HAS_MINS ? kGS * kPlaneRow : 0);  // f32 [kTN]
  static constexpr int kSm = kSd + (PLAIN_S ? 0 : 4 * kTN);      // f32 [kTN]
  static constexpr int kBytes = kSm + (HAS_MINS && !PLAIN_S ? 4 * kTN : 0);
};

// "b" at m > 1 on tensor cores
template <int MT, int MODE>
constexpr bool kMmaB = MODE == kGridB && MT == 8 && kGridMma;

// shared memory of a block: the ring, then ("g" on Q5_K) the hand-over of
// a group's second warp and the group sums of x
template <int MT, int MODE, int G, bool HAS_MINS, bool PLAIN_S>
struct Smem {
  static constexpr bool kComb = MODE == kGridG && G > kLR;
  static constexpr bool kBias = MODE == kGridG && HAS_MINS;
  static constexpr int kRing = kStages * Stage<MT, G, HAS_MINS, PLAIN_S>::kBytes;
  static constexpr int kComb0 = kRing;  // f32 [kWarps / 2][MT][kTN]
  static constexpr int kXs0 = kComb0 + (kComb ? kWarps / 2 * MT * kTN * 4 : 0);  // f32 [MT][kKR / G]
  static constexpr int kBytes = kXs0 + (kBias ? MT * (kKR / G) * 4 : 0);
  // after the loop the ring holds the warps' tiles, then the block's
  static_assert((kWarps + 1) * MT * kTN * 4 <= kRing, "the reduction fits in the ring");
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(ctw::smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes, or zeros where `full` is false (nothing is read)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(ctw::smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// u_c - BIAS as an f32, exactly, for byte c of u (u_c < 256): u_c goes into
// the low mantissa byte of 2^23 and 2^23 + BIAS is subtracted (no I2F, a
// quarter-rate conversion). A signed grid byte q is u_c = q + 128 (the word
// XOR 0x80808080, BIAS 128); an adjk nibble w4 = u - 8 (BIAS 8); a ksplit
// low nibble l = lo (BIAS 0) and high one f = hi - 8 (BIAS 8).
template <int BIAS>
__device__ __forceinline__ float mantissa_f32(uint32_t u, int c) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u, 0x7540 + c))),
                   8388608.0f + BIAS);
}

// 2^23 + u_c as an f32 (mantissa_f32 before its subtraction)
__device__ __forceinline__ float mantissa_raw(uint32_t u, int c) {
  return __int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u, 0x7540 + c)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The end of both kernels: each thread's sums of its outputs over its warp's
// K rows, written by store(red) into red[warp][row of x][column], are added
// over the block's warps in warp order, then over the cluster's blocks in
// rank order through distributed shared memory, each output element by one
// thread; the ring (smem) holds the tiles.
template <int MT, class Store>
__device__ __forceinline__ void reduce_tile(const Store& store, uint8_t* smem,
                                            float* __restrict__ out, int m, int np, int n0,
                                            int t0, uint32_t rank, int parts) {
  const int tid = threadIdx.x;
  cp_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MT][kTN]
  float* blk = red + kWarps * MT * kTN;         // [MT][kTN]
  store(red);
  __syncthreads();
  for (int e = tid; e < MT * kTN; e += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int l = 0; l < kWarps; ++l) v = __fadd_rn(v, red[l * MT * kTN + e]);
    blk[e] = v;
  }
  ctw::cluster_sync();  // every block's tile written
  // block `rank` adds its share of the tile's float4s over the cluster
  constexpr int kE4 = MT * kTN / 4;
  for (int e = static_cast<int>(rank) * kE4 / parts + tid;
       e < (static_cast<int>(rank) + 1) * kE4 / parts; e += kThreads) {
    const uint32_t local = ctw::smem_addr(blk + 4 * e);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < parts; ++q) {
      const float4 v = ctw::ld_cluster(local, static_cast<uint32_t>(q));
      sum.x = __fadd_rn(sum.x, v.x);
      sum.y = __fadd_rn(sum.y, v.y);
      sum.z = __fadd_rn(sum.z, v.z);
      sum.w = __fadd_rn(sum.w, v.w);
    }
    const int t = t0 + 4 * e / kTN;
    if (t < m) *reinterpret_cast<float4*>(out + (size_t)t * np + n0 + 4 * e % kTN) = sum;
  }
  ctw::cluster_sync();  // no block leaves while another reads its tile
}

// reduce_tile of acc[i][c], the sums of output (t0 + i, n0 + 4 lane + c)
template <int MT>
__device__ __forceinline__ void reduce_out(const float (&acc)[MT][4], uint8_t* smem,
                                           float* __restrict__ out, int m, int np, int n0,
                                           int t0, uint32_t rank, int parts) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  reduce_tile<MT>(
      [&](float* red) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          *reinterpret_cast<float4*>(red + (w * MT + i) * kTN + 4 * lane) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      },
      smem, out, m, np, n0, t0, rank, parts);
}

// d += A B on tensor cores: A 16 x 16 bf16 (rows g and g + 8 of lane 4 g + t:
// a0, a1 K 2t, 2t + 1; a2, a3 K 2t + 8, 2t + 9), B 16 x 8 bf16 (column g:
// b0 K 2t, 2t + 1; b1 K 2t + 8, 2t + 9), d f32 (rows g, g + 8 x columns
// 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// reduce_tile of the tensor cores' sums: dm[j], tile j of the lane
// (4 g + t), holds output columns 16 g + j (d[0], d[1]) and 16 g + 8 + j
// (d[2], d[3]) x rows 2 t (d[0], d[2]) and 2 t + 1 of x
template <int MT>
__device__ __forceinline__ void reduce_mma(const float (&dm)[8][4], uint8_t* smem,
                                           float* __restrict__ out, int m, int np, int n0,
                                           int t0, uint32_t rank, int parts) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  reduce_tile<MT>(
      [&](float* red) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows 2 t + r of x
          float* d = red + (w * MT + 2 * t + r) * kTN + 16 * g;
#pragma unroll
          for (int e = 0; e < 2; ++e)  // columns 16 g + 8 e + j
#pragma unroll
            for (int j4 = 0; j4 < 8; j4 += 4)
              *reinterpret_cast<float4*>(d + 8 * e + j4) =
                  make_float4(dm[j4][2 * e + r], dm[j4 + 1][2 * e + r], dm[j4 + 2][2 * e + r],
                              dm[j4 + 3][2 * e + r]);
        }
      },
      smem, out, m, np, n0, t0, rank, parts);
}

// The group's scale (and min) of NC columns [col0, col0 + NC) of stage b,
// group gs: s = sd * sub_s and m = sm * sub_m (each an f32 product rounded
// once, as the reference's _apply_factors), or the plain f32 rows (PLAIN_S)
template <int NC, class St, bool HAS_MINS, bool PLAIN_S>
__device__ __forceinline__ void group_scales(const uint8_t* b, int gs, int col0, float (&s)[NC],
                                             float (&mn)[NC]) {
#pragma unroll
  for (int c4 = 0; c4 < NC; c4 += 4) {
    if constexpr (PLAIN_S) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(b + St::kSub + gs * St::kPlaneRow + 4 * (col0 + c4));
      s[c4] = s4.x, s[c4 + 1] = s4.y, s[c4 + 2] = s4.z, s[c4 + 3] = s4.w;
      if (HAS_MINS) {
        const float4 m4 = *reinterpret_cast<const float4*>(b + St::kSubM + gs * St::kPlaneRow +
                                                           4 * (col0 + c4));
        mn[c4] = m4.x, mn[c4 + 1] = m4.y, mn[c4 + 2] = m4.z, mn[c4 + 3] = m4.w;
      }
    } else {
      const uint32_t sw =
          *reinterpret_cast<const uint32_t*>(b + St::kSub + gs * kTN + col0 + c4);
      const float4 d4 = *reinterpret_cast<const float4*>(b + St::kSd + 4 * (col0 + c4));
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[c4 + c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
      if (HAS_MINS) {
        const uint32_t mw =
            *reinterpret_cast<const uint32_t*>(b + St::kSubM + gs * kTN + col0 + c4);
        const float4 m4 = *reinterpret_cast<const float4*>(b + St::kSm + 4 * (col0 + c4));
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mn[c4 + c] = __fmul_rn(mv[c], static_cast<float>(ctq::sbyte(mw, c)));
      }
    }
  }
}

// the bf16 pair (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// MT: rows of x a block (1, or kMT at m > 1); MODE: "", "g" or "b"
// (GridMode); G: 16 (Q6_K, no mins) or 32 (Q5_K, mins; the legacy grids
// with or without); PLAIN_S ("b" only): the f32 planes s and mn (passed as
// sd and sm, no sub-planes) instead of the factored ones. Grid
// (np / kTN * parts, ceil(m / MT)) in clusters of `parts` along x.
template <int MT, int MODE, int G, bool HAS_MINS, bool PLAIN_S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>)
splitk_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
              const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
              const float* __restrict__ sd, const float* __restrict__ sm,
              float* __restrict__ out, int m, int kp, int np, int parts) {
  using St = Stage<MT, G, HAS_MINS, PLAIN_S>;
  using Sm = Smem<MT, MODE, G, HAS_MINS, PLAIN_S>;
  constexpr bool kG8 = MODE == kGridG, kMma = kMmaB<MT, MODE>;
  static_assert(G == kLR || G == 2 * kLR, "a group is one K lane or two");
  static_assert(kKR % G == 0 && ctq::kSuperblock % kKR == 0, "a stage holds whole groups "
                "and lies in one superblock");
  static_assert(!PLAIN_S || (MODE == kGridB && G == 2 * kLR),
                "plain planes: the legacy grids' \"b\" at group 32");
  extern __shared__ __align__(16) uint8_t smem[];
  float* comb = reinterpret_cast<float*>(smem + Sm::kComb0);
  float* xs = reinterpret_cast<float*>(smem + Sm::kXs0);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t rank = ctw::cluster_rank();
  const int n0 = static_cast<int>(blockIdx.x) / parts * kTN;
  const int t0 = blockIdx.y * MT;
  const int nst = kp / kKR;
  const int s0 = static_cast<int>(rank) * nst / parts;
  const int n_it = (static_cast<int>(rank) + 1) * nst / parts - s0;

  // ---- stage it of this block's range into ring slot it % kStages ----
  // Each thread's copies are fixed: 16-byte chunks tid + u * kThreads of the
  // weight tile (row tid / 8 + u * kThreads / 8, chunk tid % 8; on tensor
  // cores at chunk tid % 8 ^ 2 (row / 4 % 4)), chunk tid of x's rows, of the
  // sub-scale rows, or of the factor row; PLAIN_S: chunk tid of the s rows
  // (the first kPChunks threads) and of the mn rows (the last kPChunks).
  static_assert(kKR * kTN / 16 == 4 * kThreads, "four weight chunks a thread");
  constexpr int kXChunks = MT * kKR / 4, kSubChunks = St::kGS * kTN / 16;
  constexpr int kPChunks = St::kGS * kTN / 4;
  constexpr int kSdThread = kThreads - kTN / 4;  // the last warp copies the factors
  static_assert(kXChunks <= kThreads && kSubChunks <= kSdThread &&
                (!PLAIN_S || 2 * kPChunks <= kThreads), "one chunk a thread");
  const int8_t* wsrc = qs + (size_t)(s0 * kKR + tid / 8) * np + n0 + 16 * (tid % 8);
  const size_t wstep = (size_t)kThreads / 8 * np;  // rows between a thread's chunks
  const int wswz = kMma ? 16 * ((tid % 8 ^ 2 * (tid / 32 % 4)) - tid % 8) : 0;
  const bool xlive = tid < kXChunks && t0 + tid / (kKR / 4) < m;
  const float* xsrc = x + (size_t)(xlive ? t0 + tid / (kKR / 4) : 0) * kp + s0 * kKR +
                      4 * (tid % (kKR / 4));
  const size_t ssrc = (size_t)(s0 * St::kGS + tid / 8) * np + n0 + 16 * (tid % 8);
  const int pc = tid < kPChunks ? tid : tid - (kThreads - kPChunks);  // PLAIN_S
  const size_t psrc = (size_t)(s0 * St::kGS + pc / (kTN / 4)) * np + n0 + 4 * (pc % (kTN / 4));
  auto load = [&](int it) {
    uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int8_t* wp = wsrc + (size_t)it * kKR * np;
#pragma unroll
    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads) + wswz, wp + u * wstep);
    if (tid < kXChunks) cp16z(b + St::kX + 16 * tid, xsrc + it * kKR, xlive);
    if constexpr (PLAIN_S) {
      const size_t o = psrc + (size_t)it * St::kGS * np;
      if (tid < kPChunks) cp16(b + St::kSub + 16 * tid, sd + o);
      else if (HAS_MINS && tid >= kThreads - kPChunks) cp16(b + St::kSubM + 16 * pc, sm + o);
    } else if (tid < kSubChunks) {
      const size_t o = ssrc + (size_t)it * St::kGS * np;
      cp16(b + St::kSub + 16 * tid, sub_s + o);
      if (HAS_MINS) cp16(b + St::kSubM + 16 * tid, sub_m + o);
    } else if (tid >= kSdThread) {  // a stage lies in one superblock
      const size_t o = (size_t)((s0 + it) * kKR / ctq::kSuperblock) * np + n0 +
                       4 * (tid - kSdThread);
      cp16(b + St::kSd + 16 * (tid - kSdThread), sd + o);
      if (HAS_MINS) cp16(b + St::kSm + 16 * (tid - kSdThread), sm + o);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  // tensor cores: tile j's sums, columns 16 g + j (d[0], d[1]) and
  // 16 g + 8 + j (d[2], d[3]) x rows 2 t (d[0], d[2]) and 2 t + 1 of x
  float dm[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dm[j][c] = 0.0f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_it) load(it);
    cp_commit();
  }
  const int r0 = w * kLR;  // this lane's first row in a stage
  const int gs = r0 / G;   // its group in the stage
  for (int it = 0; it < n_it; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; slot (it - 1) % kStages is free
    if (it + kStages - 1 < n_it) load(it + kStages - 1);
    cp_commit();
    const uint8_t* b = smem + (it % kStages) * St::kBytes;
    float* xb = reinterpret_cast<float*>(const_cast<uint8_t*>(b) + St::kX);
    if constexpr (MODE != kGridF && !kMma) {
      // x rounded to bf16 in place; "g" with mins first the group sums of
      // the unrounded x, over the G / 4 neighbouring threads of a group
      // (whole warps: kXChunks is a multiple of 32)
      if (tid < kXChunks) {
        const int c = tid;
        float4 v = reinterpret_cast<float4*>(xb)[c];
        if (Sm::kBias) {
          float s = __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
#pragma unroll
          for (int off = 1; off < G / 4; off <<= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
          if (c % (G / 4) == 0) xs[c / (G / 4)] = s;  // [i][group]
        }
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
        v.z = bf16_round(v.z);
        v.w = bf16_round(v.w);
        reinterpret_cast<float4*>(xb)[c] = v;
      }
      __syncthreads();
    }

    if constexpr (kMma) {
      // ---- "b" on tensor cores: the lane's 16 columns x 4 K rows ----
      const int g = lane >> 2, t = lane & 3;
      float s[16], mn[16];
      group_scales<16, St, HAS_MINS, PLAIN_S>(b, gs, 16 * g, s, mn);
      // B: x row g at K rows 4 t .. 4 t + 3, rounded to bf16 pairs
      const float4 x4 = *reinterpret_cast<const float4*>(xb + g * kKR + r0 + 4 * t);
      const uint32_t b0 = bf16x2(x4.x, x4.y), b1 = bf16x2(x4.z, x4.w);
      uint4 wq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wq[q] = *reinterpret_cast<const uint4*>(b + St::kW + (r0 + 4 * t + q) * kTN +
                                                16 * (g ^ 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // words h (columns 16 g + 4 h + c: tiles 4 h + c, A row g) and 2 + h
        // (columns 16 g + 8 + 4 h + c: the same tiles, A row g + 8)
        float wl[4][4], wh[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t lo = (h ? wq[q].y : wq[q].x) ^ 0x80808080u;
          const uint32_t hi = (h ? wq[q].w : wq[q].z) ^ 0x80808080u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // q * s (+ m), rounded as the reference's f32 multiply and add
            wl[q][c] = __fmul_rn(mantissa_f32<128>(lo, c), s[4 * h + c]);
            wh[q][c] = __fmul_rn(mantissa_f32<128>(hi, c), s[8 + 4 * h + c]);
            if (HAS_MINS) {
              wl[q][c] = __fadd_rn(wl[q][c], mn[4 * h + c]);
              wh[q][c] = __fadd_rn(wh[q][c], mn[8 + 4 * h + c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mma_bf16(dm[4 * h + c], bf16x2(wl[0][c], wl[1][c]), bf16x2(wh[0][c], wh[1][c]),
                   bf16x2(wl[2][c], wl[3][c]), bf16x2(wh[2][c], wh[3][c]), b0, b1);
      }
    } else {
      // the group's scale (and min) for this thread's 4 columns
      float s[4], mn[4];
      group_scales<4, St, HAS_MINS, PLAIN_S>(b, gs, 4 * lane, s, mn);

      // ---- the lane's 16 rows, four at a time ----
      float part[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
#pragma unroll
      for (int rr = 0; rr < kLR; rr += 4) {
        float wv[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t wd =
              *reinterpret_cast<const uint32_t*>(b + St::kW + (r0 + rr + q) * kTN + 4 * lane) ^
              0x80808080u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wv[q][c] = mantissa_f32<128>(wd, c);
            if (!kG8) {  // q * s (+ m), rounded as the reference's f32 multiply and add
              wv[q][c] = __fmul_rn(wv[q][c], s[c]);
              if (HAS_MINS) wv[q][c] = __fadd_rn(wv[q][c], mn[c]);
              if (MODE == kGridB) wv[q][c] = bf16_round(wv[q][c]);  // then once to bf16
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 x4 = *reinterpret_cast<const float4*>(xb + i * kKR + r0 + rr);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (kG8)
                part[i][c] = fmaf(xv[q], wv[q][c], part[i][c]);
              else
                acc[i][c] = fmaf(xv[q], wv[q][c], acc[i][c]);
            }
        }
      }

      if constexpr (kG8) {
        if constexpr (Sm::kComb) {
          // a group's second warp hands its partial sum to the first
          float* cb = comb + (w / 2) * MT * kTN + 4 * lane;
          if (w & 1) {
#pragma unroll
            for (int i = 0; i < MT; ++i)
              *reinterpret_cast<float4*>(cb + i * kTN) =
                  make_float4(part[i][0], part[i][1], part[i][2], part[i][3]);
          }
          __syncthreads();
          if (!(w & 1)) {
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const float4 o = *reinterpret_cast<const float4*>(cb + i * kTN);
              part[i][0] = __fadd_rn(part[i][0], o.x);
              part[i][1] = __fadd_rn(part[i][1], o.y);
              part[i][2] = __fadd_rn(part[i][2], o.z);
              part[i][3] = __fadd_rn(part[i][3], o.w);
            }
          }
        }
        if (!Sm::kComb || !(w & 1)) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xsv = Sm::kBias ? xs[i * (kKR / G) + gs] : 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float v = __fmul_rn(part[i][c], s[c]);
              if (Sm::kBias) v = __fadd_rn(v, __fmul_rn(xsv, mn[c]));
              acc[i][c] = __fadd_rn(acc[i][c], v);
            }
          }
        }
      }
    }
  }

  if constexpr (kMma)
    reduce_mma<MT>(dm, smem, out, m, np, n0, t0, rank, parts);
  else
    reduce_out<MT>(acc, smem, out, m, np, n0, t0, rank, parts);
}

// The loop of a kernel that stages its block's x once, in windows of
// kWinStages stages (the nibble and ksplit families): the ring's first
// kStages - 1 loads; then per window stage_x(it0, nw), x of stages [it0,
// it0 + nw) of the block's range while the ring's copies are in flight;
// then per stage it, the jw-th of its window, the barrier that opens it,
// the loads of stage it + kStages - 1 and body(it, jw).
template <int kWinStages, class Load, class StageX, class Body>
__device__ __forceinline__ void ring_windows(int n_it, const Load& load, const StageX& stage_x,
                                             const Body& body) {
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_it) load(it);
    cp_commit();
  }
  for (int it0 = 0; it0 < n_it; it0 += kWinStages) {
    const int nw = min(kWinStages, n_it - it0);
    if (it0 > 0) __syncthreads();  // every warp is done with the last window's x
    stage_x(it0, nw);
    for (int it = it0; it < it0 + nw; ++it) {
      cp_wait<kStages - 2>();
      __syncthreads();  // stage it and the window's x have landed; slot (it - 1) % kStages is free
      if (it + kStages - 1 < n_it) load(it + kStages - 1);
      cp_commit();
      body(it, it - it0);
    }
  }
}

// ---- Q4_K adjk nibbles: ct_qmm_qx (QX) and ct_qmm_g ----
constexpr int kNRows = ctq::kSuperblock;         // K rows a stage: one superblock
constexpr int kNGroups = kNRows / ctq::kGroup;   // its groups: warp w takes group w
static_assert(kNGroups == kWarps, "a warp a group of 32 rows");

// byte offsets of one nibble stage's parts (each a multiple of 16)
struct NStage {
  static constexpr int kW = 0;                          // int8 [kNRows / 2][kTN] byte rows
  static constexpr int kSub = kW + kNRows / 2 * kTN;    // int8 [kNGroups][kTN]
  static constexpr int kSubM = kSub + kNGroups * kTN;   // int8 [kNGroups][kTN]
  static constexpr int kSd = kSubM + kNGroups * kTN;    // f32 [kTN]
  static constexpr int kSm = kSd + 4 * kTN;             // f32 [kTN]
  static constexpr int kBytes = kSm + 4 * kTN;
};

// "g" at m > 1 on tensor cores: mma.sync m16n8k16, 16 columns x 16 K rows
// of nibbles as A (the adjk byte holds the pair of K rows that a register
// of the A fragment holds), the 8 rows of x (kMT) as B
template <int MT, bool QX>
constexpr bool kMmaG = !QX && MT == 8 && kNibbleMma;

// K rows of x a block stages at once (a window): all of a block's range
// but at the longest K (qx: int8, g: f32, g on tensor cores: bf16)
template <int MT, bool QX>
constexpr int kWinRows = QX ? (MT == 1 ? 8192 : 4096)
                            : (kMmaG<MT, QX> ? 2048 : (MT == 1 ? 4096 : 1024));

// shared memory of a nibble block: the ring, then the window's x
template <int MT, bool QX>
struct NSmem {
  static constexpr bool kMma = kMmaG<MT, QX>;
  static constexpr int kW = kWinRows<MT, QX>;
  static constexpr int kG = kW / ctq::kGroup;
  static constexpr int kRing = kStages * NStage::kBytes;
  // words a row of bf16 pairs (tensor cores), padded so that the lanes' B
  // fragments meet 32 banks
  static constexpr int kXStride = kW / 2 + 4;
  // qx: int8 [MT][kW], each 8 rows as the 4 even rows, then the 4 odd ones
  // (the dp4a words of 4 byte rows); g: f32 [MT][kW], rounded to bf16; g
  // on tensor cores: bf16 pairs [MT][kXStride]
  static constexpr int kX0 = kRing;
  // qx: f32 [MT][kG] sx
  static constexpr int kSx0 = kX0 + (QX ? MT * kW : kMma ? MT * kXStride * 4 : MT * kW * 4);
  static constexpr int kXs0 = kSx0 + (QX ? MT * kG * 4 : 0);  // f32 [MT][kG] group sums of x
  static constexpr int kXc0 = kXs0 + MT * kG * 4;             // qx: int [MT][kG] 8 * sum(xq)
  // g on tensor cores: f32 [kWarps][2][kTN], each warp's group's s and B
  static constexpr int kSc0 = kXc0 + (QX ? MT * kG * 4 : 0);
  static constexpr int kBytes = kSc0 + (kMma ? kWarps * 2 * kTN * 4 : 0);
  static_assert(kW % kNRows == 0, "a window holds whole stages");
  static_assert((kWarps + 1) * MT * kTN * 4 <= kRing, "the reduction fits in the ring");
};

// t[c] = byte c of a[0], a[1], a[2], a[3]: a 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t (&t)[4]) {
  const uint32_t p01 = __byte_perm(a[0], a[1], 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const uint32_t q01 = __byte_perm(a[0], a[1], 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const uint32_t p23 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t q23 = __byte_perm(a[2], a[3], 0x7362);
  t[0] = __byte_perm(p01, p23, 0x5410);
  t[1] = __byte_perm(p01, p23, 0x7632);
  t[2] = __byte_perm(q01, q23, 0x5410);
  t[3] = __byte_perm(q01, q23, 0x7632);
}

// the unsigned nibbles u = w4 + 8 of a word of byte rows: the low ones
// (rows 2r) in `lo`, the high ones (rows 2r + 1) in `hi`, one a byte
__device__ __forceinline__ void unsigned_nibbles(uint32_t w, uint32_t* lo, uint32_t* hi) {
  *lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  *hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// the bf16 pair w4 of K rows 2r, 2r + 1 of byte c of w (low half first),
// exactly: each unsigned nibble u into the low mantissa of 128, then
// 128 + 8 subtracted
__device__ __forceinline__ uint32_t nibble_bf16x2(uint32_t w, int c) {
  const uint32_t v = (__byte_perm(w, w >> 4, c | (4 + c) << 8) & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// MT: rows of x a block (1, or kMT at m > 1); QX: mode "qx" (x quantized to
// int8 per group, exact int32 group dots), else "g" (x rounded to bf16,
// exact products summed in f32 over a group). Grid (np / kTN * parts,
// ceil(m / MT)) in clusters of `parts` along x.
template <int MT, bool QX>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>)
nibble_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
              const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
              const float* __restrict__ sd, const float* __restrict__ sm,
              float* __restrict__ out, int m, int kp, int np, int parts) {
  using St = NStage;
  using Sm = NSmem<MT, QX>;
  constexpr int kW = Sm::kW, kG = Sm::kG;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem + Sm::kX0);
  float* xf = reinterpret_cast<float*>(smem + Sm::kX0);
  float* sx = reinterpret_cast<float*>(smem + Sm::kSx0);
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + Sm::kX0);
  float* xs = reinterpret_cast<float*>(smem + Sm::kXs0);
  int* xc = reinterpret_cast<int*>(smem + Sm::kXc0);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t rank = ctw::cluster_rank();
  const int n0 = static_cast<int>(blockIdx.x) / parts * kTN;
  const int t0 = blockIdx.y * MT;
  const int nst = kp / kNRows;
  const int s0 = static_cast<int>(rank) * nst / parts;
  const int n_it = (static_cast<int>(rank) + 1) * nst / parts - s0;

  // ---- stage it of this block's range into ring slot it % kStages ----
  // Each thread's copies are fixed: 16-byte chunks tid + u * kThreads of the
  // 128 byte rows (row tid / 8 + u * kThreads / 8, chunk tid % 8), chunk tid
  // of the sub-scale and sub-min rows, or of the factor rows. On tensor
  // cores chunk j of byte row r lies at j ^ 2 (r % 4), so that the A
  // fragments' loads meet 32 banks.
  static_assert(kNRows / 2 * kTN / 16 == 4 * kThreads, "four weight chunks a thread");
  constexpr int kSubChunks = kNGroups * kTN / 16;
  constexpr int kSdThread = kThreads - kTN / 4;  // the last warp copies the factors
  static_assert(kSubChunks <= kSdThread, "one chunk a thread");
  const int8_t* wsrc = qs + (size_t)(s0 * kNRows / 2 + tid / 8) * np + n0 + 16 * (tid % 8);
  const size_t wstep = (size_t)kThreads / 8 * np;  // rows between a thread's chunks
  const size_t ssrc = (size_t)(s0 * kNGroups + tid / 8) * np + n0 + 16 * (tid % 8);
  const int wswz = Sm::kMma ? 16 * ((tid % 8 ^ 2 * (tid / 8 % 4)) - tid % 8) : 0;
  auto load = [&](int it) {
    uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int8_t* wp = wsrc + (size_t)it * (kNRows / 2) * np;
#pragma unroll
    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads) + wswz, wp + u * wstep);
    if (tid < kSubChunks) {
      const size_t o = ssrc + (size_t)it * kNGroups * np;
      cp16(b + St::kSub + 16 * tid, sub_s + o);
      cp16(b + St::kSubM + 16 * tid, sub_m + o);
    } else if (tid >= kSdThread) {  // a stage is one superblock
      const size_t o = (size_t)(s0 + it) * np + n0 + 4 * (tid - kSdThread);
      cp16(b + St::kSd + 16 * (tid - kSdThread), sd + o);
      cp16(b + St::kSm + 16 * (tid - kSdThread), sm + o);
    }
  };

  // ---- x rows [k0, k0 + rows) of the block's tokens, staged once ----
  // A thread takes 8 rows of one token, 4 neighbouring threads a group (a
  // warp's items are whole groups of one token: rows is a multiple of 256):
  // the group sums xs of x, and qx quantizes (sx = absmax / 127, xq, and
  // 8 * sum(xq)), g rounds to bf16.
  auto stage_x = [&](int k0, int rows) {
    const int per = rows / 8;
    for (int e = tid; e < MT * per; e += kThreads) {
      const int i = e / per, c8 = e % per;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), z = a;
      if (t0 + i < m) {
        const float4* src = reinterpret_cast<const float4*>(x + (size_t)(t0 + i) * kp + k0 + 8 * c8);
        a = __ldg(src);
        z = __ldg(src + 1);
      }
      const float v[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
      float s = __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                          __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
      const int g = i * kG + c8 / 4;
      if constexpr (QX) {
        float amax = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        const float sxv = __fdiv_rn(amax, 127.0f);
        const float den = fmaxf(sxv, 1e-20f);
        uint32_t q[8];
        int qsum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qj = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[j], den)), -127.f), 127.f));
          qsum += qj;
          q[j] = static_cast<uint32_t>(qj) & 0xFFu;
        }
        qsum += __shfl_xor_sync(0xffffffffu, qsum, 1);
        qsum += __shfl_xor_sync(0xffffffffu, qsum, 2);
        *reinterpret_cast<uint2*>(xq + i * kW + 8 * c8) =
            make_uint2(q[0] | q[2] << 8 | q[4] << 16 | q[6] << 24,
                       q[1] | q[3] << 8 | q[5] << 16 | q[7] << 24);
        if (c8 % 4 == 0) {
          sx[g] = sxv;
          xs[g] = s;
          xc[g] = 8 * qsum;
        }
      } else if constexpr (Sm::kMma) {
        uint32_t pr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
          pr[j] = *reinterpret_cast<const uint32_t*>(&h);
        }
        *reinterpret_cast<uint4*>(xb + i * Sm::kXStride + 4 * c8) =
            make_uint4(pr[0], pr[1], pr[2], pr[3]);
        if (c8 % 4 == 0) xs[g] = s;
      } else {
        float* d = xf + i * kW + 8 * c8;
        reinterpret_cast<float4*>(d)[0] =
            make_float4(bf16_round(v[0]), bf16_round(v[1]), bf16_round(v[2]), bf16_round(v[3]));
        reinterpret_cast<float4*>(d)[1] =
            make_float4(bf16_round(v[4]), bf16_round(v[5]), bf16_round(v[6]), bf16_round(v[7]));
        if (c8 % 4 == 0) xs[g] = s;
      }
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  ring_windows<kW / kNRows>(n_it, load, [&](int it0, int nw) {
    stage_x((s0 + it0) * kNRows, nw * kNRows);
  }, [&](int it, int jw) {
    const uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int gx = jw * kNGroups + w;  // this warp's group in the window

    // the group's scale s and bias B = 8 s + m for this thread's 4 columns
    float s[4], bias[4];
    {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(b + St::kSub + w * kTN + 4 * lane);
      const uint32_t mw = *reinterpret_cast<const uint32_t*>(b + St::kSubM + w * kTN + 4 * lane);
      const float4 d4 = *reinterpret_cast<const float4*>(b + St::kSd + 16 * lane);
      const float4 m4 = *reinterpret_cast<const float4*>(b + St::kSm + 16 * lane);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w}, mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ctq::group_scale(dv[c], ctq::sbyte(sw, c), mv[c], ctq::sbyte(mw, c), &s[c], &bias[c]);
    }
    // byte row j of the group (K rows 2 j and 2 j + 1) for this thread's columns
    const uint8_t* wb = b + St::kW + 16 * w * kTN + 4 * lane;

    if constexpr (QX) {
      // ---- the group's exact int32 dots, four byte rows at a time ----
      int dot[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) dot[i][c] = 0;
      const int8_t* xg = xq + gx * ctq::kGroup;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t wv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          wv[jj] = *reinterpret_cast<const uint32_t*>(wb + (4 * q + jj) * kTN);
        if constexpr (kNibbleDp4a) {
          // dp4a on the unsigned nibbles made K-contiguous a column:
          // sum(xq * u) - 8 sum(xq) = sum(xq * w4), exactly
          uint32_t lo[4], hi[4], tl[4], th[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) unsigned_nibbles(wv[jj], &lo[jj], &hi[jj]);
          transpose4(lo, tl);
          transpose4(hi, th);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint2 xw = *reinterpret_cast<const uint2*>(xg + i * kW + 8 * q);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dot[i][c] = __dp4a(static_cast<int>(th[c]), static_cast<int>(xw.y),
                                 __dp4a(static_cast<int>(tl[c]), static_cast<int>(xw.x),
                                        dot[i][c]));
          }
        } else {
          // the first design's form: each signed nibble shifted out, one
          // multiply-add a nibble and token
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const uint2 xw = *reinterpret_cast<const uint2*>(xg + i * kW + 8 * q);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int x0 = ctq::sbyte(xw.x, jj), x1 = ctq::sbyte(xw.y, jj);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                dot[i][c] += ctq::nibble(wv[jj], 2 * c) * x0 + ctq::nibble(wv[jj], 2 * c + 1) * x1;
            }
          }
        }
      }
      // ---- one f32 rescale of the group's dots ----
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float sxv = sx[i * kG + gx], xsv = xs[i * kG + gx];
        const int xcv = kNibbleDp4a ? xc[i * kG + gx] : 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float part = __fmul_rn(__fmul_rn(static_cast<float>(dot[i][c] - xcv), sxv), s[c]);
          acc[i][c] = __fadd_rn(acc[i][c], __fadd_rn(part, __fmul_rn(xsv, bias[c])));
        }
      }
    } else if constexpr (Sm::kMma) {
      // ---- the group's f32 sums of exact products on tensor cores ----
      // Tile (q, h) takes columns 32 q + 4 g + 2 h (row g of lane 4 g + t)
      // and 32 q + 4 g + 2 h + 1 (row g + 8), two k steps of 16 rows: its
      // sums land in acc[2 q + h] as the mma's d (this warp's group's
      // products in part, then scaled once into acc).
      static_assert(MT == 8, "the rows of x are the mma's 8 columns");
      const int g = lane >> 2, t = lane & 3;
      float* sc = reinterpret_cast<float*>(smem + Sm::kSc0) + w * 2 * kTN;
      *reinterpret_cast<float4*>(sc + 4 * lane) = make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(sc + kTN + 4 * lane) =
          make_float4(bias[0], bias[1], bias[2], bias[3]);
      float part[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
      // byte rows 16 w + 8 k + t and + 4 of this lane, and its x pairs
      const uint8_t* wr = b + St::kW + (16 * w + t) * kTN;
      const uint32_t* xr = xb + g * Sm::kXStride + gx * (ctq::kGroup / 2) + t;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t b0 = xr[8 * k], b1 = xr[8 * k + 4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = 16 * ((2 * q + (g >> 2)) ^ (2 * t)) + 4 * (g & 3);
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + 8 * k * kTN + off);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + (8 * k + 4) * kTN + off);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mma_bf16(part[2 * q + h], nibble_bf16x2(w0, 2 * h), nibble_bf16x2(w0, 2 * h + 1),
                     nibble_bf16x2(w1, 2 * h), nibble_bf16x2(w1, 2 * h + 1), b0, b1);
        }
      }
      __syncwarp();  // the warp's s and B are written
      const float xs0 = xs[2 * t * kG + gx], xs1 = xs[(2 * t + 1) * kG + gx];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 s4 = *reinterpret_cast<const float4*>(sc + 32 * q + 4 * g);
        const float4 b4 = *reinterpret_cast<const float4*>(sc + kTN + 32 * q + 4 * g);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * h + (e >> 1);  // the column's place in 4 g .. 4 g + 3
            float v = __fmul_rn(part[2 * q + h][e], sv[c]);
            v = __fadd_rn(v, __fmul_rn(e & 1 ? xs1 : xs0, bv[c]));
            acc[2 * q + h][e] = __fadd_rn(acc[2 * q + h][e], v);
          }
      }
    } else {
      // ---- the group's f32 sums of exact products, two byte rows at a time ----
      float part[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
      const float* xg = xf + gx * ctq::kGroup;
#pragma unroll
      for (int j = 0; j < ctq::kGroup / 2; j += 2) {
        float wl[2][4], wh[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const uint32_t wv = *reinterpret_cast<const uint32_t*>(wb + (j + jj) * kTN);
          if constexpr (kNibbleMagic) {
            uint32_t lo, hi;
            unsigned_nibbles(wv, &lo, &hi);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              wl[jj][c] = mantissa_f32<8>(lo, c);
              wh[jj][c] = mantissa_f32<8>(hi, c);
            }
          } else {  // the first design's form: one I2F a nibble
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              wl[jj][c] = static_cast<float>(ctq::nibble(wv, 2 * c));
              wh[jj][c] = static_cast<float>(ctq::nibble(wv, 2 * c + 1));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 x4 = *reinterpret_cast<const float4*>(xg + i * kW + 2 * j);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            part[i][c] = fmaf(x4.x, wl[0][c], part[i][c]);
            part[i][c] = fmaf(x4.y, wh[0][c], part[i][c]);
            part[i][c] = fmaf(x4.z, wl[1][c], part[i][c]);
            part[i][c] = fmaf(x4.w, wh[1][c], part[i][c]);
          }
        }
      }
      // ---- one multiply by s a group, then the bias through the group sums ----
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xsv = xs[i * kG + gx];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = __fmul_rn(part[i][c], s[c]);
          v = __fadd_rn(v, __fmul_rn(xsv, bias[c]));
          acc[i][c] = __fadd_rn(acc[i][c], v);
        }
      }
    }
  });

  if constexpr (Sm::kMma) {
    // acc[2 q + h][e]: row 2 t + (e & 1) of x, column 32 q + 4 g + 2 h + (e >> 1)
    const int g = lane >> 2, t = lane & 3;
    reduce_tile<MT>(
        [&](float* red) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float4*>(red + (w * MT + 2 * t + e) * kTN + 32 * q + 4 * g) =
                  make_float4(acc[2 * q][e], acc[2 * q][e + 2], acc[2 * q + 1][e],
                              acc[2 * q + 1][e + 2]);
        },
        smem, out, m, np, n0, t0, rank, parts);
  } else {
    reduce_out<MT>(acc, smem, out, m, np, n0, t0, rank, parts);
  }
}

// ---- ksplit nibbles: ct_qmm_f_ks (""), ct_qmm_s_ks ("s"), ct_qmm_b_ks and
// ct_qmm_rb_ks ("b") ----

// the modes of the ksplit family: "" (each weight dequantized with its
// bias, w = v s + B), "s" (w = v s, the biases through the group sums of
// x, once a group and half) and "b" (w = v s + B rounded to bf16, x rounded
// to bf16)
enum KsMode { kKsF, kKsS, kKsB };

// byte offsets of one ksplit stage's parts (each a multiple of 16): kKR
// byte rows (the low nibbles logical rows [r, r + kKR), the high ones
// [kp / 2 + r, ...)), then, for each half's kKR / G groups, the rows of s
// (factored: the int8 sub-scales; plain: the f32 plane), low half first, the
// same of m with mins, and where factored the f32 factor rows sd (and sm)
// of each half's superblock (a half's kKR rows lie in one)
template <int G, int SF, bool HAS_MINS>
struct KsStage {
  static constexpr bool kPlain = SF == 0;
  static constexpr int kR = kKR / G;                   // plane rows a half
  static constexpr int kRow = kPlain ? 4 * kTN : kTN;  // bytes a plane row
  static constexpr int kW = 0;                         // uint8 [kKR][kTN]
  static constexpr int kS = kW + kKR * kTN;            // [2][kR] rows of s
  static constexpr int kM = kS + 2 * kR * kRow;        // [2][kR] rows of m
  static constexpr int kSd = kM + (HAS_MINS ? 2 * kR * kRow : 0);  // f32 [2][kTN]
  static constexpr int kSm = kSd + (kPlain ? 0 : 2 * 4 * kTN);     // f32 [2][kTN]
  static constexpr int kBytes = kSm + (!kPlain && HAS_MINS ? 2 * 4 * kTN : 0);
  static constexpr int kPChunks = (kBytes - kS) / 16;  // 16-byte chunks of the planes
  static constexpr int kPPer = (kPChunks + kThreads - 1) / kThreads;  // a thread's
};

// the ksplit kernel's blocks an SM asked of the compiler, byte rows a step
// of its inner loop and the steps unrolled, and byte rows of x (of each
// half) a block stages at once (a window: all of a block's range but at the
// longest K). Four blocks at m = 1 (two rows a step, a window of 1024) and
// three at 8 rows of x (80 registers: spills) ran no faster on an H100
// (PERF.md).
template <int MT>
constexpr int kKsMinBlocks = MT == 1 ? 3 : 2;
template <int MT>
constexpr int kKsStep = MT == 1 ? 4 : 4;
template <int MT>
constexpr int kKsUnroll = MT == 1 ? 4 : 4;  // steps of the inner loop unrolled
template <int MT>
constexpr int kKsWinRows = MT == 1 ? 2048 : 512;

// "b" at m > 1 on tensor cores
template <int MT, int MODE>
constexpr bool kMmaKs = MODE == kKsB && MT == 8 && kGridMma;

// shared memory of a ksplit block: the ring, then the window's x and ("s")
// its group sums. "b" on tensor cores stages x as bf16 pairs: a window of
// twice the rows in the same bytes.
template <int MT, int MODE, int G, int SF, bool HAS_MINS>
struct KsSmem {
  static constexpr bool kMma = kMmaKs<MT, MODE>;
  static constexpr int kW = kMma ? 2 * kKsWinRows<MT> : kKsWinRows<MT>;
  // words a row of bf16 pairs (tensor cores), padded so that the lanes' B
  // fragments meet 32 banks
  static constexpr int kXStride = kW / 2 + 4;
  static constexpr int kRing = kStages * KsStage<G, SF, HAS_MINS>::kBytes;
  // f32 [MT][2][kW]; on tensor cores bf16 pairs [2][MT][kXStride]
  static constexpr int kX0 = kRing;
  static constexpr int kXs0 = kX0 + (kMma ? 2 * MT * kXStride * 4 : MT * 2 * kW * 4);
  // "s": f32 [MT][2][kW / G]
  static constexpr int kBytes = kXs0 + (MODE == kKsS ? MT * 2 * (kW / G) * 4 : 0);
  static_assert(kW % kKR == 0 && kW / 2 % 32 == 0, "a window holds whole stages");
  static_assert((kWarps + 1) * MT * kTN * 4 <= kBytes, "the reduction fits in the ring and x");
};

// The scale s and bias B of the group of byte row r of a stage in half h
// (0 low, 1 high) for the 4 columns [col0, col0 + 4) of stage b: factored,
// each an f32 product rounded once (the signed sub-scale through the
// mantissa), or the plain f32 rows
template <class St, int G, bool HAS_MINS>
__device__ __forceinline__ void ks_scales(const uint8_t* b, int h, int r, int col0, float (&s)[4],
                                          float (&bias)[4]) {
  const int pr = h * St::kR + r / G;  // the group's plane row in the stage
  float mv[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (St::kPlain) {
    const float4 s4 = *reinterpret_cast<const float4*>(b + St::kS + pr * St::kRow + 4 * col0);
    s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
    if (HAS_MINS) {
      const float4 m4 = *reinterpret_cast<const float4*>(b + St::kM + pr * St::kRow + 4 * col0);
      mv[0] = m4.x, mv[1] = m4.y, mv[2] = m4.z, mv[3] = m4.w;
    }
  } else {
    const uint32_t sw = *reinterpret_cast<const uint32_t*>(b + St::kS + pr * kTN + col0);
    const float4 d4 = *reinterpret_cast<const float4*>(b + St::kSd + h * 4 * kTN + 4 * col0);
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = __fmul_rn(dv[c], mantissa_f32<128>(sw ^ 0x80808080u, c));
    if (HAS_MINS) {
      const uint32_t mw = *reinterpret_cast<const uint32_t*>(b + St::kM + pr * kTN + col0);
      const float4 m4 = *reinterpret_cast<const float4*>(b + St::kSm + h * 4 * kTN + 4 * col0);
      const float dm[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) mv[c] = __fmul_rn(dm[c], mantissa_f32<128>(mw ^ 0x80808080u, c));
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) bias[c] = ctq::ksplit_bias<HAS_MINS>(s[c], mv[c], h == 1);
}

// a word of 4 ksplit bytes as one nibble a byte: the low nibbles l, or the
// high ones as f + 8
__device__ __forceinline__ uint32_t ks_nibbles(uint32_t wd, bool hi) {
  return hi ? ((wd >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u : wd & 0x0F0F0F0Fu;
}

// The weight of byte c of the ksplit word wd in its half, nib its
// ks_nibbles: v * s, rounded once as __fmul_rn (the low nibble's as one fma
// with lo_off = -2^23 s), then ("" and "b") + B rounded once, the high
// half's B only with mins. The nibble goes through the mantissa of 2^23
// (kNibbleMagic; else an I2F).
template <int MODE, bool HAS_MINS>
__device__ __forceinline__ float ks_weight(uint32_t nib, uint32_t wd, int c, bool hi, float s,
                                           float bias, float lo_off) {
  float v;
  if constexpr (!kNibbleMagic)
    v = __fmul_rn(static_cast<float>(ctq::ksplit_value(ctq::sbyte(wd, c), hi)), s);
  else if (hi)
    v = __fmul_rn(mantissa_f32<8>(nib, c), s);
  else
    v = kKsLoFma ? fmaf(mantissa_raw(nib, c), s, lo_off) : __fmul_rn(mantissa_f32<0>(nib, c), s);
  if (MODE != kKsS && (!hi || HAS_MINS)) v = __fadd_rn(v, bias);
  return v;
}

// MT: rows of x a block (1, or kMT at m > 1); MODE: kKsF, kKsS or kKsB; G,
// SF, HAS_MINS: the layout (qmm_common.cuh:ksplit_layout), SF == 0 with the
// f32 planes s and m passed as sd and sm and no sub-planes. Grid
// (np / kTN * parts, ceil(m / MT)) in clusters of `parts` along x.
template <int MT, int MODE, int G, int SF, bool HAS_MINS>
__global__ void __launch_bounds__(kThreads, kKsMinBlocks<MT>)
ksplit_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
              const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
              const float* __restrict__ sd, const float* __restrict__ sm,
              float* __restrict__ out, int m, int kp, int np, int parts) {
  using St = KsStage<G, SF, HAS_MINS>;
  using Sm = KsSmem<MT, MODE, G, SF, HAS_MINS>;
  constexpr int kW = Sm::kW, kXG = kW / G;
  constexpr int kLogG = G == 16 ? 4 : G == 32 ? 5 : G == 64 ? 6 : 7;
  static_assert(1 << kLogG == G && G >= kLR && ctq::kSuperblock % kKR == 0,
                "a group of 16 to 128 rows: one warp's rows or whole warps; a half of a "
                "stage lies in one superblock");
  extern __shared__ __align__(16) uint8_t smem[];
  float* xf = reinterpret_cast<float*>(smem + Sm::kX0);
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + Sm::kX0);
  float* xs = reinterpret_cast<float*>(smem + Sm::kXs0);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t rank = ctw::cluster_rank();
  const int n0 = static_cast<int>(blockIdx.x) / parts * kTN;
  const int t0 = blockIdx.y * MT;
  const int half = kp / 2;
  const int nst = half / kKR;
  const int s0 = static_cast<int>(rank) * nst / parts;
  const int n_it = (static_cast<int>(rank) + 1) * nst / parts - s0;

  // ---- stage it of this block's range into ring slot it % kStages ----
  // Each thread's copies are fixed: 16-byte chunks tid + u * kThreads of the
  // byte rows (row tid / 8 + u * kThreads / 8, chunk tid % 8; on tensor
  // cores at chunk tid % 8 ^ 2 (row / 2 % 4)) and chunks tid + j * kThreads
  // of the planes. A plane chunk's source row at stage it is
  // (first + it kKR) / G (a row of s or m; first is the logical row of the
  // block's first stage in its half) or / 256 (a factor row), so each is set
  // up once: its column's pointer and first.
  static_assert(kKR * kTN / 16 == 4 * kThreads, "four weight chunks a thread");
  const int8_t* wsrc = qs + (size_t)(s0 * kKR + tid / 8) * np + n0 + 16 * (tid % 8);
  const size_t wstep = (size_t)kThreads / 8 * np;  // rows between a thread's chunks
  const int wswz = Sm::kMma ? 16 * ((tid % 8 ^ 2 * (tid / 16 % 4)) - tid % 8) : 0;
  const uint8_t* psrc[St::kPPer];
  int pfirst[St::kPPer];
  bool pfac[St::kPPer];
#pragma unroll
  for (int j = 0; j < St::kPPer; ++j) {
    int off = 16 * (tid + j * kThreads);  // bytes into the stage's planes
    constexpr int kHalfBytes = St::kR * St::kRow, kRowBytes = (HAS_MINS ? 4 : 2) * kHalfBytes;
    const int el = St::kPlain ? 4 : 1;  // bytes a plane element
    pfac[j] = off >= kRowBytes;
    if (!pfac[j]) {  // a row of s or m: plane, half, row in the stage, column
      const int8_t* plane = St::kPlain ? reinterpret_cast<const int8_t*>(off < 2 * kHalfBytes ? sd : sm)
                                       : (off < 2 * kHalfBytes ? sub_s : sub_m);
      off %= 2 * kHalfBytes;
      pfirst[j] = off / kHalfBytes * half + s0 * kKR;
      off %= kHalfBytes;
      psrc[j] = reinterpret_cast<const uint8_t*>(plane) + (size_t)(off / St::kRow) * np * el +
                (size_t)n0 * el + off % St::kRow;
    } else {  // a factor row (sd, then sm), its half, its column
      off -= kRowBytes;
      const float* plane = off < 8 * kTN ? sd : sm;
      pfirst[j] = off / (4 * kTN) % 2 * half + s0 * kKR;
      psrc[j] = reinterpret_cast<const uint8_t*>(plane + n0) + off % (4 * kTN);
    }
  }
  auto load = [&](int it) {
    uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int8_t* wp = wsrc + (size_t)it * kKR * np;
#pragma unroll
    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads) + wswz, wp + u * wstep);
#pragma unroll
    for (int j = 0; j < St::kPPer; ++j) {
      const int c = tid + j * kThreads;
      if (St::kPChunks % kThreads == 0 || c < St::kPChunks) {
        const int row = (pfirst[j] + it * kKR) >> (pfac[j] ? 8 : kLogG);
        const size_t pitch = pfac[j] || St::kPlain ? 4 * (size_t)np : (size_t)np;
        cp16(b + St::kS + 16 * c, psrc[j] + row * pitch);
      }
    }
  };

  // ---- x of stages [it0, it0 + nw) of the block's range, staged once ----
  // Both halves (the byte rows' columns of x, then those kp / 2 on); a
  // thread takes 8 columns of one row and half, G / 8 neighbouring threads a
  // group (a warp's items are whole groups of one row and half: a window's
  // columns a half are a multiple of 128), whose sum "s" takes. f32 as they
  // are ("b": rounded to bf16); on tensor cores bf16 pairs.
  auto stage_x = [&](int it0, int nw) {
    const int k0 = (s0 + it0) * kKR;
    const int per = nw * kKR / 8;  // items of a row and half
    for (int e = tid; e < MT * 2 * per; e += kThreads) {
      const int ih = e / per, c8 = e % per;  // ih = 2 i + the half
      const int i = ih >> 1;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), z = a;
      if (t0 + i < m) {
        const float4* src = reinterpret_cast<const float4*>(
            x + (size_t)(t0 + i) * kp + (ih & 1) * half + k0 + 8 * c8);
        a = __ldg(src);
        z = __ldg(src + 1);
      }
      if constexpr (Sm::kMma) {
        *reinterpret_cast<uint4*>(xb + ((ih & 1) * MT + i) * Sm::kXStride + 4 * c8) =
            make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(z.x, z.y), bf16x2(z.z, z.w));
      } else {
        if constexpr (MODE == kKsB) {
          a = make_float4(bf16_round(a.x), bf16_round(a.y), bf16_round(a.z), bf16_round(a.w));
          z = make_float4(bf16_round(z.x), bf16_round(z.y), bf16_round(z.z), bf16_round(z.w));
        }
        float4* d = reinterpret_cast<float4*>(xf + ih * kW + 8 * c8);
        d[0] = a;
        d[1] = z;
      }
      if constexpr (MODE == kKsS) {
        float s = __fadd_rn(__fadd_rn(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w)),
                            __fadd_rn(__fadd_rn(z.x, z.y), __fadd_rn(z.z, z.w)));
#pragma unroll
        for (int off = 1; off < G / 8; off <<= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        if (c8 % (G / 8) == 0) xs[ih * kXG + c8 / (G / 8)] = s;
      }
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  // tensor cores: tile j's sums (reduce_mma)
  float dm[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dm[j][c] = 0.0f;

  ring_windows<kW / kKR>(n_it, load, stage_x, [&](int it, int jw) {
    const uint8_t* b = smem + (it % kStages) * St::kBytes;
    if constexpr (Sm::kMma) {
      // ---- "b" on tensor cores: one k16 tile of each half ----
      // Lane (4 g + t) takes byte rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of
      // the warp's 16 (A's K slots 2 t, 2 t + 1, 2 t + 8, 2 t + 9) at
      // columns [16 g, 16 g + 16); tile 4 e + c's A rows g and g + 8 are
      // columns 16 g + 4 e + c and 16 g + 8 + 4 e + c, its B column g row g
      // of x: in the low half's tile K row r of the stage is logical row r,
      // in the high one's kp / 2 + r.
      const int g = lane >> 2, t = lane & 3;
      uint4 wq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wq[q] = *reinterpret_cast<const uint4*>(
            b + St::kW + (w * kLR + 2 * t + (q & 1) + 8 * (q >> 1)) * kTN + 16 * (g ^ 2 * t));
      const uint32_t* xr = xb + g * Sm::kXStride + (jw * kKR + w * kLR) / 2 + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool hi = h == 1;
        const uint32_t xb0 = xr[h * MT * Sm::kXStride], xb1 = xr[h * MT * Sm::kXStride + 4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // words e (A row g) and 2 + e (A row g + 8) of each byte row
          float sl[4], bl[4], su[4], bu[4], ol[4], ou[4];
          ks_scales<St, G, HAS_MINS>(b, h, w * kLR, 16 * g + 4 * e, sl, bl);
          ks_scales<St, G, HAS_MINS>(b, h, w * kLR, 16 * g + 8 + 4 * e, su, bu);
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // kKsLoFma: -2^23 s of the low half, exact
            ol[c] = __fmul_rn(-8388608.0f, sl[c]);
            ou[c] = __fmul_rn(-8388608.0f, su[c]);
          }
          uint32_t wl[4], wu[4], nl[4], nu[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wl[q] = e ? wq[q].y : wq[q].x;
            wu[q] = e ? wq[q].w : wq[q].z;
            nl[q] = ks_nibbles(wl[q], hi);
            nu[q] = ks_nibbles(wu[q], hi);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float al[4], au[4];  // the byte rows' weights, rounded to bf16 in pairs below
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              al[q] = ks_weight<MODE, HAS_MINS>(nl[q], wl[q], c, hi, sl[c], bl[c], ol[c]);
              au[q] = ks_weight<MODE, HAS_MINS>(nu[q], wu[q], c, hi, su[c], bu[c], ou[c]);
            }
            mma_bf16(dm[4 * e + c], bf16x2(al[0], al[1]), bf16x2(au[0], au[1]),
                     bf16x2(al[2], al[3]), bf16x2(au[2], au[3]), xb0, xb1);
          }
        }
      }
    } else {
      // the scale s and bias B of this warp's group in each half (both its
      // 16 byte rows' groups) for this thread's 4 columns
      float s[2][4], bias[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ks_scales<St, G, HAS_MINS>(b, h, w * kLR, 4 * lane, s[h], bias[h]);
      float lo_off[4];  // kKsLoFma: -2^23 s of the low half, exact
#pragma unroll
      for (int c = 0; c < 4; ++c) lo_off[c] = __fmul_rn(-8388608.0f, s[0][c]);
      // byte row r of this warp's 16 for this thread's columns, and x of its
      // logical rows in each half
      const uint8_t* wb = b + St::kW + w * kLR * kTN + 4 * lane;
      const float* xw = xf + jw * kKR + w * kLR;

      // ---- the warp's 16 byte rows, kQ at a time: both nibbles of each ----
      constexpr int kQ = kKsStep<MT>, kU = kKsUnroll<MT>;
      static_assert(kQ == 2 || kQ == 4, "two or four byte rows a step");
#pragma unroll (kU)
      for (int rr = 0; rr < kLR; rr += kQ) {
        float wl[kQ][4], wh[kQ][4];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const uint32_t wd = *reinterpret_cast<const uint32_t*>(wb + (rr + q) * kTN);
          const uint32_t lo = ks_nibbles(wd, false), hi = ks_nibbles(wd, true);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wl[q][c] = ks_weight<MODE, HAS_MINS>(lo, wd, c, false, s[0][c], bias[0][c], lo_off[c]);
            wh[q][c] = ks_weight<MODE, HAS_MINS>(hi, wd, c, true, s[1][c], bias[1][c], 0.0f);
            if (MODE == kKsB) {  // then once to bf16
              wl[q][c] = bf16_round(wl[q][c]);
              wh[q][c] = bf16_round(wh[q][c]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float xl[kQ], xh[kQ];
          if constexpr (kQ == 4) {
            const float4 l4 = *reinterpret_cast<const float4*>(xw + 2 * i * kW + rr);
            const float4 h4 = *reinterpret_cast<const float4*>(xw + (2 * i + 1) * kW + rr);
            xl[0] = l4.x, xl[1] = l4.y, xl[2] = l4.z, xl[3] = l4.w;
            xh[0] = h4.x, xh[1] = h4.y, xh[2] = h4.z, xh[3] = h4.w;
          } else {
            const float2 l2 = *reinterpret_cast<const float2*>(xw + 2 * i * kW + rr);
            const float2 h2 = *reinterpret_cast<const float2*>(xw + (2 * i + 1) * kW + rr);
            xl[0] = l2.x, xl[1] = l2.y, xh[0] = h2.x, xh[1] = h2.y;
          }
#pragma unroll
          for (int q = 0; q < kQ; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xh[q], wh[q][c], fmaf(xl[q], wl[q][c], acc[i][c]));
        }
      }

      // "s": the group's first warp adds each half's xs @ B once
      if constexpr (MODE == kKsS) {
        if (w % (G / kLR) == 0) {
          const int g = (jw * kKR + w * kLR) / G;  // the group in the window
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(xs[2 * i * kXG + g], bias[0][c]));
              if (HAS_MINS)
                acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(xs[(2 * i + 1) * kXG + g], bias[1][c]));
            }
        }
      }
    }
  });

  if constexpr (Sm::kMma)
    reduce_mma<MT>(dm, smem, out, m, np, n0, t0, rank, parts);
  else
    reduce_out<MT>(acc, smem, out, m, np, n0, t0, rank, parts);
}

// ---- pre-quantized x on the int8 grids: ct_qmm_q8 and ct_qmm_q8_legacy ----

// byte offsets of one q8 stage's parts (each a multiple of 16): the grid
// bytes; the x part (xq, sx, and xsum with mins), whose 16-byte chunk c lies
// at kX + 16 c; the scale part (factored: sub-scales, sub-mins, the factor
// rows sd and sm; PLAIN_S: the rows of the f32 planes s and mn), chunk c at
// kSub + 16 c
template <int MT, int G, bool HAS_MINS, bool PLAIN_S>
struct Q8Stage {
  static constexpr int kGS = kKR / G;                          // groups a stage
  static constexpr int kW = 0;                                 // int8 [kKR][kTN]
  static constexpr int kX = kW + kKR * kTN;                    // int8 [MT][kKR] xq
  static constexpr int kSx = kX + MT * kKR;                    // f32 [MT][kGS]
  static constexpr int kXs = kSx + MT * kGS * 4;               // f32 [MT][kGS]
  static constexpr int kSub = kXs + (HAS_MINS ? MT * kGS * 4 : 0);
  static constexpr int kPlaneRow = PLAIN_S ? 4 * kTN : kTN;    // bytes a row of s (sub_s)
  static constexpr int kSubM = kSub + kGS * kPlaneRow;           // mn (sub_m) [kGS][kTN]
  static constexpr int kSd = kSubM + (HAS_MINS ? kGS * kPlaneRow : 0);  // f32 [kTN]
  static constexpr int kSm = kSd + (PLAIN_S ? 0 : 4 * kTN);             // f32 [kTN]
  static constexpr int kBytes = kSm + (HAS_MINS && !PLAIN_S ? 4 * kTN : 0);
  static constexpr int kXChunks = (kSub - kX) / 16;
  static constexpr int kSChunks = (kBytes - kSub) / 16;
  static_assert(kGS % 4 == 0, "whole 16-byte chunks a row of sx");
};

// shared memory of a q8 block: the ring, then (group 32) the int32 dots a
// group's second warp hands to the first
template <int MT, int G, bool HAS_MINS, bool PLAIN_S>
struct Q8Smem {
  static constexpr bool kComb = G > kLR;
  static constexpr int kRing = kStages * Q8Stage<MT, G, HAS_MINS, PLAIN_S>::kBytes;
  static constexpr int kComb0 = kRing;  // int [kWarps / 2][MT][kTN]
  static constexpr int kBytes = kComb0 + (kComb ? kWarps / 2 * MT * kTN * 4 : 0);
  static_assert((kWarps + 1) * MT * kTN * 4 <= kRing, "the reduction fits in the ring");
};

// the barrier of warps 2 p and 2 p + 1 alone (named barrier 1 + p)
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + p) : "memory");
}

// MT: rows of x a block (1, or kMT at m > 1); G: 16 (Q6_K, no mins) or 32
// (Q5_K with mins; the legacy grids with or without); PLAIN_S: the f32
// planes s and mn (passed as sd and sm, no sub-planes) instead of the
// factored ones. xq int8 (m, kp), sx and xs f32 (m, kp / G). Grid
// (np / kTN * parts, ceil(m / MT)) in clusters of `parts` along x.
template <int MT, int G, bool HAS_MINS, bool PLAIN_S>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>)
q8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
          const float* __restrict__ xs, const int8_t* __restrict__ qs,
          const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
          const float* __restrict__ sd, const float* __restrict__ sm,
          float* __restrict__ out, int m, int kp, int np, int parts) {
  using St = Q8Stage<MT, G, HAS_MINS, PLAIN_S>;
  using Sm = Q8Smem<MT, G, HAS_MINS, PLAIN_S>;
  constexpr int kGS = St::kGS;
  static_assert(G == kLR || G == 2 * kLR, "a group is one K lane or two");
  static_assert(!PLAIN_S || G == 2 * kLR, "the legacy grids' planes are at group 32");
  static_assert(ctq::kSuperblock % kKR == 0, "a stage lies in one superblock");
  static_assert(St::kXChunks <= kThreads && St::kSChunks <= kThreads, "a chunk of each part a thread");
  extern __shared__ __align__(16) uint8_t smem[];
  int* comb = reinterpret_cast<int*>(smem + Sm::kComb0);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t rank = ctw::cluster_rank();
  const int n0 = static_cast<int>(blockIdx.x) / parts * kTN;
  const int t0 = blockIdx.y * MT;
  const int nst = kp / kKR;
  const int s0 = static_cast<int>(rank) * nst / parts;
  const int n_it = (static_cast<int>(rank) + 1) * nst / parts - s0;

  // ---- stage it of this block's range into ring slot it % kStages ----
  // Each thread's copies are fixed: 16-byte chunks tid + u * kThreads of the
  // grid tile (row tid / 8 + u * kThreads / 8, chunk tid % 8), chunk tid of
  // the x part (threads below kXChunks: xq's rows, zero past m, then sx's and
  // xsum's), chunk tid - kS0 of the scale part (the last kSChunks threads).
  // Each chunk's source at stage 0 and its bytes a stage are set up once;
  // the factor rows sd and sm move a superblock (two stages) at a time.
  static_assert(kKR * kTN / 16 == 4 * kThreads, "four weight chunks a thread");
  const int8_t* wsrc = qs + (size_t)(s0 * kKR + tid / 8) * np + n0 + 16 * (tid % 8);
  const size_t wstep = (size_t)kThreads / 8 * np;  // rows between a thread's chunks
  const uint8_t* xsrc = nullptr;
  int xstep = 0;
  bool xlive = false;
  if (tid < St::kXChunks) {
    constexpr int kRowChunks = kKR / 16, kSxRow = kGS / 4;  // chunks a row of xq, of sx
    int c = tid;
    if (c < MT * kRowChunks) {
      const int i = c / kRowChunks;
      xlive = t0 + i < m;
      xsrc = reinterpret_cast<const uint8_t*>(xq + (size_t)(xlive ? t0 + i : 0) * kp + s0 * kKR +
                                              16 * (c % kRowChunks));
      xstep = kKR;
    } else {
      c -= MT * kRowChunks;
      const float* plane = c < MT * kSxRow ? sx : xs;
      c %= MT * kSxRow;
      const int i = c / kSxRow;
      xlive = t0 + i < m;
      xsrc = reinterpret_cast<const uint8_t*>(plane + (size_t)(xlive ? t0 + i : 0) * (kp / G) +
                                              s0 * kGS + 4 * (c % kSxRow));
      xstep = kGS * 4;
    }
  }
  constexpr int kS0 = kThreads - St::kSChunks;
  const uint8_t* ssrc = nullptr;
  size_t sstep = 0;
  bool per_sb = false;  // a factor row: indexed by the stage's superblock
  if (tid >= kS0) {
    const int c = tid - kS0;
    if constexpr (PLAIN_S) {
      constexpr int kPlane = kGS * kTN / 4;  // chunks of a plane's rows
      const float* plane = c < kPlane ? sd : sm;
      const int cc = c % kPlane;
      ssrc = reinterpret_cast<const uint8_t*>(plane + (size_t)(s0 * kGS + cc / (kTN / 4)) * np +
                                              n0 + 4 * (cc % (kTN / 4)));
      sstep = (size_t)kGS * np * 4;
    } else {
      constexpr int kSub = kGS * kTN / 16;  // chunks of a sub-plane's rows
      constexpr int kSubs = HAS_MINS ? 2 * kSub : kSub;
      if (c < kSubs) {
        const int8_t* plane = c < kSub ? sub_s : sub_m;
        const int cc = c % kSub;
        ssrc = reinterpret_cast<const uint8_t*>(plane + (size_t)(s0 * kGS + cc / (kTN / 16)) * np +
                                                n0 + 16 * (cc % (kTN / 16)));
        sstep = (size_t)kGS * np;
      } else {
        const int cc = c - kSubs;
        ssrc = reinterpret_cast<const uint8_t*>((cc < kTN / 4 ? sd : sm) + n0 + 4 * (cc % (kTN / 4)));
        sstep = (size_t)np * 4;
        per_sb = true;
      }
    }
  }
  auto load = [&](int it) {
    uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int8_t* wp = wsrc + (size_t)it * kKR * np;
#pragma unroll
    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads), wp + u * wstep);
    if (tid < St::kXChunks) cp16z(b + St::kX + 16 * tid, xsrc + it * xstep, xlive);
    if (tid >= kS0) {
      const int step = per_sb ? (s0 + it) * kKR / ctq::kSuperblock : it;
      cp16(b + St::kSub + 16 * (tid - kS0), ssrc + step * sstep);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_it) load(it);
    cp_commit();
  }
  const int r0 = w * kLR;  // this lane's first row in a stage
  const int gs = r0 / G;   // its group in the stage
  for (int it = 0; it < n_it; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; slot (it - 1) % kStages is free
    if (it + kStages - 1 < n_it) load(it + kStages - 1);
    cp_commit();
    const uint8_t* b = smem + (it % kStages) * St::kBytes;

    // ---- the lane's 16 rows' exact int32 dots, four rows at a time ----
    int dot[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dot[i][c] = 0;
#pragma unroll
    for (int rr = 0; rr < kLR; rr += 4) {
      uint32_t wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const uint32_t*>(b + St::kW + (r0 + rr + q) * kTN + 4 * lane);
      if constexpr (kGridDp4a) {
        // each column's 4 rows made one K-contiguous word
        uint32_t tw[4];
        transpose4(wv, tw);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int xw = *reinterpret_cast<const int*>(b + St::kX + i * kKR + r0 + rr);
#pragma unroll
          for (int c = 0; c < 4; ++c) dot[i][c] = __dp4a(static_cast<int>(tw[c]), xw, dot[i][c]);
        }
      } else {
        // the first design's form: each grid byte extracted, one
        // multiply-add a weight and row of x
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t xw = *reinterpret_cast<const uint32_t*>(b + St::kX + i * kKR + r0 + rr);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int xv = ctq::sbyte(xw, q);
#pragma unroll
            for (int c = 0; c < 4; ++c) dot[i][c] += ctq::sbyte(wv[q], c) * xv;
          }
        }
      }
    }

    if constexpr (Sm::kComb) {
      // a group's second warp hands its dot to the first
      int* cb = comb + (w / 2) * MT * kTN + 4 * lane;
      if (w & 1) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          *reinterpret_cast<int4*>(cb + i * kTN) = make_int4(dot[i][0], dot[i][1], dot[i][2], dot[i][3]);
      }
      pair_sync(w / 2);
      if (w & 1) continue;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int4 o = *reinterpret_cast<const int4*>(cb + i * kTN);
        dot[i][0] += o.x;
        dot[i][1] += o.y;
        dot[i][2] += o.z;
        dot[i][3] += o.w;
      }
    }

    // ---- the group's scale (and min) for this thread's 4 columns ----
    float s[4], mn[4];
    group_scales<4, St, HAS_MINS, PLAIN_S>(b, gs, 4 * lane, s, mn);

    // ---- one f32 rescale of the group's whole dots ----
    const float* sxb = reinterpret_cast<const float*>(b + St::kSx);
    const float* xsb = reinterpret_cast<const float*>(b + St::kXs);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float sxv = sxb[i * kGS + gs];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = __fmul_rn(__fmul_rn(static_cast<float>(dot[i][c]), sxv), s[c]);
        if (HAS_MINS) v = __fadd_rn(v, __fmul_rn(xsb[i * kGS + gs], mn[c]));
        acc[i][c] = __fadd_rn(acc[i][c], v);
      }
    }
  }

  reduce_out<MT>(acc, smem, out, m, np, n0, t0, rank, parts);
}

// The launch shape of a kernel of this file: rows of x a block (kMTile), K
// rows a stage (kRows), its dynamic shared memory, the kernel itself.
template <int MT, int MODE, int G, bool HAS_MINS, bool PLAIN_S>
struct GridKernel {
  static constexpr int kMTile = MT, kRows = kKR;
  static constexpr size_t kSmem = Smem<MT, MODE, G, HAS_MINS, PLAIN_S>::kBytes;
  static auto fn() { return splitk_kernel<MT, MODE, G, HAS_MINS, PLAIN_S>; }
};

template <int MT, bool QX>
struct NibbleKernel {
  static constexpr int kMTile = MT, kRows = kNRows;
  static constexpr size_t kSmem = NSmem<MT, QX>::kBytes;
  static auto fn() { return nibble_kernel<MT, QX>; }
};

template <int MT, int MODE, int G, int SF, bool HAS_MINS>
struct KsKernel {
  static constexpr int kMTile = MT, kRows = 2 * kKR;  // logical K rows a stage
  static constexpr size_t kSmem = KsSmem<MT, MODE, G, SF, HAS_MINS>::kBytes;
  static auto fn() { return ksplit_kernel<MT, MODE, G, SF, HAS_MINS>; }
};

template <int MT, int G, bool HAS_MINS, bool PLAIN_S>
struct Q8Kernel {
  static constexpr int kMTile = MT, kRows = kKR;
  static constexpr size_t kSmem = Q8Smem<MT, G, HAS_MINS, PLAIN_S>::kBytes;
  static auto fn() { return q8_kernel<MT, G, HAS_MINS, PLAIN_S>; }
};

template <class KT>
struct Split {
  static cudaError_t prepare() {
    return cudaFuncSetAttribute(KT::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(KT::kSmem));
  }

  // clusters of p blocks the card runs at once, asked once per device, p
  // and instantiation
  static cudaError_t capacity(int p, int* n) {
    static int cache[16][9] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (p < 1 || p > 8) return cudaErrorInvalidValue;
    if (dev < 16 && cache[dev][p] > 0) {
      *n = cache[dev][p];
      return cudaSuccess;
    }
    e = prepare();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = KT::kSmem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(n, KT::fn(), &cfg);
    if (e != cudaSuccess) return e;
    if (*n <= 0) return cudaErrorInvalidConfiguration;  // no cluster of p fits an SM group
    if (dev < 16) cache[dev][p] = *n;
    return cudaSuccess;
  }

  // P: the first of kPlanParts up to kMaxP and up to the stage count whose
  // clusters (tiles x row tiles of them) all fit on the card at once
  static cudaError_t plan(int m, int kp, int np, int* parts) {
    const long long clusters =
        static_cast<long long>(np / kTN) * ((m + KT::kMTile - 1) / KT::kMTile);
    const int nst = kp / KT::kRows;
    for (const int p : kPlanParts) {
      if (p > kMaxP || p > nst) continue;
      int n = 0;
      const cudaError_t e = capacity(p, &n);
      if (e != cudaSuccess) return e;
      if (clusters <= n) {
        *parts = p;
        return cudaSuccess;
      }
    }
    *parts = 1;
    return cudaSuccess;
  }

  // the kernel on its pointers `ptrs`, then m, kp, np and the plan's P
  template <class... Ptrs>
  static int launch(int m, int kp, int np, cudaStream_t stream, Ptrs... ptrs) {
    int parts = 1;
    cudaError_t e = plan(m, kp, np, &parts);
    if (e == cudaSuccess) e = prepare();
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(np / kTN * parts, (m + KT::kMTile - 1) / KT::kMTile);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = KT::kSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, KT::fn(), ptrs..., m, kp, np, parts);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
};

// the shapes the split takes: 1 <= m <= kMaxM, kp a multiple of 256, np of
// 128 (the QTensor's padding)
inline bool fits(int m, int kp, int np) {
  return m >= 1 && m <= kMaxM && kp >= ctq::kSuperblock && kp % ctq::kSuperblock == 0 &&
         np >= kTN && np % kTN == 0;
}

// the shapes and factored planes the split takes: sub-scales and factors
// given, and both min planes or neither as HAS_MINS says
template <bool HAS_MINS>
bool takes(int m, int kp, int np, const void* sub_s, const void* sub_m, const float* sd,
           const float* sm) {
  return fits(m, kp, np) && sub_s != nullptr && sd != nullptr &&
         (sub_m != nullptr) == HAS_MINS && (sm != nullptr) == HAS_MINS;
}

// takes, or (PLAIN_S) the shapes and the legacy grids' plain planes: s
// given as sd, mn as sm exactly when HAS_MINS, no sub-planes
template <bool HAS_MINS, bool PLAIN_S>
bool takes_planes(int m, int kp, int np, const void* sub_s, const void* sub_m, const float* sd,
                  const float* sm) {
  if (!PLAIN_S) return takes<HAS_MINS>(m, kp, np, sub_s, sub_m, sd, sm);
  return fits(m, kp, np) && sub_s == nullptr && sub_m == nullptr && sd != nullptr &&
         (sm != nullptr) == HAS_MINS;
}

// a kernel of this file at batch size m on its pointers: KT1 (one row of x
// a block) at m = 1, KT8 (kMT rows) above
template <class KT1, class KT8, class... Ptrs>
int run_family(int m, int kp, int np, cudaStream_t stream, Ptrs... ptrs) {
  if (m == 1) return Split<KT1>::launch(m, kp, np, stream, ptrs...);
  return Split<KT8>::launch(m, kp, np, stream, ptrs...);
}

// the clusters of p blocks that run_family's kernel for batch size m runs
// on the card at once, or a negative CUDA error code
template <class KT1, class KT8>
int capacity_family(int m, int p) {
  if (m < 1 || m > kMaxM) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t e = m == 1 ? Split<KT1>::capacity(p, &n) : Split<KT8>::capacity(p, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// run_family's plan for a shape: P, or a negative CUDA error code
template <class KT1, class KT8>
int plan_family(int m, int kp, int np) {
  if (!fits(m, kp, np)) return -static_cast<int>(cudaErrorInvalidValue);
  int parts = 0;
  const cudaError_t e =
      m == 1 ? Split<KT1>::plan(m, kp, np, &parts) : Split<KT8>::plan(m, kp, np, &parts);
  return e == cudaSuccess ? parts : -static_cast<int>(e);
}

// ct_qmm_g8 (kGridG), ct_qmm_f (kGridF) or ct_qmm_rb8 (kGridB) at
// 1 <= m <= kMaxM: group 16 without mins (Q6_K) or 32 with both min planes
// (Q5_K); ct_qmm_rb8_legacy (kGridB, PLAIN_S): group 32, the f32 planes s
// and, with mins, mn passed as sd and sm, no sub-planes
template <int MODE, int G, bool HAS_MINS, bool PLAIN_S = false>
int run(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
        const float* sd, const float* sm, float* out, int m, int kp, int np,
        cudaStream_t stream) {
  if (!takes_planes<HAS_MINS, PLAIN_S>(m, kp, np, sub_s, sub_m, sd, sm))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_family<GridKernel<1, MODE, G, HAS_MINS, PLAIN_S>,
                    GridKernel<kMT, MODE, G, HAS_MINS, PLAIN_S>>(m, kp, np, stream, x, qs, sub_s,
                                                                 sub_m, sd, sm, out);
}

template <int MODE, int G, bool HAS_MINS, bool PLAIN_S = false>
int capacity_of(int m, int p) {
  return capacity_family<GridKernel<1, MODE, G, HAS_MINS, PLAIN_S>,
                         GridKernel<kMT, MODE, G, HAS_MINS, PLAIN_S>>(m, p);
}

template <int MODE, int G, bool HAS_MINS, bool PLAIN_S = false>
int plan_of(int m, int kp, int np) {
  return plan_family<GridKernel<1, MODE, G, HAS_MINS, PLAIN_S>,
                     GridKernel<kMT, MODE, G, HAS_MINS, PLAIN_S>>(m, kp, np);
}

// ct_qmm_qx (QX) or ct_qmm_g on Q4_K at 1 <= m <= kMaxM
template <bool QX>
int run_nibble(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               cudaStream_t stream) {
  if (!takes<true>(m, kp, np, sub_s, sub_m, sd, sm)) return static_cast<int>(cudaErrorInvalidValue);
  return run_family<NibbleKernel<1, QX>, NibbleKernel<kMT, QX>>(m, kp, np, stream, x, qs, sub_s,
                                                                sub_m, sd, sm, out);
}

template <bool QX>
int nibble_capacity_of(int m, int p) {
  return capacity_family<NibbleKernel<1, QX>, NibbleKernel<kMT, QX>>(m, p);
}

template <bool QX>
int nibble_plan_of(int m, int kp, int np) {
  return plan_family<NibbleKernel<1, QX>, NibbleKernel<kMT, QX>>(m, kp, np);
}

// ct_qmm_f_ks (kKsF), ct_qmm_s_ks (kKsS), ct_qmm_b_ks or ct_qmm_rb_ks
// (kKsB) at 1 <= m <= kMaxM on a layout of ctq::ksplit_layout, its planes as
// ctq::dispatch_ksplit passes them
template <int MODE, int G, int SF, bool HAS_MINS>
int run_ksplit(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               cudaStream_t stream) {
  if (!fits(m, kp, np)) return static_cast<int>(cudaErrorInvalidValue);
  return run_family<KsKernel<1, MODE, G, SF, HAS_MINS>, KsKernel<kMT, MODE, G, SF, HAS_MINS>>(
      m, kp, np, stream, x, qs, sub_s, sub_m, sd, sm, out);
}

template <int MODE, int G, int SF, bool HAS_MINS>
int ksplit_capacity_of(int m, int p) {
  return capacity_family<KsKernel<1, MODE, G, SF, HAS_MINS>, KsKernel<kMT, MODE, G, SF, HAS_MINS>>(
      m, p);
}

template <int MODE, int G, int SF, bool HAS_MINS>
int ksplit_plan_of(int m, int kp, int np) {
  return plan_family<KsKernel<1, MODE, G, SF, HAS_MINS>, KsKernel<kMT, MODE, G, SF, HAS_MINS>>(
      m, kp, np);
}

// ct_qmm_q8 (factored: group 16 without mins, Q6_K, or 32 with both min
// planes, Q5_K) or ct_qmm_q8_legacy (PLAIN_S: group 32, the f32 planes s
// and, with mins, mn passed as sd and sm, no sub-planes) at 1 <= m <= kMaxM,
// on xq, sx and (with mins) xs given
template <int G, bool HAS_MINS, bool PLAIN_S>
int run_q8(const int8_t* xq, const float* sx, const float* xs, const int8_t* qs,
           const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm,
           float* out, int m, int kp, int np, cudaStream_t stream) {
  if (!takes_planes<HAS_MINS, PLAIN_S>(m, kp, np, sub_s, sub_m, sd, sm) || xq == nullptr ||
      sx == nullptr || (HAS_MINS && xs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_family<Q8Kernel<1, G, HAS_MINS, PLAIN_S>, Q8Kernel<kMT, G, HAS_MINS, PLAIN_S>>(
      m, kp, np, stream, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out);
}

template <int G, bool HAS_MINS, bool PLAIN_S>
int q8_capacity_of(int m, int p) {
  return capacity_family<Q8Kernel<1, G, HAS_MINS, PLAIN_S>, Q8Kernel<kMT, G, HAS_MINS, PLAIN_S>>(
      m, p);
}

template <int G, bool HAS_MINS, bool PLAIN_S>
int q8_plan_of(int m, int kp, int np) {
  return plan_family<Q8Kernel<1, G, HAS_MINS, PLAIN_S>, Q8Kernel<kMT, G, HAS_MINS, PLAIN_S>>(
      m, kp, np);
}

}  // namespace ctsk
