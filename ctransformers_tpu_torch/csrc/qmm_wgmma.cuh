// The Hopper GEMM core of the prompt GEMMs on int8 grids, ct_qmm_b and
// ct_qmm_sb (Q6_K and Q5_K, factored scales), ct_qmm_b_legacy and
// ct_qmm_sb_legacy (Q5_1 with mins, Q8_0 and Q5_0 without; plain f32
// planes), and above m = 32 ct_qmm_rb8 and ct_qmm_rb8_legacy (ct_qmm_b's
// function and instantiations), routed here by qmm_grid.cu; on ksplit
// nibbles above m = 32 (every nibble kind), ct_qmm_sb_ks (qmm_float.cu) and
// ct_qmm_b_ks and ct_qmm_rb_ks (qmm_ksplit.cu: the ksplit tile without the
// fold); and on adjk nibbles (all in qmm_prefill.cu), ct_qmm_si_gptq and
// ct_qmm_i_gptq (GPTQ4 at groups 32, 64 and 128, Q4_1), ct_qmm_si and
// ct_qmm_i (Q4_K, group 32, factored scales), ct_qmm_si_k16 and
// ct_qmm_i_k16 (Q2_K and Q3_K, group 16, factored scales) and
// ct_qmm_si_q4_0 and ct_qmm_i_q4_0 (Q4_0, group 32, the plain s plane
// without mins). Every prompt GEMM of the port runs here.
//
// Function (the JAX package's _qmm_kernel mode "b", _qmm_s_kernel mode
// "sb", _qmm_pack4_s_kernel mode "sb", _qmm_pack4_kernel mode "b",
// _qmm_i4_s_kernel and _qmm_i4_kernel, ctransformers_tpu/ops/qmatmul.py:734,
// :1040, :957, :783, :1148 and :1090):
//   b:     out = bf16(x) @ bf16(q * s + m)         (m only with mins)
//   sb:    out = xsum @ M + bf16(x) @ bf16(q * s)  (the fold only with mins)
//   sb_ks: out = xs_lo @ B_lo + xs_hi @ B_hi + bf16(x) @ bf16(v * s)
//   b_ks:  out = bf16(x) @ bf16(v * s + B)
//   si:    out = xsum @ B + bf16(x) @ bf16(w4 * s)  (the fold only with a bias)
//   i:     out = bf16(x) @ bf16(w4 * s + B)
// with f32 accumulation; s = sd * sub_s (factored) or the f32 plane s, each
// weight's q * s (+ m) in f32 rounded once to bf16, x rounded to nearest
// even, xsum the f32 sums of x over each group of 32 K rows (M = sm * sub_m
// on Q5_K, one f32 product, or the plain m plane). On ksplit nibbles
// (qmm_common.cuh) v is the low nibble l in the low half of K and f in the
// high half, B each half's bias (ctq::ksplit_bias; the high half of Q4_0
// and Q3_K has none) and xs the f32 sums of x over each group of G rows
// (16 to 128). On adjk nibbles w4 is the signed nibble, B = 8 s + m
// (ctq::plain_bias; m = sm * sub_m on Q4_K and Q2_K, none on Q3_K and
// Q4_0, which have no bias) and xsum the sums over each group of G = 16
// (Q2_K), 32, 64 or 128 rows.
//
// Bound: at m = 128 a weight byte (about 1.08 B/weight with its scales)
// feeds ~237 operations, just under the bf16 ridge, so the weight's bytes
// and the tensor-core operations bound it about equally. On one H100 at
// m = 128 the core runs at about 4x that bound, and the consumer
// warpgroups' work per stage, not the copies, sets its time: a build that
// issues no copy at all takes as long (PERF.md, the GEMM core's findings).
//
// Design. A block owns a 128-token x 128-column output tile and a third
// of K; the three thirds of a tile are the three blocks of a thread-block
// cluster (a K split: N = 4096 gives 96 blocks in one wave; at this shared
// memory only 30 clusters of 4 fit on the card at once, so a split in four
// would run its 32 clusters in two waves):
//   * one producer warp keeps a ring of 4 stages of 64 K rows in flight with
//     the Tensor Memory Accelerator: the f32 x tile (two 128-byte-swizzled
//     boxes of 32 columns, rows past m filled with zeros), the int8 weight
//     tile (64 x 128 bytes) and the stage's scale rows (bulk copies), each
//     stage completing one mbarrier; 32 KB of weight in flight per SM;
//   * two consumer warpgroups (tokens 0-63 and 64-127) dequantize the
//     stage's weight tile once for both: each thread takes 8 K rows x 4
//     columns (one 32-bit load per row, its group's scales once), rounds
//     q * s (+ m) to bf16 and writes it into a tile of 3 in a 128-byte
//     swizzled, N-major layout that wgmma reads as its B operand;
//   * each warpgroup rounds its 64 x 64 x tile to bf16 straight into the
//     register fragments of wgmma's A operand, one 16-byte load per row and
//     step (x goes through no shared bf16 copy; the rounding happens once
//     per block, in the core; the fragment's K slots and rows are permuted
//     so that those loads are free of bank conflicts), then issues
//     wgmma.mma_async m64n128k16 (bf16 in, f32 accumulators) over the
//     stage, keeping one stage's products in flight while it dequantizes
//     the next (the sum-fold form waits for each stage, then adds its
//     xsum @ M in f32 FFMA to the accumulators: issuing a stage's products
//     after the next stage's fold instead measured no faster, PERF.md);
//   * at the end each block stores its partial tile in shared memory; after
//     a cluster barrier block r adds the three blocks' partial sums of its
//     third of the rows in rank order through distributed shared memory and
//     alone writes them.
// Every output is written once, by one thread, after sums in a fixed
// order: runs are bitwise repeatable. Any m runs: rows past m are zeros in
// the x tile and never written; m > 128 takes more blocks along m, each
// dequantizing the weight again.
//
// The ksplit nibble tile (KS). A stage holds 32 byte rows x 128 columns of
// the (kp/2, np) plane (4 KB): they feed 64 K rows, the stage's 32 rows of
// the low half and the same 32 rows of the high half (row r + kp/2), so
// the stage's two x boxes lie at K offsets r and r + kp/2. Each consumer
// thread reads 4 byte rows x 4 columns once and unpacks both nibbles
// (ctq::ksplit_value), rounding v * s of each half to bf16 into B rows
// r (low) and 32 + r (high) of the tile; the products are as above.
// Without the fold (b_ks) each half's bias is added to each weight before
// that rounding (none in the high half of Q4_0 and Q3_K), so a stage reads
// only its own groups' rows and no group is carried across stages or the
// cluster's K split. The stage's scale rows (5 KB at most) lie in the
// weight slot's unused half and the scale slot. The fold is general: groups
// of 16 to 128 rows, factored or plain planes; the first thread rows of
// each group write its two biases into the stage (bias rows beside the
// scales), each warpgroup thread sums its rows of x over each group's
// columns of the stage and, once the stage's products are done, adds
// sum * B in f32; a group of 64 or 128 rows carries its sum across its
// stages and adds it once, at its last stage (or the block's last: a
// cluster's K split may cut a group).
//
// The adjk nibble tile (AJ). A stage is 64 contiguous K rows, as on the
// grid: the same two x boxes, and 32 byte rows x 128 columns of the
// (kp/2, np) plane (4 KB, half the weight slot), byte row r holding K rows
// 2r (low nibble) and 2r + 1 (high nibble). Each consumer thread reads 4
// byte rows x 4 columns once, which give the grid tile's 8 K rows (one
// group's: they start at a multiple of 8), rounds w4 * s (+ B without the
// fold) once to bf16 (ctq::nibble) into their K slots, and, with the fold,
// the first rows of each group write its bias row B = 8 s + m into the
// free half of the weight slot; without mins (Q3_K, Q4_0) there is no bias
// and no fold, W = w4 * s. The scale rows are the grid's: the plain s and
// m rows of the stage's groups (one row at groups of 64 and 128; Q4_0 only
// its two s rows), or the factored sub_s and sub_m rows of its four groups
// of 16 (Q2_K, Q3_K) or two of 32 (Q4_K) beside the superblock's sd and sm
// rows. The fold takes four groups a stage at G = 16 (each 16-column x
// step one group), two at 32, one at 64, and at 128 carries the group's
// sums over its two stages, adding them at its last (or the block's last).
//
// The factored sum fold (ct_qmm_sb on Q5_K). The scale slot holds sub_m
// and sm, not M; the first rows of each group write its f32 row
// M = sm * sub_m (one product, as the reference's _apply_factors) into an
// area of 1 KB a stage after the barriers (the other instantiations do not
// allocate it), which the fold reads as it reads the plain m rows.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"

namespace ctw {

constexpr int kBM = 128;           // token rows of a block
constexpr int kBN = 128;           // weight columns of a block
constexpr int kBK = 64;            // K rows of a stage
constexpr int kStages = 4;         // ring depth
constexpr int kBTiles = 3;         // dequantized bf16 weight tiles
constexpr int kSplit = 3;          // blocks of a cluster, one third of K each
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kXBox = 32;          // f32 columns of one swizzled x box (128 bytes)
constexpr int kXHalf = kBM * kXBox * 4;    // 16384
constexpr int kXBytes = 2 * kXHalf;
constexpr int kWBytes = kBK * kBN;         // int8 weight tile
constexpr int kSBytes = 2048;              // the stage's scale (and min) rows
constexpr int kStageBytes = kXBytes + kWBytes + kSBytes;  // 43008 = 42 KB
constexpr int kBTileBytes = kBK * kBN * 2;
constexpr int kAtomBytes = kBK * 128;      // 64 columns (one swizzle atom) x 64 rows
constexpr int kPLd = kBN + 4;              // partial tile row stride, floats
constexpr int kKsRows = kBK / 2;           // ksplit byte rows of a stage
constexpr int kKsWBytes = kKsRows * kBN;   // their bytes: half the weight slot
constexpr int kBarOff = kStages * kStageBytes + kBTiles * kBTileBytes;
constexpr int kMRowOff = kBarOff + 2 * kStages * 8;  // the factored fold's M rows
constexpr int kMRowBytes = 2 * kBN * 4;              // a stage's two f32 rows
constexpr size_t kSmemBytes = 1024 + kMRowOff;
constexpr size_t kSmemMRowsBytes = kSmemBytes + kStages * kMRowBytes;
static_assert(kStageBytes % 1024 == 0 && kBarOff % 1024 == 0, "swizzled tiles on 1 KB");
static_assert(kBM * kPLd * 4 <= kStages * kStageBytes, "the partial tile fits the ring");
static_assert(kSmemMRowsBytes <= 232448, "shared memory of one block");

struct Params {
  const int8_t* sub_s;  // (kp/G, np) int8 [factored]
  const int8_t* sub_m;  // (kp/G, np) int8 [factored, mins]
  const float* sd;      // (kp/256, np); plain: s (kp/G, np)
  const float* sm;      // (kp/256, np) [factored, mins]; plain: m (kp/G, np) [mins]
                        // (ksplit: sub_s, sub_m, sd, sm as ctq::dispatch_ksplit names
                        // them, indexed by the logical row; adjk: as on the grid)
  float* out;           // (m, np)
  int m, kp, np;
};

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ float4 ld_cluster(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma descriptor of a B operand stored N-major with the 128-byte swizzle:
// 64-column atoms (8 rows of 128 bytes each, 16-byte chunks XOR-ed with the
// row) kAtomBytes apart along N (the leading byte offset) and 8-row K groups
// 1024 bytes apart (the stride byte offset)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// (d0 | d1) (64 x 128 f32, this warpgroup's; d0 the first 64 columns) +=
// a (64 x 16 bf16, registers) x b (16 x 128 bf16 in shared memory, N-major:
// the transposed-B flag)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d0)[32], float (&d1)[32],
                                                 const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keep the compiler from moving accumulator reads across a wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ---- the kernel ---------------------------------------------------------------

// The token of fragment row g8 (0..7) of a warp's 8: 0, 4, 1, 5, 2, 6, 3, 7,
// so that rows g8 = 2i and 2i + 1 (one quarter-warp) differ in bit 2 and
// their swizzles spread over all 8 chunks of a 128-byte row.
__device__ __forceinline__ int token_row(int g8) { return ((g8 & 1) << 2) | (g8 >> 1); }

// The K slot of weight row k of a stage: in each 16-row step, rows 4a, 4a + 1
// go to slots 2a, 2a + 1 and rows 4a + 2, 4a + 3 to slots 2a + 8, 2a + 9,
// the slots a thread's A fragment holds for x columns 4a .. 4a + 3.
__device__ __forceinline__ int k_slot(int k) {
  const int o = k & 15;
  return (k & ~15) + 2 * (o >> 2) + ((o & 2) << 2) + (o & 1);
}

// The scale rows of a stage (kSBytes): [0, 1024) the scales, [1024, 2048)
// the mins. Factored: sub_s rows at 128 bytes each from 0, the superblock's
// sd row at 512; sub_m rows from 1024, sm at kSmOff: 1280, or 1536 where
// four sub_m rows (group 16 with mins: Q2_K's adjk tile) fill 1024-1535.
// Plain: the f32 s rows at 512 bytes each from 0, m rows from 1024. A
// group of 128 rows (the adjk tile) spans two stages: each holds its one
// row.
template <int G, bool HAS_MINS, bool PLAIN_S>
struct Scales {
  static constexpr int kRows = kBK >= G ? kBK / G : 1;  // quant groups of a stage
  static constexpr int kSmOff = kRows * kBN <= 256 ? 1280 : 1536;
  static constexpr int kBytes = PLAIN_S ? kRows * kBN * 4 * (HAS_MINS ? 2 : 1)
                                        : (kRows * kBN + kBN * 4) * (HAS_MINS ? 2 : 1);
  static_assert((PLAIN_S ? kRows * kBN * 4 <= 1024 : kRows * kBN <= 512) &&
                    (kBK % G == 0 || G % kBK == 0) && 256 % kBK == 0,
                "stage layout");

  // the producer: this stage's rows, completing on bar
  __device__ __forceinline__ static void copy(const Params& p, int k0, int n0, uint32_t dst,
                                              uint32_t bar) {
    const int g0 = k0 / G;
    if (PLAIN_S) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        bulk_copy(dst + i * kBN * 4, p.sd + (size_t)(g0 + i) * p.np + n0, kBN * 4, bar);
        if (HAS_MINS)
          bulk_copy(dst + 1024 + i * kBN * 4, p.sm + (size_t)(g0 + i) * p.np + n0, kBN * 4, bar);
      }
    } else {
      const int sb = k0 / 256;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        bulk_copy(dst + i * kBN, p.sub_s + (size_t)(g0 + i) * p.np + n0, kBN, bar);
        if (HAS_MINS)
          bulk_copy(dst + 1024 + i * kBN, p.sub_m + (size_t)(g0 + i) * p.np + n0, kBN, bar);
      }
      bulk_copy(dst + 512, p.sd + (size_t)sb * p.np + n0, kBN * 4, bar);
      if (HAS_MINS) bulk_copy(dst + kSmOff, p.sm + (size_t)sb * p.np + n0, kBN * 4, bar);
    }
  }

  // a consumer thread: the scale s and min m of group gl of the stage for
  // columns 4 lane .. 4 lane + 3, rounded as GridTile::load rounds them
  // (s = sd * sub_s and m = sm * sub_m one f32 product each)
  template <bool WITH_MINS>
  __device__ __forceinline__ static void load(const uint8_t* sc, int gl, int lane, float (&s)[4],
                                              float (&m)[4]) {
    if (PLAIN_S) {
      const float4 s4 = *reinterpret_cast<const float4*>(sc + gl * kBN * 4 + 16 * lane);
      s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
      if (WITH_MINS) {
        const float4 m4 = *reinterpret_cast<const float4*>(sc + 1024 + gl * kBN * 4 + 16 * lane);
        m[0] = m4.x, m[1] = m4.y, m[2] = m4.z, m[3] = m4.w;
      }
    } else {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(sc + gl * kBN + 4 * lane);
      const float4 d4 = *reinterpret_cast<const float4*>(sc + 512 + 16 * lane);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = __fmul_rn(dv[j], static_cast<float>(ctq::sbyte(sw, j)));
      if (WITH_MINS) {
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(sc + 1024 + gl * kBN + 4 * lane);
        const float4 m4 = *reinterpret_cast<const float4*>(sc + kSmOff + 16 * lane);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          m[j] = __fmul_rn(mv[j], static_cast<float>(ctq::sbyte(mw, j)));
      }
    }
  }
};

// The scale rows of a ksplit stage, at the weight tile + kKsWBytes: group
// f = h * kNGB + j is group j of half h's 32 rows (h 0 low, 1 high).
// Plain (GPTQ4, Q4_1, Q4_0): the f32 s rows at 512 f from 0, m rows from
// 1024. Factored (Q4_K, Q2_K, Q3_K: s = sd * sub_s, m = sm * sub_m): sub_s
// rows at 128 f from 0, the halves' sd rows at 512 + 512 h, sub_m rows from
// 1536, sm rows at 2048 + 512 h. From kBiasOff the fold's bias rows, f32,
// 512 bytes a group in the same order, which the consumers write.
template <int G, bool HAS_MINS, bool PLAIN_S>
struct KsScales {
  static constexpr int kNGB = G < kKsRows ? kKsRows / G : 1;  // groups of a half's rows
  static constexpr int kMinOff = PLAIN_S ? 1024 : 1536;
  static constexpr int kBiasOff = 3072;
  static constexpr int kBytes = PLAIN_S ? 2 * kBN * 4 * (HAS_MINS ? 2 : 1)
                                        : (2 * kNGB * kBN + 2 * kBN * 4) * (HAS_MINS ? 2 : 1);
  static_assert(PLAIN_S ? G >= kKsRows && G <= 128 : G * kNGB == kKsRows || G == kKsRows,
                "plain groups of 32 to 128 rows, factored groups of 16 or 32");
  static_assert(kBytes <= kBiasOff && kBiasOff + 2 * kNGB * kBN * 4 <= kWBytes - kKsWBytes + kSBytes,
                "stage layout");

  // the producer: the rows of the stage's byte rows r0 .. r0 + 31 in both
  // halves (logical rows r0 and half + r0 on), completing on bar
  __device__ __forceinline__ static void copy(const Params& p, int r0, int half, int n0,
                                              uint32_t dst, uint32_t bar) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = h * half + r0;
      if (PLAIN_S) {
        bulk_copy(dst + h * kBN * 4, p.sd + (size_t)(k / G) * p.np + n0, kBN * 4, bar);
        if (HAS_MINS)
          bulk_copy(dst + kMinOff + h * kBN * 4, p.sm + (size_t)(k / G) * p.np + n0, kBN * 4, bar);
      } else {
#pragma unroll
        for (int j = 0; j < kNGB; ++j) {
          const int f = h * kNGB + j;
          bulk_copy(dst + f * kBN, p.sub_s + (size_t)(k / G + j) * p.np + n0, kBN, bar);
          if (HAS_MINS)
            bulk_copy(dst + kMinOff + f * kBN, p.sub_m + (size_t)(k / G + j) * p.np + n0, kBN,
                      bar);
        }
        bulk_copy(dst + 512 + h * kBN * 4, p.sd + (size_t)(k / 256) * p.np + n0, kBN * 4, bar);
        if (HAS_MINS)
          bulk_copy(dst + 2048 + h * kBN * 4, p.sm + (size_t)(k / 256) * p.np + n0, kBN * 4, bar);
      }
    }
  }

  // a consumer thread: the scale s and min m (0 without mins) of group j of
  // half h for columns 4 lane .. 4 lane + 3, each factored one an f32
  // product rounded once, as the reference's _apply_factors
  __device__ __forceinline__ static void load(const uint8_t* sc, int h, int j, int lane,
                                              float (&s)[4], float (&m)[4]) {
    const int f = h * kNGB + j;
    m[0] = m[1] = m[2] = m[3] = 0.f;
    if (PLAIN_S) {
      const float4 s4 = *reinterpret_cast<const float4*>(sc + h * kBN * 4 + 16 * lane);
      s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
      if (HAS_MINS) {
        const float4 m4 = *reinterpret_cast<const float4*>(sc + kMinOff + h * kBN * 4 + 16 * lane);
        m[0] = m4.x, m[1] = m4.y, m[2] = m4.z, m[3] = m4.w;
      }
    } else {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(sc + f * kBN + 4 * lane);
      const float4 d4 = *reinterpret_cast<const float4*>(sc + 512 + h * kBN * 4 + 16 * lane);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
      if (HAS_MINS) {
        const uint32_t mw = *reinterpret_cast<const uint32_t*>(sc + kMinOff + f * kBN + 4 * lane);
        const float4 m4 = *reinterpret_cast<const float4*>(sc + 2048 + h * kBN * 4 + 16 * lane);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) m[c] = __fmul_rn(mv[c], static_cast<float>(ctq::sbyte(mw, c)));
      }
    }
  }
};

struct Smem {
  uint8_t* base;  // 1024-aligned
  __device__ __forceinline__ uint8_t* stage(int s) const { return base + s * kStageBytes; }
  __device__ __forceinline__ uint8_t* wtile(int s) const { return stage(s) + kXBytes; }
  __device__ __forceinline__ uint8_t* scales(int s) const {
    return stage(s) + kXBytes + kWBytes;
  }
  __device__ __forceinline__ uint8_t* btile(int i) const {
    return base + kStages * kStageBytes + i * kBTileBytes;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return smem_addr(base + kBarOff + 8 * s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return smem_addr(base + kBarOff + 8 * (kStages + s));
  }
  __device__ __forceinline__ float* mrows(int s) const {
    return reinterpret_cast<float*>(base + kMRowOff + s * kMRowBytes);
  }
};

// four bf16 values of B row kr (a K slot of the stage) at the thread's
// columns: N-major, atom nh of 64 columns, row kr of 128 bytes, 16-byte
// chunk c stored at c ^ (kr % 8) (the 128-byte swizzle); bt is the tile at
// the thread's atom and 8-byte half of its chunk
__device__ __forceinline__ void store_b(uint8_t* bt, int kr, int c, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(bt + kr * 128 + ((c ^ (kr & 7)) << 4)) =
      make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
}

// One consumer stage: the stage `it` of the block, its K step `step` (the
// block's steps start at s_beg), `last` the block's last. FOLD: the sum
// fold (wait for the stage's products, then acc += xsum @ M over its
// groups: the int8 grid's two groups of 32 rows, the ksplit halves' groups
// or the adjk tile's groups, a group that spans stages carried in cs until
// its last stage). KS, AJ: the ksplit or the adjk nibble tile (else the
// int8 grid).
template <int G, bool HAS_MINS, bool PLAIN_S, bool FOLD, bool KS, bool AJ>
__device__ __forceinline__ void consume(const Smem& sh, int it, int step, bool last, int wg,
                                        uint32_t (&af)[4][4], float (&acc)[2][32],
                                        float (&cs)[2][2]) {
  using S = Scales<G, HAS_MINS, PLAIN_S>;
  using KSS = KsScales<G, HAS_MINS, PLAIN_S>;
  constexpr bool kAddMins = HAS_MINS && !FOLD;
  // the fold: x columns of a group within the stage's columns (a box of 32
  // on ksplit, whose boxes are the two halves; the stage's 64 otherwise),
  // its groups in a stage, those with a bias (the ksplit high half without
  // mins has none), the K rows of a step and whether a group spans steps
  constexpr int kSpan = KS ? kXBox : kBK;
  constexpr int kGW = G < kSpan ? G : kSpan;
  constexpr int kNF = (KS ? 2 : 1) * (kSpan / kGW);
  constexpr int kNFB = KS && !HAS_MINS ? kNF / 2 : kNF;
  constexpr bool kCarry = G > kSpan;
  const int tid = threadIdx.x, lane = tid & 31, cw = tid >> 5;
  const int wl = cw & 3;
  const int st = it % kStages;
  mbar_wait(sh.full(st), (it / kStages) & 1);
  const uint8_t* sc = KS ? sh.wtile(st) + kKsWBytes : sh.scales(st);
  // the fold's f32 rows of M or B: the plain m rows of the scale slot, the
  // factored grid's M rows and the nibble tiles' bias rows (written below)
  float* mrow = KS   ? reinterpret_cast<float*>(sh.wtile(st) + kKsWBytes + KSS::kBiasOff)
                : AJ ? reinterpret_cast<float*>(sh.wtile(st) + kKsWBytes)
                : PLAIN_S ? reinterpret_cast<float*>(sh.scales(st) + 1024)
                          : sh.mrows(st);

  // 1. dequantize into the bf16 tile: the int8 grid's rows 8 cw .. 8 cw + 7,
  //    the ksplit byte rows 4 cw .. 4 cw + 3 (B rows of both halves), or the
  //    adjk byte rows 4 cw .. 4 cw + 3 (K rows 8 cw .. 8 cw + 7), at columns
  //    4 lane .. 4 lane + 3
  {
    const uint8_t* wt = sh.wtile(st);
    uint8_t* bt = sh.btile(it % kBTiles) + (lane >> 4) * kAtomBytes + ((lane & 1) << 3);
    const int c = (lane & 15) >> 1;
    if constexpr (KS) {
      const int j = (4 * cw) / kGW;  // the rows' group in each half
      float s[2][4], mn[2][4], b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        KSS::load(sc, h, j, lane, s[h], mn[h]);
#pragma unroll
        for (int q = 0; q < 4; ++q) b[h][q] = ctq::ksplit_bias<HAS_MINS>(s[h][q], mn[h][q], h == 1);
      }
      if (FOLD && (4 * cw) % kGW == 0) {  // the group's first rows write its bias rows
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float4*>(mrow + (h * KSS::kNGB + j) * kBN + 4 * lane) =
              make_float4(b[h][0], b[h][1], b[h][2], b[h][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * cw + r;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(wt + k * kBN + 4 * lane);
        float v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int byte = ctq::sbyte(w, q);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h][q] = __fmul_rn(static_cast<float>(ctq::ksplit_value(byte, h == 1)), s[h][q]);
            if (!FOLD && (HAS_MINS || h == 0)) v[h][q] = __fadd_rn(v[h][q], b[h][q]);
          }
        }
        store_b(bt, k_slot(k), c, v[0]);
        store_b(bt, k_slot(kKsRows + k), c, v[1]);
      }
    } else if constexpr (AJ) {
      const int gl = (8 * cw) / G;  // the rows' group in the stage
      float s[4], mn[4], b[4] = {};
      S::template load<HAS_MINS>(sc, gl, lane, s, mn);
      if (HAS_MINS) {
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = ctq::plain_bias(s[q], mn[q]);
        if (FOLD && (8 * cw) % kGW == 0)  // the group's first rows write its bias row
          *reinterpret_cast<float4*>(mrow + gl * kBN + 4 * lane) = make_float4(b[0], b[1], b[2], b[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int br = 4 * cw + r;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(wt + br * kBN + 4 * lane);
        float v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h][q] = __fmul_rn(static_cast<float>(ctq::nibble(w, 2 * q + h)), s[q]);
            if (kAddMins) v[h][q] = __fadd_rn(v[h][q], b[q]);
          }
        }
        store_b(bt, k_slot(2 * br), c, v[0]);
        store_b(bt, k_slot(2 * br + 1), c, v[1]);
      }
    } else {
      const int gl = (8 * cw) / G;
      float s[4], mn[4];
      S::template load<kAddMins>(sc, gl, lane, s, mn);
      if constexpr (FOLD && !PLAIN_S) {
        if ((8 * cw) % G == 0) {  // the group's first rows write its row of M = sm * sub_m
          float s1[4], m1[4];
          S::template load<true>(sc, gl, lane, s1, m1);
          *reinterpret_cast<float4*>(mrow + gl * kBN + 4 * lane) =
              make_float4(m1[0], m1[1], m1[2], m1[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int k = 8 * cw + r;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(wt + k * kBN + 4 * lane);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = __fmul_rn(static_cast<float>(ctq::sbyte(w, j)), s[j]);
          if (kAddMins) v[j] = __fadd_rn(v[j], mn[j]);
        }
        store_b(bt, k_slot(k), c, v);
      }
    }
  }

  // 2. this warpgroup's x rows as wgmma A fragments. The fragment's rows
  //    g8 and g8 + 8 of the warp's 16 are tokens ra and ra + 8 (rows
  //    permuted so that the 8 lanes of a quarter-warp read 8 distinct
  //    chunks of the swizzled boxes), and its K slots 2q, 2q + 1, 2q + 8,
  //    2q + 9 of a 16-row step hold x columns 4q .. 4q + 3 (one 16-byte
  //    load; the weight tile's rows are permuted to match); with the fold,
  //    the rows' f32 sums over each group's kGW columns of the stage
  const int g8 = lane >> 2, q = lane & 3;
  const int ra = wg * 64 + wl * 16 + token_row(g8);
  float gs[kNF][2] = {};
  {
    const uint8_t* xt = sh.stage(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint8_t* box = xt + (kk >> 1) * kXHalf;
      const int c = (kk & 1) * 4 + q;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = ra + 8 * hr;
        const float4 v = *reinterpret_cast<const float4*>(box + row * 128 + ((c ^ (row & 7)) << 4));
        af[kk][hr] = bf16x2(v.x, v.y);
        af[kk][2 + hr] = bf16x2(v.z, v.w);
        if (FOLD) {
          const int f = kk / (kGW / 16);
          gs[f][hr] = __fadd_rn(gs[f][hr], __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w)));
        }
      }
    }
    if (FOLD) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
#pragma unroll
        for (int gi = 0; gi < kNFB; ++gi) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            gs[gi][hr] = __fadd_rn(gs[gi][hr], __shfl_xor_sync(0xffffffffu, gs[gi][hr], o));
        }
      }
    }
  }
  if (!FOLD) mbar_arrive(sh.empty(st));  // the stage is in registers and the bf16 tile

  // 3. the stage's products, once every consumer has written the bf16 tile
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();
  {
    const uint32_t bt = smem_addr(sh.btile(it % kBTiles));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16(acc[0], acc[1], af[kk], b_desc(bt + kk * 2048));
    wgmma_commit();
    if (FOLD) {
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      // acc += xsum @ M: the thread's rows ra, ra + 8 and columns
      // 64 nh + 8 j + 2 q (+1), M's rows from mrow; a group that spans
      // steps: its sum so far, added at its last step
      const bool flush = !kCarry || last || ((step + 1) * kSpan) % G == 0;
#pragma unroll
      for (int gi = 0; gi < kNFB; ++gi) {
        float g0 = gs[gi][0], g1 = gs[gi][1];
        if (kCarry) {
          g0 = cs[gi][0] = __fadd_rn(cs[gi][0], g0);
          g1 = cs[gi][1] = __fadd_rn(cs[gi][1], g1);
          if (!flush) continue;
          cs[gi][0] = cs[gi][1] = 0.f;
        }
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 mm =
                *reinterpret_cast<const float2*>(mrow + gi * kBN + nh * 64 + 8 * j + 2 * q);
            acc[nh][4 * j] = fmaf(g0, mm.x, acc[nh][4 * j]);
            acc[nh][4 * j + 1] = fmaf(g0, mm.y, acc[nh][4 * j + 1]);
            acc[nh][4 * j + 2] = fmaf(g1, mm.x, acc[nh][4 * j + 2]);
            acc[nh][4 * j + 3] = fmaf(g1, mm.y, acc[nh][4 * j + 3]);
          }
        }
      }
    } else {
      wgmma_wait<1>();  // the stage before: its A registers and bf16 tile are free
    }
  }
  if (FOLD) mbar_arrive(sh.empty(st));
}

// The shared memory a block of an instantiation takes: the factored grid's
// fold adds its M rows.
template <bool PLAIN_S, bool FOLD, bool KS, bool AJ>
constexpr size_t kSmemOf = FOLD && !PLAIN_S && !KS && !AJ ? kSmemMRowsBytes : kSmemBytes;

template <int G, bool HAS_MINS, bool PLAIN_S, bool FOLD, bool KS, bool AJ>
__global__ void __cluster_dims__(1, 1, kSplit) __launch_bounds__(kThreads, 1)
grid_gemm_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const Params p) {
  static_assert(!(KS && AJ), "one weight tile");
  static_assert(KS || AJ || !FOLD || (HAS_MINS && G == 32),
                "the int8 grid's fold: group 32 with mins");
  static_assert(!AJ || ((PLAIN_S ? G == 32 || G == 64 || G == 128 : G == 16 || G == 32) &&
                        (HAS_MINS || !FOLD)),
                "the adjk tile: plain groups of 32 to 128 rows or factored groups of 16 or "
                "32, a fold only of a bias");
  using S = Scales<G, HAS_MINS, PLAIN_S>;
  using KSS = KsScales<G, HAS_MINS, PLAIN_S>;
  extern __shared__ uint8_t smem_raw[];
  Smem sh;
  {
    const uint32_t a = smem_addr(smem_raw);
    sh.base = smem_raw + (((a + 1023) & ~1023u) - a);
  }
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, row0 = blockIdx.y * kBM;
  const uint32_t rank = cluster_rank();
  // this block's share of the K steps (shares differ by one at most; a
  // nibble step is 32 byte rows, 64 K rows as an int8-grid step)
  const int steps = p.kp / kBK;
  const int s_beg = rank * steps / kSplit;
  const int n_iter = (rank + 1) * steps / kSplit - s_beg;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sh.full(s), 1);
      mbar_init(sh.empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform in the compiler's view (a branch on
  // threadIdx itself would make it serialize the wgmma instructions)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers / 128) {
    // the producer warp: one thread issues every copy
    if (tid == kConsumers) {
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(sh.empty(st), (it / kStages - 1) & 1);
        const uint32_t bar = sh.full(st);
        const uint32_t xs = smem_addr(sh.stage(st));
        if constexpr (KS) {  // byte rows r0 .. r0 + 31: x columns r0 and kp/2 + r0 on
          const int r0 = (s_beg + it) * kKsRows, half = p.kp / 2;
          mbar_expect_tx(bar, kXBytes + kKsWBytes + KSS::kBytes);
          tma_2d(xs, &tx, r0, row0, bar);
          tma_2d(xs + kXHalf, &tx, half + r0, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, r0, bar);
          KSS::copy(p, r0, half, n0, smem_addr(sh.wtile(st)) + kKsWBytes, bar);
        } else if constexpr (AJ) {  // K rows k0 .. k0 + 63: byte rows k0/2 .. k0/2 + 31
          const int k0 = (s_beg + it) * kBK;
          mbar_expect_tx(bar, kXBytes + kKsWBytes + S::kBytes);
          tma_2d(xs, &tx, k0, row0, bar);
          tma_2d(xs + kXHalf, &tx, k0 + kXBox, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, k0 / 2, bar);
          S::copy(p, k0, n0, smem_addr(sh.scales(st)), bar);
        } else {
          const int k0 = (s_beg + it) * kBK;
          mbar_expect_tx(bar, kXBytes + kWBytes + S::kBytes);
          tma_2d(xs, &tx, k0, row0, bar);
          tma_2d(xs + kXHalf, &tx, k0 + kXBox, row0, bar);
          tma_2d(smem_addr(sh.wtile(st)), &tw, n0, k0, bar);
          S::copy(p, k0, n0, smem_addr(sh.scales(st)), bar);
        }
      }
    }
  } else {
    float acc[2][32];
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nh][i] = 0.f;
    }
    // two sets of A registers: a stage's products may still read one set
    // while the next stage fills the other
    uint32_t af0[4][4], af1[4][4];
    float cs[2][2] = {};  // the fold's carried group sums (groups that span steps)
    for (int it = 0; it < n_iter; it += 2) {
      consume<G, HAS_MINS, PLAIN_S, FOLD, KS, AJ>(sh, it, s_beg + it, it + 1 == n_iter, wg, af0,
                                                  acc, cs);
      if (it + 1 < n_iter)
        consume<G, HAS_MINS, PLAIN_S, FOLD, KS, AJ>(sh, it + 1, s_beg + it + 1, it + 2 == n_iter,
                                                    wg, af1, acc, cs);
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    consumers_sync();  // every stage read: the ring takes the partial tile
    float* part = reinterpret_cast<float*>(sh.base);
    {
      const int lane = tid & 31, g8 = lane >> 2, q = lane & 3;
      const int ra = wg * 64 + ((tid >> 5) & 3) * 16 + token_row(g8);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = nh * 64 + 8 * j + 2 * q;
          *reinterpret_cast<float2*>(part + ra * kPLd + col) =
              make_float2(acc[nh][4 * j], acc[nh][4 * j + 1]);
          *reinterpret_cast<float2*>(part + (ra + 8) * kPLd + col) =
              make_float2(acc[nh][4 * j + 2], acc[nh][4 * j + 3]);
        }
      }
    }
  }
  cluster_sync();  // every block's partial tile is written
  if (tid < kConsumers) {
    // block `rank` sums its share of the rows of the cluster's partial
    // tiles in rank order and writes them
    const uint32_t part = smem_addr(sh.base);
    const int r_beg = rank * kBM / kSplit, r_end = (rank + 1) * kBM / kSplit;
    for (int f = tid; f < (r_end - r_beg) * (kBN / 4); f += kConsumers) {
      const int r = r_beg + f / (kBN / 4), c = (f % (kBN / 4)) * 4;
      if (row0 + r < p.m) {
        const uint32_t off = part + (r * kPLd + c) * 4;
        float4 sum = ld_cluster(off, 0);
#pragma unroll
        for (uint32_t src = 1; src < kSplit; ++src) {
          const float4 v = ld_cluster(off, src);
          sum.x = __fadd_rn(sum.x, v.x);
          sum.y = __fadd_rn(sum.y, v.y);
          sum.z = __fadd_rn(sum.z, v.z);
          sum.w = __fadd_rn(sum.w, v.w);
        }
        *reinterpret_cast<float4*>(p.out + (size_t)(row0 + r) * p.np + n0 + c) = sum;
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link to libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// x (m, kp) f32 in boxes of 32 columns x 128 rows, 128-byte swizzle, rows
// past m read as zeros; the weight, wrows x np bytes (the grid: kp; ksplit
// nibbles: kp / 2), in boxes of wbox rows x 128 columns, as stored
inline bool make_maps(CUtensorMap* tx, CUtensorMap* tw, const float* x, const int8_t* qs,
                      int m, int kp, int np, int wrows, int wbox) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(m)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(kp) * 4};
  const cuuint32_t xbox[2] = {kXBox, kBM};
  if (enc(tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), xdim, xstride, xbox, one,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(np), static_cast<cuuint64_t>(wrows)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(np)};
  const cuuint32_t wboxes[2] = {kBN, static_cast<cuuint32_t>(wbox)};
  return enc(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(qs), wdim, wstride, wboxes,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Launch over an (m, np) output: (np / 128, ceil(m / 128), 3) blocks in
// clusters of 3 along K. kp a multiple of 256, np of 128 (the QTensor's
// padding). KS, AJ: qs is the (kp / 2, np) ksplit or adjk nibble plane.
// Returns a CUDA error code.
template <int G, bool HAS_MINS, bool PLAIN_S, bool FOLD, bool KS = false, bool AJ = false>
int launch_core(const float* x, const int8_t* qs, const Params& p, cudaStream_t stream) {
  if (p.m <= 0 || p.kp % kBK || p.kp / kBK < kSplit || p.np % kBN) return cudaErrorInvalidValue;
  constexpr bool kNibbles = KS || AJ;
  CUtensorMap tx, tw;
  if (!make_maps(&tx, &tw, x, qs, p.m, p.kp, p.np, kNibbles ? p.kp / 2 : p.kp,
                 kNibbles ? kKsRows : kBK))
    return cudaErrorInvalidValue;
  auto kern = grid_gemm_kernel<G, HAS_MINS, PLAIN_S, FOLD, KS, AJ>;
  constexpr size_t smem = kSmemOf<PLAIN_S, FOLD, KS, AJ>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(p.np / kBN, (p.m + kBM - 1) / kBM, kSplit);
  kern<<<grid, kThreads, smem, stream>>>(tx, tw, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctw
