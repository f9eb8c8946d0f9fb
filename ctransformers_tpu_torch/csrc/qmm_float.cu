// Quantized matmuls on float activations for small m (decode and short
// chunks): the grouped dot "g" on every served layout, the f32
// dequantize-and-dot modes "" and "s" on the int8 grids and ksplit
// nibbles, and "sb" on ksplit nibbles (at m > 32 on the Hopper core).
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_g_kernel (mode "g")  -> ct_qmm_g, ct_qmm_g_gptq, ct_qmm_g_q4_0,
//                                ct_qmm_g_k16, ct_qmm_g8, ct_qmm_g8_legacy
//       out = sum_g s[g,n] * dot_g(bf16(x), w)[t,n] + xsum @ B
//       x rounded to bf16, the grid values w (nibbles w4 = q + zp - 8, or
//       the int8 grid q) exact in bf16, products exact in f32 and summed in
//       f32 inside a group, the f32 scale applied to the group's partial
//       sum. B = 8 * s + m for nibbles with mins (Q4_K, Q2_K, GPTQ4, Q4_1),
//       m for grids with mins, absent for Q4_0 and Q3_K (zero point 8, the
//       reference's g_bias False), Q6_K, Q8_0 and Q5_0; xsum are the f32
//       group sums of the unrounded x.
//   _qmm_kernel   (mode "",  f32 dots)  -> ct_qmm_f, ct_qmm_f_legacy
//       out = x @ (q * s + m), all f32 (no TF32: plain f32 multiply-adds)
//   _qmm_s_kernel (mode "s", f32 dots)  -> ct_qmm_s, ct_qmm_s_legacy
//       out = x @ (q * s) + xsum @ M, all f32
//   _qmm_pack4_kernel   (mode "",  f32 dots) -> ct_qmm_f_ks
//       out = x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), all f32
//   _qmm_pack4_s_kernel (mode "s", f32 dots) -> ct_qmm_s_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + x_lo @ (l * s) + x_hi @ (f * s)
//       on the ksplit nibbles of every kind (qmm_common.cuh): x_lo, x_hi the
//       two halves of x's columns, xs their f32 group sums; one symbol per
//       mode reads the layout from its ints (ctq::dispatch_ksplit)
//   _qmm_pack4_s_kernel (mode "sb", bf16 dots) -> ct_qmm_sb_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + bf16(x) @ bf16(v * s): at
//       m <= 32 this file's ksplit design with x rounded to bf16 as it is
//       staged and each v * s rounded to bf16 before the f32 product (a
//       bf16 x bf16 product is exact in f32: the tensor core's products,
//       summed in a fixed order); at m > 32 the Hopper core's ksplit
//       nibble tile (qmm_wgmma.cuh)
// The scale planes are the k-quants' int8 sub-scales times f32 superblock
// factors (Q4_K at group 32, Q2_K and Q3_K at 16, the grids), or (PLAIN_S: GPTQ4, Q4_1, Q4_0 and the legacy
// grids Q8_0, Q5_0, Q5_1, the reference's sfactor == 0 branches) f32
// (kp/G, np) planes s and m read as they are.
//
// Bound on an H100: bytes at decode. The card does ~20 f32 operations
// outside the tensor cores per byte it reads (67 TFLOP/s over 3.35 TB/s);
// an int8-grid byte feeds 2 m of them, so "" and "s" are bound by bytes up
// to m = 8 and by f32 operations above, and "g" (bf16 operands, ~295
// operations per byte) by bytes at every m it is offered for (m <= 32).
// This simple version multiplies on the f32 pipes for all three modes.
// "g" and "" on the factored grids (ct_qmm_g8, ct_qmm_f) and "g" on Q4_K
// (ct_qmm_g) take another design at m <= 32: K split over a thread-block
// cluster, the weight stream kept in flight by a cp.async ring
// (qmm_splitk.cuh).
// Design: that of qmm_decode.cu. A block owns 32
// output columns and ALL of K, so every output element is summed by one
// block in a fixed order (no atomics, no split-K: runs are bitwise
// repeatable). Its 256 threads lie 8 across the columns (4 columns each,
// one 32-bit load per storage row) and 32 down K; a K lane takes 32 rows
// per chunk, or a whole group of 16 rows (Q6_K's grid, Q2_K's and Q3_K's
// nibbles). The block
// stages the chunk's activations in shared memory as f32 (rounded to bf16
// first for "g"), with the group sums of the unrounded x, which it reduces
// over the G/4 neighbouring threads of a group with an xor butterfly: every
// thread adds the same pairs in the same order. A GPTQ group of 64 or 128
// rows spans 2 or 4 K lanes of one warp: their partial sums are added with
// shuffles BEFORE the one multiply by s, as the reference scales the whole
// group's dot. f32 activations take four times the shared memory of the
// int8 ones of qmm_decode.cu (8 rows x 1024 x 4 B = 32 KB), so the staging
// buffers and the final K-lane reduction share one union, inside the 48 KB
// static limit (static_assert below). A ksplit lane takes 16 byte rows a
// chunk: it reads each byte once and uses both nibbles, the low one against
// x[:, r] and the high one against x[:, r + kp/2], so a chunk stages 512
// columns of each half (the same 32 KB at 8 rows), and each of its rows
// needs the scale and bias of its group in both halves (read per column;
// a group of 32 to 128 rows is 2 to 8 lanes, whose first adds the "s"
// mode's xs @ B term once).
#include <cuda_bf16.h>

#include "qmm_common.cuh"
#include "qmm_splitk.cuh"
#include "qmm_wgmma.cuh"

namespace {

constexpr int kTN = 32;                 // output columns per block
constexpr int kThreads = 256;
constexpr int kCQ = kTN / 4;            // column quads per block
constexpr int kGL = kThreads / kCQ;     // K lanes

// kModeSB: "s" on bf16 operands (ksplit only): x rounded to bf16 as it is
// staged, v * s rounded to bf16
enum Mode { kModeG, kModeF, kModeS, kModeSB };
// the weight's layout: an int8 grid (kp, np), or adjk or ksplit nibbles (kp/2, np)
enum Layout { kGrid, kAdjk, kKsplit };

template <int MT, int KC, int NG>
union FloatSmem {
  struct {
    float x[MT][KC];
    float xs[MT][NG];
  } in;
  float red[kGL][MT][kTN];
};

// Two blocks per SM are asked for (128 registers at 8 rows, 2 x 33 KB of
// shared memory): a shape of 4096 columns is only 128 blocks on 132 SMs,
// each a chain of dependent chunk loads, and with this bound the compiler
// schedules the chunk's loads so that the m = 1 kernels run 25-30% faster
// there (and the grouped dot on Q6_K no longer 2.6x slower than ""; timed
// on an H100, PERF.md).
// LAYOUT: an int8 grid (kp, np), or adjk or ksplit nibbles (kp/2, np).
// PLAIN_S: s and m are the f32 (kp/G, np) planes sd and sm themselves, else
// int8 sub-scales times f32 superblock factors. HAS_MINS: a min plane; a
// nibble weight without one is Q4_0's or Q3_K's (zero point 8: no bias in
// adjk, -8 s in the low half of ksplit).
template <int MT, int MODE, int LAYOUT, bool PLAIN_S, int G, bool HAS_MINS>
__global__ void __launch_bounds__(kThreads, 2)
qmm_float_kernel(const float* __restrict__ x,       // (m, kp) f32
                 const int8_t* __restrict__ qs,     // (kp/2, np) nibbles or (kp, np) grid
                 const int8_t* __restrict__ sub_s,  // (kp/G, np)        [!PLAIN_S]
                 const int8_t* __restrict__ sub_m,  // (kp/G, np)        [!PLAIN_S, HAS_MINS]
                 const float* __restrict__ sd,      // (kp/256, np); PLAIN_S: s (kp/G, np)
                 const float* __restrict__ sm,      // (kp/256, np); PLAIN_S: m [HAS_MINS]
                 float* __restrict__ out,           // (m, np)
                 int m, int kp, int np) {
  constexpr bool kPacked = LAYOUT == kAdjk;
  constexpr bool kKs = LAYOUT == kKsplit;
  constexpr int kLR = kKs ? 16 : (G < 32 ? G : 32);  // K (ksplit: byte) rows per lane and chunk
  constexpr int kKC = kGL * kLR;        // K (ksplit: byte) rows per chunk
  constexpr int kLPG = G / kLR;         // K lanes per group
  constexpr int kNG = kKC / G;          // groups per chunk (ksplit: of each half)
  constexpr int kXC = kKs ? 2 * kKC : kKC;  // activation columns staged per chunk
  constexpr int kXG = kKs ? 2 * kNG : kNG;  // their groups
  constexpr int kQT = G / 4;            // threads holding one group while staging
  constexpr int kSF = ctq::kSuperblock / G;  // groups per superblock (factored planes)
  // the xsum @ B term: adjk nibbles with mins re-bias by 8 * s + m, grids
  // add m, ksplit adds each half's bias (the low half's on every kind);
  // Q4_0's adjk nibbles and the grids without mins have no bias
  constexpr bool kBias = MODE != kModeF && (HAS_MINS || kKs);
  static_assert(!kPacked || (G % 32 == 0 && 32 * (32 / kCQ) % G == 0) || (!PLAIN_S && G == 16),
                "a nibble group is 1, 2 or 4 K lanes of one warp, or one lane (group 16)");
  static_assert(LAYOUT == kGrid || HAS_MINS || (PLAIN_S && G == 32) || (!PLAIN_S && G == 16),
                "a nibble weight without mins is Q4_0 (plain planes, group 32) or Q3_K "
                "(factored, group 16)");
  static_assert(LAYOUT != kGrid || kLPG == 1, "an int8-grid group is one K lane");
  static_assert(PLAIN_S || LAYOUT == kGrid || G == ctq::kGroup || G == 16,
                "factored nibble groups are 32 rows (Q4_K) or 16 (Q2_K, Q3_K)");
  static_assert(!PLAIN_S || LAYOUT != kGrid || G == 32, "the legacy grids' groups are 32 rows");
  static_assert(MODE == kModeG || !kPacked, "\"\" and \"s\" are int8-grid and ksplit modes");
  static_assert(MODE != kModeG || !kKs, "ksplit takes the modes \"\", \"s\" and \"sb\"");
  static_assert(MODE != kModeSB || kKs, "\"sb\" is this file's on ksplit nibbles only");
  static_assert(!kKs || (kKC % G == 0 && G % kLR == 0), "a ksplit group is 1 to 8 whole lanes");
  static_assert(4 * kThreads >= kXC, "one float4 per thread stages a chunk");
  static_assert(sizeof(FloatSmem<MT, kXC, kXG>) <= 48 * 1024, "static shared memory limit");
  __shared__ FloatSmem<MT, kXC, kXG> sh;
  const int tid = threadIdx.x;
  const int cq = tid % kCQ;
  const int gl = tid / kCQ;
  const int n = blockIdx.x * kTN + 4 * cq;  // first of this thread's columns
  const int t0 = blockIdx.y * MT;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  const int rows = kKs ? kp / 2 : kp;  // storage rows the chunks walk
  for (int k0 = 0; k0 < rows; k0 += kKC) {
    // ---- stage this chunk's activations and the group sums of x ----
    {
      // thread tid holds x[k0 + 4*tid .. +3] (ksplit: the low half's columns,
      // then from kKC on the high half's, x[kp/2 + k0 + ..]); G/4
      // neighbouring threads = 1 group (512 is a multiple of G, so a group
      // never straddles the two halves)
      const int kk = 4 * tid;
      const bool mine = kk < kXC;
      const bool second = kKs && kk >= kKC;
      const int kr = k0 + kk - (second ? kKC : 0);  // storage row of the column
      const int col = kr + (second ? kp / 2 : 0);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mine && t < m && kr < rows)
          v = __ldg(reinterpret_cast<const float4*>(x + (size_t)t * kp + col));
        if (kBias) {
          float sum = __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
#pragma unroll
          for (int off = 1; off < kQT; off <<= 1)
            sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
          if (mine && tid % kQT == 0) sh.in.xs[i][kk / G] = sum;
        }
        if (MODE == kModeG || MODE == kModeSB) {
          v.x = __bfloat162float(__float2bfloat16(v.x));
          v.y = __bfloat162float(__float2bfloat16(v.y));
          v.z = __bfloat162float(__float2bfloat16(v.z));
          v.w = __bfloat162float(__float2bfloat16(v.w));
        }
        if (mine) *reinterpret_cast<float4*>(&sh.in.x[i][kk]) = v;
      }
    }
    __syncthreads();

    if constexpr (kKs) {
      // ---- one lane of kLR byte rows: both nibbles of each byte, f32 dots ----
      const int half = kp / 2;
      const int r0 = k0 + gl * kLR;  // first byte row of this lane
      if (r0 < half) {
        const int gi = gl * kLR / G;  // the lane's group in the chunk (each half)
        float s_lo[4], b_lo[4], s_hi[4], b_hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float mv;
          ctq::group_sm<PLAIN_S ? 0 : kSF, HAS_MINS>(sub_s, sub_m, sd, sm, np, r0 / G, n + c,
                                                     &s_lo[c], &mv);
          b_lo[c] = ctq::ksplit_bias<HAS_MINS>(s_lo[c], mv, false);
          ctq::group_sm<PLAIN_S ? 0 : kSF, HAS_MINS>(sub_s, sub_m, sd, sm, np, (r0 + half) / G,
                                                     n + c, &s_hi[c], &mv);
          b_hi[c] = ctq::ksplit_bias<HAS_MINS>(s_hi[c], mv, true);
        }
        const int8_t* qrow = qs + (size_t)r0 * np + n;
        uint32_t w[kLR];
#pragma unroll
        for (int r = 0; r < kLR; ++r)
          w[r] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)r * np));
        // the lane sums into acc directly: a chunk's partial sums would hold
        // 32 more registers at 8 rows (the f32 sums' order is the kernel's own)
#pragma unroll
        for (int r = 0; r < kLR; ++r) {
          float wl[4], wh[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int b = ctq::sbyte(w[r], c);
            // l * s (+ B_lo), f * s (+ B_hi), rounded as the reference's
            wl[c] = __fmul_rn(static_cast<float>(ctq::ksplit_value(b, false)), s_lo[c]);
            wh[c] = __fmul_rn(static_cast<float>(ctq::ksplit_value(b, true)), s_hi[c]);
            if (MODE == kModeF) {
              wl[c] = __fadd_rn(wl[c], b_lo[c]);
              wh[c] = __fadd_rn(wh[c], b_hi[c]);
            }
            if (MODE == kModeSB) {  // the bf16 operand
              wl[c] = __bfloat162float(__float2bfloat16(wl[c]));
              wh[c] = __bfloat162float(__float2bfloat16(wh[c]));
            }
          }
          const int kl = gl * kLR + r;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xl = sh.in.x[i][kl];
            const float xh = sh.in.x[i][kKC + kl];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xh, wh[c], fmaf(xl, wl[c], acc[i][c]));
          }
        }
        // "s", "sb": the group's first lane adds each half's xs @ B once
        if (kBias && (gl * kLR) % G == 0) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(sh.in.xs[i][gi], b_lo[c]));
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(sh.in.xs[i][kNG + gi], b_hi[c]));
            }
          }
        }
      }
    } else {
    // ---- one lane of kLR rows: f32 dots against the decoded weights ----
    const int r0 = k0 + gl * kLR;  // first K row of this lane
    const bool live = r0 < kp;     // whole warps: kp is a 256-multiple
    const int g = r0 / G;
    float part[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    // the lane that folds the group's scale and bias needs them; "" and "s"
    // need them for every weight
    if (live && gl % kLPG == 0) {
      if (PLAIN_S) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(sd + (size_t)g * np + n));
        s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
        if (HAS_MINS) {
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(sm + (size_t)g * np + n));
          const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = kPacked ? ctq::plain_bias(s[c], mv[c]) : mv[c];
        }
      } else {
        const uint32_t sw = __ldg(reinterpret_cast<const unsigned int*>(sub_s + (size_t)g * np + n));
        const size_t fo = (size_t)(g / kSF) * np + n;
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(sd + fo));
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        if (HAS_MINS) {
          const uint32_t mw = __ldg(reinterpret_cast<const unsigned int*>(sub_m + (size_t)g * np + n));
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(sm + fo));
          const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (kPacked) {
              ctq::group_scale(dv[c], ctq::sbyte(sw, c), mv[c], ctq::sbyte(mw, c), &s[c], &b[c]);
            } else {
              s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
              b[c] = __fmul_rn(mv[c], static_cast<float>(ctq::sbyte(mw, c)));
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
        }
      }
    }
    if (live) {
      if (kPacked) {
        const int8_t* qrow = qs + (size_t)(r0 / 2) * np + n;
        uint32_t w[kLR / 2];
#pragma unroll
        for (int rr = 0; rr < kLR / 2; ++rr)
          w[rr] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)rr * np));
#pragma unroll
        for (int rr = 0; rr < kLR / 2; ++rr) {
          float w0[4], w1[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            w0[c] = static_cast<float>(ctq::nibble(w[rr], 2 * c));
            w1[c] = static_cast<float>(ctq::nibble(w[rr], 2 * c + 1));
          }
          const int kl = gl * kLR + 2 * rr;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float x0 = sh.in.x[i][kl];
            const float x1 = sh.in.x[i][kl + 1];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[i][c] = fmaf(x1, w1[c], fmaf(x0, w0[c], part[i][c]));
          }
        }
      } else {
        const int8_t* qrow = qs + (size_t)r0 * np + n;
        uint32_t w[kLR];
#pragma unroll
        for (int r = 0; r < kLR; ++r)
          w[r] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)r * np));
#pragma unroll
        for (int r = 0; r < kLR; ++r) {
          float wv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            wv[c] = static_cast<float>(ctq::sbyte(w[r], c));
            // "" and "s" dequantize each weight: q * s (+ m), rounded as the
            // reference's f32 multiply and add
            if (MODE != kModeG) wv[c] = __fmul_rn(wv[c], s[c]);
            if (MODE == kModeF && HAS_MINS) wv[c] = __fadd_rn(wv[c], b[c]);
          }
          const int kl = gl * kLR + r;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xv = sh.in.x[i][kl];
#pragma unroll
            for (int c = 0; c < 4; ++c) part[i][c] = fmaf(xv, wv[c], part[i][c]);
          }
        }
      }
    }
    if (kLPG > 1) {
      // the group's lanes are threads kCQ apart in one warp; the butterfly
      // adds the same pairs in every lane, so the group's first lane holds
      // a sum taken in a fixed order
#pragma unroll
      for (int off = kCQ; off < kCQ * kLPG; off <<= 1)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[i][c] = __fadd_rn(part[i][c], __shfl_xor_sync(0xffffffffu, part[i][c], off));
    }
    if (live && gl % kLPG == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xsv = kBias ? sh.in.xs[i][gl / kLPG] : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = MODE == kModeG ? __fmul_rn(part[i][c], s[c]) : part[i][c];
          if (kBias) v = __fadd_rn(v, __fmul_rn(xsv, b[c]));
          acc[i][c] = __fadd_rn(acc[i][c], v);
        }
      }
    }
    }  // adjk nibbles and int8 grids
    __syncthreads();
  }

  // ---- fixed-order reduction of the K lanes (the staging buffers are dead) ----
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) sh.red[gl][i][4 * cq + c] = acc[i][c];
  __syncthreads();
  for (int e = tid; e < MT * kTN; e += kThreads) {
    const int i = e / kTN, col = e % kTN;
    const int t = t0 + i;
    float v = 0.0f;
    for (int l = 0; l < kGL; ++l) v = __fadd_rn(v, sh.red[l][i][col]);
    if (t < m) out[(size_t)t * np + blockIdx.x * kTN + col] = v;
  }
}

template <int MODE, int LAYOUT, bool PLAIN_S, int G, bool HAS_MINS>
int launch(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
           const float* sd, const float* sm, float* out, int m, int kp, int np,
           cudaStream_t stream) {
  if (m == 1) {
    dim3 grid(np / kTN, 1);
    qmm_float_kernel<1, MODE, LAYOUT, PLAIN_S, G, HAS_MINS><<<grid, kThreads, 0, stream>>>(
        x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  } else {
    constexpr int MT = 8;
    dim3 grid(np / kTN, (m + MT - 1) / MT);
    qmm_float_kernel<MT, MODE, LAYOUT, PLAIN_S, G, HAS_MINS><<<grid, kThreads, 0, stream>>>(
        x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ksplit kernel of a layout dispatch_ksplit names.
template <int MODE>
struct KsplitFloat {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    return launch<MODE, kKsplit, SF == 0, G, HAS_MINS>(x, qs, sub_s, sub_m, sd, sm, out, m, kp,
                                                       np, st);
  }
};

// ct_qmm_sb_ks of a layout dispatch_ksplit names: this file's design at
// m <= 32 (a block owns 32 columns and all of K: the weight's bytes bound
// these m, and a 128-row MMA tile would waste its rows), the Hopper core's
// ksplit nibble tile with the sum fold above
struct KsplitSb {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    if (m <= 32)
      return launch<kModeSB, kKsplit, SF == 0, G, HAS_MINS>(x, qs, sub_s, sub_m, sd, sm, out, m,
                                                            kp, np, st);
    const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
    return ctw::launch_core<G, HAS_MINS, SF == 0, true, true>(x, qs, p, st);
  }
};

// factored int8 grids: group 16 without mins (Q6_K) or 32 with mins (Q5_K);
// "g" and "" at m <= 32 on the K split of qmm_splitk.cuh, the rest on this
// file's design.
template <int MODE>
int launch_grid(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                const float* sd, const float* sm, float* out, int m, int kp, int np,
                int group, cudaStream_t stream) {
  constexpr bool kSplit = MODE == kModeG || MODE == kModeF;
  const bool split = kSplit && m >= 1 && m <= ctsk::kMaxM;
  if (group == 16 && sub_m == nullptr) {
    if constexpr (kSplit)
      if (split)
        return ctsk::run<MODE == kModeG, 16, false>(x, qs, sub_s, nullptr, sd, nullptr, out, m,
                                                    kp, np, stream);
    return launch<MODE, kGrid, false, 16, false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                                 stream);
  }
  if (group == 32 && sub_m != nullptr) {
    if constexpr (kSplit)
      if (split)
        return ctsk::run<MODE == kModeG, 32, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                                   stream);
    return launch<MODE, kGrid, false, 32, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                                stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the legacy int8 grids: group 32, f32 planes s and mn, mn null exactly when
// has_mins is 0 (Q8_0, Q5_0; Q5_1 has mins).
template <int MODE>
int launch_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                  float* out, int m, int kp, int np, int has_mins, cudaStream_t stream) {
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (has_mins)
    return launch<MODE, kGrid, true, 32, true>(x, qs, nullptr, nullptr, s, mn, out, m, kp, np,
                                               stream);
  return launch<MODE, kGrid, true, 32, false>(x, qs, nullptr, nullptr, s, nullptr, out, m, kp,
                                              np, stream);
}

// Q2_K (has_mins 1: sub_m and sm given) and Q3_K (has_mins 0: both null):
// factored nibbles at group 16; a flag that disagrees with the pointers is
// refused.
template <int MODE>
int launch_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               int has_mins, cudaStream_t stream) {
  if (has_mins != (sub_m != nullptr) || has_mins != (sm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (has_mins)
    return launch<MODE, kAdjk, false, 16, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                               stream);
  return launch<MODE, kAdjk, false, 16, false>(x, qs, sub_s, nullptr, sd, nullptr, out, m, kp,
                                              np, stream);
}

}  // namespace

extern "C" {

// mode "g" on Q4_K: x f32 (m, kp); at m <= 32 the K split of
// qmm_splitk.cuh (which refuses a null plane).
int ct_qmm_g(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
             const float* sd, const float* sm, float* out, int m, int kp, int np,
             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m >= 1 && m <= ctsk::kMaxM)
    return ctsk::run_nibble<false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, st);
  return launch<kModeG, kAdjk, false, ctq::kGroup, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp,
                                                       np, st);
}

// the K split's plan for ct_qmm_g on Q4_K at batch size m: the cluster's
// blocks P, or a negative CUDA error code (m outside 1..32 among them)
int ct_qmm_g_split_plan(int m, int kp, int np) { return ctsk::nibble_plan_of<false>(m, kp, np); }

// the clusters of p blocks that the split's kernel for ct_qmm_g at batch
// size m runs on the card at once, or a negative CUDA error code
int ct_qmm_g_split_capacity(int m, int p) { return ctsk::nibble_capacity_of<false>(m, p); }

// mode "g" on Q2_K and Q3_K: sub-scales (and Q2_K's sub-mins) int8
// (kp/16, np), sd (and sm) f32 (kp/256, np).
int ct_qmm_g_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                 const float* sd, const float* sm, float* out, int m, int kp, int np,
                 int has_mins, void* stream) {
  return launch_k16<kModeG>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, has_mins,
                            static_cast<cudaStream_t>(stream));
}

// mode "g" on GPTQ4 and Q4_1: s and mn f32 (kp/group, np), group 32, 64 or 128.
int ct_qmm_g_gptq(const float* x, const int8_t* qs, const float* s, const float* mn,
                  float* out, int m, int kp, int np, int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 32:
      return launch<kModeG, kAdjk, true, 32, true>(x, qs, nullptr, nullptr, s, mn, out, m, kp, np,
                                                  st);
    case 64:
      return launch<kModeG, kAdjk, true, 64, true>(x, qs, nullptr, nullptr, s, mn, out, m, kp, np,
                                                  st);
    case 128:
      return launch<kModeG, kAdjk, true, 128, true>(x, qs, nullptr, nullptr, s, mn, out, m, kp, np,
                                                   st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// mode "g" on a factored int8 grid (Q6_K, Q5_K); at m <= 32 the K split of
// qmm_splitk.cuh.
int ct_qmm_g8(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
              const float* sd, const float* sm, float* out, int m, int kp, int np,
              int group, void* stream) {
  return launch_grid<kModeG>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                             static_cast<cudaStream_t>(stream));
}

// mode "": x @ (q * s + m) in f32 on a factored int8 grid; at m <= 32 the K
// split of qmm_splitk.cuh.
int ct_qmm_f(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
             const float* sd, const float* sm, float* out, int m, int kp, int np,
             int group, void* stream) {
  return launch_grid<kModeF>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                             static_cast<cudaStream_t>(stream));
}

// the K split's plan (qmm_splitk.cuh) for ct_qmm_g8 (g8 1) or ct_qmm_f (g8 0)
// at group 16 without mins (Q6_K) or 32 with them (Q5_K): the cluster's
// blocks P, or a negative CUDA error code (m outside 1..32 among them).
int ct_qmm_grid_split_plan(int g8, int group, int m, int kp, int np) {
  if (group == 16)
    return g8 ? ctsk::plan_of<true, 16, false>(m, kp, np) : ctsk::plan_of<false, 16, false>(m, kp, np);
  if (group == 32)
    return g8 ? ctsk::plan_of<true, 32, true>(m, kp, np) : ctsk::plan_of<false, 32, true>(m, kp, np);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// the clusters of p blocks the split's kernel for ct_qmm_g8 (g8 1) or
// ct_qmm_f at batch size m runs on the card at once (qmm_splitk.cuh), or a
// negative CUDA error code.
int ct_qmm_grid_split_capacity(int g8, int group, int m, int p) {
  if (group == 16)
    return g8 ? ctsk::capacity_of<true, 16, false>(m, p) : ctsk::capacity_of<false, 16, false>(m, p);
  if (group == 32)
    return g8 ? ctsk::capacity_of<true, 32, true>(m, p) : ctsk::capacity_of<false, 32, true>(m, p);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// mode "s": x @ (q * s) + xsum @ M in f32 on a factored int8 grid.
int ct_qmm_s(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
             const float* sd, const float* sm, float* out, int m, int kp, int np,
             int group, void* stream) {
  return launch_grid<kModeS>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                             static_cast<cudaStream_t>(stream));
}

// mode "g" on Q4_0: s f32 (kp/32, np); no mins (null), no bias.
int ct_qmm_g_q4_0(const float* x, const int8_t* qs, const float* s, const float*,
                  float* out, int m, int kp, int np, void* stream) {
  return launch<kModeG, kAdjk, true, 32, false>(x, qs, nullptr, nullptr, s, nullptr, out, m, kp,
                                               np, static_cast<cudaStream_t>(stream));
}

// modes "g", "" and "s" on a legacy int8 grid (Q8_0, Q5_0, Q5_1): s and mn
// f32 (kp/32, np), mn null exactly when has_mins is 0.
int ct_qmm_g8_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                     float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_legacy<kModeG>(x, qs, s, mn, out, m, kp, np, has_mins,
                               static_cast<cudaStream_t>(stream));
}

int ct_qmm_f_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                    float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_legacy<kModeF>(x, qs, s, mn, out, m, kp, np, has_mins,
                               static_cast<cudaStream_t>(stream));
}

int ct_qmm_s_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                    float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_legacy<kModeS>(x, qs, s, mn, out, m, kp, np, has_mins,
                               static_cast<cudaStream_t>(stream));
}

// modes "" and "s" on ksplit nibbles: scales and mins the QTensor's planes
// (int8 sub-planes where sfactor > 0, else f32 s and m), sd and sm its
// factors (null where sfactor is 0); group, has_mins, zp and sfactor name
// the layout (ctq::dispatch_ksplit refuses one there is not).
int ct_qmm_f_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(
      KsplitFloat<kModeF>{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, scales,
      mins, sd, sm, group, has_mins, zp, sfactor);
}

int ct_qmm_s_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(
      KsplitFloat<kModeS>{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, scales,
      mins, sd, sm, group, has_mins, zp, sfactor);
}

// mode "sb" on ksplit nibbles: xs_lo @ B_lo + xs_hi @ B_hi + bf16(x) @
// bf16(v * s), the design chosen by m (KsplitSb)
int ct_qmm_sb_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                 const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                 int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(
      KsplitSb{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, scales, mins, sd, sm,
      group, has_mins, zp, sfactor);
}

}  // extern "C"
