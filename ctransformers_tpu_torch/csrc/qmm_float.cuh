// The first design of the float-activation quantized matmuls at small m:
// qmm_float_kernel and its launch, one template over mode, weight layout,
// scale source and group. qmm_float.cu's symbols take it ("g", "" and
// "s" on the grids and nibbles, "sb" on ksplit nibbles at m <= 32), and
// qmm_ksplit.cu's ct_qmm_f_ks and ct_qmm_s_ks above m = 32.
//
// Bound on an H100: bytes at decode. The card does ~20 f32 operations
// outside the tensor cores per byte it reads (67 TFLOP/s over 3.35 TB/s);
// an int8-grid byte feeds 2 m of them, so "" and "s" are bound by bytes up
// to m = 8 and by f32 operations above, and "g" (bf16 operands, ~295
// operations per byte) by bytes at every m it is offered for (m <= 32).
// This simple version multiplies on the f32 pipes for all three modes.
// "g" and "" on the factored grids (ct_qmm_g8, ct_qmm_f), "g" on Q4_K
// (ct_qmm_g) and "" and "s" on ksplit nibbles (ct_qmm_f_ks, ct_qmm_s_ks)
// take another design at m <= 32: K split over a thread-block cluster, the
// weight stream kept in flight by a cp.async ring (qmm_splitk.cuh).
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
#pragma once

#include <cuda_bf16.h>

#include "qmm_common.cuh"

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

}  // namespace
