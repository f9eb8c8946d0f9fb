// Nibble-unpack probes: one template over the unpack, the consumer of the
// unpacked grid and the stage of the grouped dot, on the block structure of
// qmm_decode.cu, so that a probe's time is that of the decode kernels'
// design with one part changed.
//
// Replaces the Pallas kernels of scripts/probe_int4.py (:52, :57, :64, :73,
// :82; launched at :97 and :159), scripts/probe_mmvq.py (:66, :79, :96,
// :174; launched at :73, :89, :108, :186), scripts/probe_q3.py (kern :79,
// launched at :138), scripts/probe_q5.py (k_swar :95 through :86; kern_q
// :154 and kern_qp :181 at :259) and scripts/probe_q5b.py (the same kern_q
// and kern_qp, :72 and :99, at :177). They ask what unpacking 4-bit weights
// costs against the dot and the rescale that consume them.
//
// The weight: qs int8, adjk nibbles (Kb = K/2, N): byte row r holds rows 2r
// (low nibble) and 2r + 1 (high), two's complement; or, unpack "s8", the int8
// grid (K, N) itself (probe_q3.py's "nocast" stage). Unpacks:
//   i4     sign-extend each nibble into a byte: t | ((t & 0x08..) * 0x1E)
//          with t the masked nibbles (pltpu.bitcast to int4, then a cast);
//   swar   lo = (v & 0x0F0F0F0F) << 4, hi = v & 0xF0F0F0F0 on a 32-bit word of
//          four bytes: each byte 16 x the signed nibble, three operations a
//          word and no sign step (probe_q5.py:48); the caller passes sx / 16;
//   s8     none (the grid's even and odd rows are the two planes);
//   floor  the f32 chain of probe_int4.py:82: b = float(byte), f = floor(b /
//          16), l = b - 16 f, rows [l - 8 ; f - 8] (byte row r gives rows r and
//          Kb + r: another row order than i4's).
// Consumers (G = 32 rows a group, ng = K / 32):
//   planes   out (Kb, N) s32 = lo + hi per byte (k_swar);
//   colsum   out (1, N) f32 = column sums (i4 -> f32 or -> bf16 -> f32:
//            nibbles are exact in bf16, so one instantiation serves both);
//   gcolsum  out (ng, N) f32 = per-group column sums (probe_mmvq k_reshape);
//   dot_bf16 out (m, N) f32 = bf16(x) (m, K) @ w, f32 products and sums;
//   dot_s8   out (m, N) f32 = float(int32 x (m, K) @ w);
//   gdot_s8  out (ng, m, N) s32 = per-group dots (k_grouped_i8);
//   gdot     out (m, N) f32 = sum_g (parts[g] * sx[g, t]) * s[g, n], stage
//            full; nodot: parts[g] = the group's column sum (no activation
//            read); norescale: sum_g parts[g] (no scale read).
// Activations of the integer consumers: int8 groups of 32, element (t, k) of
// group g at xa + g * sg + t * st + (k % 32) (form "q": the natural order;
// (m, K) and (ng, m, 32) are strides); form "A": evens in xa, odds in xb,
// (ng, m, 16) each; forms "B" and "C": (ng, m, 32) permuted [evens | odds].
// A and B sum the even and the odd dots in two int32 chains, added per
// group; q and C in one (probe_q5.py's two dots and its one concatenated
// dot). Integer dots are exact, so every form gives the same parts; the f32
// rescale is done in one order for all, so the qp forms (swar, sx / 16)
// equal the q form (i4, sx) bit for bit.
//
// Bound: bytes at decode widths (a weight byte feeds at most 2 * 8 integer
// operations at m = 8), operations at m = 128. Design, qmm_decode.cu's: one
// block owns 32 output columns and all of K, 256 threads lie 8 across the
// columns (4 columns a thread: one 32-bit load a byte row) and 32 down K (32
// rows a lane of each 1024-row chunk: one group), the chunk's activations
// are staged in shared memory, and the 32 K lanes are summed in a fixed
// order at the end (no atomics, bitwise repeatable; the i4 "full" stage
// computes what ct_qmm_q_q4_0 does in the same order). Unlike qmm_decode.cu,
// whose lanes multiply one nibble at a time (IMAD), the integer dots here are
// dp4a on K-contiguous bytes: four byte rows' words (four columns each) are
// transposed with byte permutes into, per column, the four even rows of the
// low plane and the four odd rows of the high one, against the staged even
// and odd activations.

#include <cuda_bf16.h>

#include "qmm_common.cuh"

namespace {

constexpr int kTN = 32;              // output columns per block
constexpr int kThreads = 256;
constexpr int kCQ = kTN / 4;         // column quads per block
constexpr int kGL = kThreads / kCQ;  // K lanes
constexpr int kLR = 32;              // K rows per lane and chunk: one group
constexpr int kKC = kGL * kLR;       // K rows per chunk
constexpr int kG = 32;

// codes shared with ops/probes.py
enum { U_I4 = 0, U_SWAR = 1, U_S8 = 2, U_FLOOR = 3 };
enum { C_PLANES = 0, C_COLSUM = 1, C_GCOLSUM = 2, C_DOT_BF16 = 3, C_DOT_S8 = 4, C_GDOT_S8 = 5,
       C_GDOT = 6 };
enum { S_FULL = 0, S_NODOT = 1, S_NORESCALE = 2 };
enum { F_Q = 0, F_A = 1, F_B = 2, F_C = 3 };

template <int MT>
struct Smem {
  union {
    struct {
      int xe[MT][kKC / 8];  // even rows' int8 activations, four a word
      int xo[MT][kKC / 8];
    } q;
    struct {
      float xa[MT][kKC / 2];  // the activation of each byte row's low value
      float xb[MT][kKC / 2];  // and of its high value
    } f;
    float red[kGL][MT][kTN];
    int ired[kGL][MT][kTN];
  };
};

// the (low-plane, high-plane) words of one byte row: four columns each
template <int U>
__device__ __forceinline__ void unpack(uint32_t v, uint32_t v_odd, uint32_t* lo, uint32_t* hi) {
  if constexpr (U == U_I4) {
    const uint32_t tl = v & 0x0F0F0F0Fu, th = (v >> 4) & 0x0F0F0F0Fu;
    *lo = tl | ((tl & 0x08080808u) * 0x1Eu);
    *hi = th | ((th & 0x08080808u) * 0x1Eu);
  } else if constexpr (U == U_SWAR) {
    *lo = (v & 0x0F0F0F0Fu) << 4;
    *hi = v & 0xF0F0F0F0u;
  } else {  // U_S8: two rows of the grid
    *lo = v;
    *hi = v_odd;
  }
}

// four words of four bytes (row q, column c) -> four words (column c, row q)
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t (&t)[4]) {
  const uint32_t a01l = __byte_perm(a[0], a[1], 0x5140), a01h = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t a23l = __byte_perm(a[2], a[3], 0x5140), a23h = __byte_perm(a[2], a[3], 0x7362);
  t[0] = __byte_perm(a01l, a23l, 0x5410);
  t[1] = __byte_perm(a01l, a23l, 0x7632);
  t[2] = __byte_perm(a01h, a23h, 0x5410);
  t[3] = __byte_perm(a01h, a23h, 0x7632);
}

template <int MT, int U, int C, int ST, int FORM>
__global__ void __launch_bounds__(kThreads)
probe_nibble_kernel(const int8_t* __restrict__ qs,  // (K/2, N) nibbles, or (K, N) s8
                    const void* __restrict__ xa,    // activations (see above)
                    const int8_t* __restrict__ xb,  // form A: odd rows
                    const float* __restrict__ sx,   // (ng, m)              [gdot, not norescale]
                    const float* __restrict__ s,    // (ng, N)              [gdot, not norescale]
                    void* __restrict__ out, int m, int K, int N, int sg, int st) {
  constexpr bool kFloat = C == C_DOT_BF16;
  constexpr bool kInt = C == C_DOT_S8 || C == C_GDOT_S8 || (C == C_GDOT && ST != S_NODOT);
  constexpr bool kOnes = C == C_COLSUM || C == C_GCOLSUM || (C == C_GDOT && ST == S_NODOT);
  constexpr bool kTwo = FORM == F_A || FORM == F_B;
  static_assert(!kFloat || U == U_I4 || U == U_FLOOR, "the float consumer takes i4 or floor");
  static_assert(kFloat || U != U_FLOOR, "the floor chain feeds the bf16 dot only");
  static_assert(sizeof(Smem<MT>) <= 48 * 1024, "static shared memory limit");
  __shared__ Smem<MT> sh;
  const int tid = threadIdx.x;
  const int cq = tid % kCQ;
  const int gl = tid / kCQ;
  const int n = blockIdx.x * kTN + 4 * cq;  // first of this thread's columns
  const int t0 = blockIdx.y * MT;
  const int kb = K / 2;  // byte rows of the nibbles

  float acc[MT][4];
  int iacc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f, iacc[i][c] = 0;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    // ---- stage the chunk's activations ----
    if constexpr (kInt) {
      // four destination bytes a thread: plane p (evens, odds), even index o
      const int p = tid / 128, o = (tid % 128) * 4;
      const int g = k0 / kG + o / 16, ie = o % 16;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        uint32_t v = 0;
        if (t < m && g < K / kG) {
          const int8_t* base = static_cast<const int8_t*>(xa) + (size_t)g * sg + (size_t)t * st;
          if constexpr (FORM == F_Q) {
            const uint2 w8 = *reinterpret_cast<const uint2*>(base + 2 * ie);
            v = __byte_perm(w8.x, w8.y, p ? 0x7531 : 0x6420);
          } else if constexpr (FORM == F_A) {
            const int8_t* b2 = (p ? xb : static_cast<const int8_t*>(xa)) + (size_t)g * sg +
                               (size_t)t * st;
            v = *reinterpret_cast<const uint32_t*>(b2 + ie);
          } else {
            v = *reinterpret_cast<const uint32_t*>(base + p * 16 + ie);
          }
        }
        (p ? sh.q.xo : sh.q.xe)[i][o / 4] = static_cast<int>(v);
      }
      __syncthreads();
    } else if constexpr (kFloat) {
      // byte rows 2 tid and 2 tid + 1 of the chunk: their (low, high) partners
      const int kb0 = k0 / 2, r = kb0 + 2 * tid;
      const __nv_bfloat16* xbf = static_cast<const __nv_bfloat16*>(xa);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;
        if (t < m && r < kb) {
          const __nv_bfloat16* xr = xbf + (size_t)t * K;
          if constexpr (U == U_I4) {  // rows 2r, 2r + 1, 2r + 2, 2r + 3
            a0 = __bfloat162float(xr[2 * r]), b0 = __bfloat162float(xr[2 * r + 1]);
            a1 = __bfloat162float(xr[2 * r + 2]), b1 = __bfloat162float(xr[2 * r + 3]);
          } else {  // rows r, r + 1 and kb + r, kb + r + 1
            a0 = __bfloat162float(xr[r]), a1 = __bfloat162float(xr[r + 1]);
            b0 = __bfloat162float(xr[kb + r]), b1 = __bfloat162float(xr[kb + r + 1]);
          }
        }
        sh.f.xa[i][2 * tid] = a0, sh.f.xb[i][2 * tid] = b0;
        sh.f.xa[i][2 * tid + 1] = a1, sh.f.xb[i][2 * tid + 1] = b1;
      }
      __syncthreads();
    }

    const int kr0 = k0 + gl * kLR;  // first K row of this lane: group g
    const int g = kr0 / kG;
    if (kr0 < K) {
      // the lane's 16 byte rows (or, s8, its 32 grid rows as 16 even-odd pairs)
      uint32_t wv[kLR / 2], wo[kLR / 2];
#pragma unroll
      for (int rr = 0; rr < kLR / 2; ++rr) {
        if constexpr (U == U_S8) {
          wv[rr] = __ldg(reinterpret_cast<const unsigned int*>(qs + (size_t)(kr0 + 2 * rr) * N + n));
          wo[rr] = __ldg(reinterpret_cast<const unsigned int*>(qs + (size_t)(kr0 + 2 * rr + 1) * N + n));
        } else {
          wv[rr] = __ldg(reinterpret_cast<const unsigned int*>(qs + (size_t)(kr0 / 2 + rr) * N + n));
          wo[rr] = 0u;
        }
      }
      if constexpr (C == C_PLANES) {
#pragma unroll
        for (int rr = 0; rr < kLR / 2; ++rr) {
          uint32_t lo, hi;
          unpack<U>(wv[rr], wo[rr], &lo, &hi);
          int4 o4;
          o4.x = ctq::sbyte(lo, 0) + ctq::sbyte(hi, 0);
          o4.y = ctq::sbyte(lo, 1) + ctq::sbyte(hi, 1);
          o4.z = ctq::sbyte(lo, 2) + ctq::sbyte(hi, 2);
          o4.w = ctq::sbyte(lo, 3) + ctq::sbyte(hi, 3);
          *reinterpret_cast<int4*>(static_cast<int*>(out) + (size_t)(kr0 / 2 + rr) * N + n) = o4;
        }
      } else if constexpr (kFloat) {
#pragma unroll
        for (int rr = 0; rr < kLR / 2; ++rr) {
          const int rel = gl * (kLR / 2) + rr;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float wl, wh;
            if constexpr (U == U_I4) {
              wl = static_cast<float>(ctq::nibble(wv[rr], 2 * c));
              wh = static_cast<float>(ctq::nibble(wv[rr], 2 * c + 1));
            } else {
              const float b = static_cast<float>(ctq::sbyte(wv[rr], c));
              const float f = floorf(__fmul_rn(b, 0.0625f));
              const float l = __fsub_rn(b, __fmul_rn(f, 16.0f));
              wl = l - 8.0f, wh = f - 8.0f;  // small integers: exact
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              acc[i][c] = fmaf(sh.f.xa[i][rel], wl, acc[i][c]);
              acc[i][c] = fmaf(sh.f.xb[i][rel], wh, acc[i][c]);
            }
          }
        }
      } else {
        // ---- exact int32 group dots: dp4a on K-contiguous bytes ----
        int idot[MT][4], iodd[MT][4], ones[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) idot[i][c] = 0, iodd[i][c] = 0;
#pragma unroll
        for (int j = 0; j < kLR / 8; ++j) {
          uint32_t L[4], H[4], TL[4], TH[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) unpack<U>(wv[4 * j + q], wo[4 * j + q], &L[q], &H[q]);
          transpose4(L, TL);
          transpose4(H, TH);
          if constexpr (kOnes) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ones[c] = __dp4a(static_cast<int>(TL[c]), 0x01010101, ones[c]);
              ones[c] = __dp4a(static_cast<int>(TH[c]), 0x01010101, ones[c]);
            }
          }
          if constexpr (kInt) {
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const int xe = sh.q.xe[i][gl * (kLR / 8) + j];
              const int xo = sh.q.xo[i][gl * (kLR / 8) + j];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                idot[i][c] = __dp4a(static_cast<int>(TL[c]), xe, idot[i][c]);
                if constexpr (kTwo)
                  iodd[i][c] = __dp4a(static_cast<int>(TH[c]), xo, iodd[i][c]);
                else
                  idot[i][c] = __dp4a(static_cast<int>(TH[c]), xo, idot[i][c]);
              }
            }
          }
        }
        if constexpr (kTwo) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) idot[i][c] += iodd[i][c];
        }
        if constexpr (C == C_COLSUM) {
#pragma unroll
          for (int c = 0; c < 4; ++c) iacc[0][c] += ones[c];
        } else if constexpr (C == C_GCOLSUM) {
          const float4 o4 = make_float4((float)ones[0], (float)ones[1], (float)ones[2], (float)ones[3]);
          *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)g * N + n) = o4;
        } else if constexpr (C == C_DOT_S8) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) iacc[i][c] += idot[i][c];
        } else if constexpr (C == C_GDOT_S8) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int t = t0 + i;
            if (t < m)
              *reinterpret_cast<int4*>(static_cast<int*>(out) + ((size_t)g * m + t) * N + n) =
                  make_int4(idot[i][0], idot[i][1], idot[i][2], idot[i][3]);
          }
        } else {  // C_GDOT: one f32 rescale a group, in this order for every form
          float sv[4] = {1.f, 1.f, 1.f, 1.f};
          if constexpr (ST != S_NORESCALE) {
            const float4 s4 = __ldg(reinterpret_cast<const float4*>(s + (size_t)g * N + n));
            sv[0] = s4.x, sv[1] = s4.y, sv[2] = s4.z, sv[3] = s4.w;
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const int t = t0 + i;
            float sxv = 0.0f;
            if constexpr (ST != S_NORESCALE) sxv = t < m ? __ldg(sx + (size_t)g * m + t) : 0.0f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int p = ST == S_NODOT ? ones[c] : idot[i][c];
              const float part = ST == S_NORESCALE
                                     ? static_cast<float>(p)
                                     : __fmul_rn(__fmul_rn(static_cast<float>(p), sxv), sv[c]);
              acc[i][c] = __fadd_rn(acc[i][c], part);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- fixed-order reduction of the K lanes ----
  if constexpr (C == C_COLSUM || C == C_DOT_S8) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sh.ired[gl][i][4 * cq + c] = iacc[i][c];
    __syncthreads();
    for (int e = tid; e < MT * kTN; e += kThreads) {
      const int i = e / kTN, col = e % kTN, t = t0 + i;
      int v = 0;
      for (int l = 0; l < kGL; ++l) v += sh.ired[l][i][col];
      if (t < m) static_cast<float*>(out)[(size_t)t * N + blockIdx.x * kTN + col] = (float)v;
    }
  } else if constexpr (C == C_DOT_BF16 || C == C_GDOT) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sh.red[gl][i][4 * cq + c] = acc[i][c];
    __syncthreads();
    for (int e = tid; e < MT * kTN; e += kThreads) {
      const int i = e / kTN, col = e % kTN, t = t0 + i;
      float v = 0.0f;
      for (int l = 0; l < kGL; ++l) v = __fadd_rn(v, sh.red[l][i][col]);
      if (t < m) static_cast<float*>(out)[(size_t)t * N + blockIdx.x * kTN + col] = v;
    }
  }
}

template <int MT, int U, int C, int ST, int FORM>
int launch(const int8_t* qs, const void* xa, const int8_t* xb, const float* sx, const float* s,
           void* out, int m, int K, int N, int sg, int st, cudaStream_t stream) {
  dim3 grid(N / kTN, (m + MT - 1) / MT);
  probe_nibble_kernel<MT, U, C, ST, FORM><<<grid, kThreads, 0, stream>>>(qs, xa, xb, sx, s, out,
                                                                         m, K, N, sg, st);
  return static_cast<int>(cudaGetLastError());
}

// the consumers with activation rows: one row a block at m = 1, else eight
template <int U, int C, int ST, int FORM>
int launch_m(const int8_t* qs, const void* xa, const int8_t* xb, const float* sx, const float* s,
             void* out, int m, int K, int N, int sg, int st, cudaStream_t stream) {
  if (m == 1) return launch<1, U, C, ST, FORM>(qs, xa, xb, sx, s, out, m, K, N, sg, st, stream);
  return launch<8, U, C, ST, FORM>(qs, xa, xb, sx, s, out, m, K, N, sg, st, stream);
}

}  // namespace

extern "C" {

// qs: (K/2, N) nibbles, or (K, N) int8 for unpack s8; xa, xb, sx, s, out
// as the consumer takes them (null where not read); m activation rows (1 for
// planes, colsum, gcolsum); sg, st the group and row strides of int8
// activations (bytes). K a multiple of 32, N of 32; the offsets of every
// 4-byte (form q: 8-byte) activation load and of every row 16-byte aligned.
int ct_probe_nibble(const int8_t* qs, const void* xa, const int8_t* xb, const float* sx,
                    const float* s, void* out, int unpack, int consumer, int stage, int form,
                    int m, int K, int N, int sg, int st, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if (qs == nullptr || out == nullptr || m < 1 || K < kG || K % kG || N < kTN || N % kTN)
    return bad;
  const bool xq = consumer == C_DOT_S8 || consumer == C_GDOT_S8 ||
                  (consumer == C_GDOT && stage != S_NODOT);
  if (xq && (xa == nullptr || sg % (form == F_Q ? 8 : 4) || st % (form == F_Q ? 8 : 4) ||
             (form == F_A && xb == nullptr)))
    return bad;
  if (consumer != C_GDOT && (stage != S_FULL || form != F_Q)) return bad;
  const bool rescale = consumer == C_GDOT && stage != S_NORESCALE;
  if (rescale && (sx == nullptr || s == nullptr)) return bad;
  switch (consumer) {
    case C_PLANES:
      if (m != 1) return bad;
      if (unpack == U_I4)
        return launch<1, U_I4, C_PLANES, S_FULL, F_Q>(qs, xa, xb, sx, s, out, 1, K, N, 0, 0, strm);
      if (unpack == U_SWAR)
        return launch<1, U_SWAR, C_PLANES, S_FULL, F_Q>(qs, xa, xb, sx, s, out, 1, K, N, 0, 0, strm);
      return bad;
    case C_COLSUM:
      if (m != 1 || unpack != U_I4) return bad;
      return launch<1, U_I4, C_COLSUM, S_FULL, F_Q>(qs, xa, xb, sx, s, out, 1, K, N, 0, 0, strm);
    case C_GCOLSUM:
      if (m != 1 || unpack != U_I4) return bad;
      return launch<1, U_I4, C_GCOLSUM, S_FULL, F_Q>(qs, xa, xb, sx, s, out, 1, K, N, 0, 0, strm);
    case C_DOT_BF16:
      if (xa == nullptr || K % 4) return bad;
      if (unpack == U_I4)
        return launch_m<U_I4, C_DOT_BF16, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, 0, 0, strm);
      if (unpack == U_FLOOR)
        return launch_m<U_FLOOR, C_DOT_BF16, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, 0, 0,
                                                          strm);
      return bad;
    case C_DOT_S8:
      if (unpack != U_I4 || form != F_Q) return bad;
      return launch_m<U_I4, C_DOT_S8, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
    case C_GDOT_S8:
      if (unpack != U_I4 || form != F_Q) return bad;
      return launch_m<U_I4, C_GDOT_S8, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
    case C_GDOT:
      if (stage == S_NODOT && unpack == U_I4 && form == F_Q)
        return launch_m<U_I4, C_GDOT, S_NODOT, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      if (stage == S_NORESCALE && unpack == U_I4 && form == F_Q)
        return launch_m<U_I4, C_GDOT, S_NORESCALE, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st,
                                                        strm);
      if (stage != S_FULL) return bad;
      if (unpack == U_I4 && form == F_Q)
        return launch_m<U_I4, C_GDOT, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      if (unpack == U_S8 && form == F_Q)
        return launch_m<U_S8, C_GDOT, S_FULL, F_Q>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      if (unpack == U_SWAR && form == F_A)
        return launch_m<U_SWAR, C_GDOT, S_FULL, F_A>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      if (unpack == U_SWAR && form == F_B)
        return launch_m<U_SWAR, C_GDOT, S_FULL, F_B>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      if (unpack == U_SWAR && form == F_C)
        return launch_m<U_SWAR, C_GDOT, S_FULL, F_C>(qs, xa, xb, sx, s, out, m, K, N, sg, st, strm);
      return bad;
  }
  return bad;
}

}  // extern "C"
