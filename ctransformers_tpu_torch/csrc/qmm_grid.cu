// Quantized matmuls on int8 grids: the Q6_K and Q5_K tensors of llama
// Q4_K_M / Q5_K_M files and the Q8_0, Q5_0 and Q5_1 tensors of the legacy
// llama files, for decode and for prompt chunks.
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_q_kernel with packed4=False (mode "q" on an int8 grid) -> ct_qmm_q8
//   _qmm_qx_kernel with packed4=False (mode "qx", x quantized in
//                  the kernel)                                  -> ct_qmm_qx8
//   _qmm_kernel,   mode "b"  (bf16 dots)                         -> ct_qmm_b
//   _qmm_s_kernel, mode "sb" (sum-fold mins, bf16 dots)          -> ct_qmm_sb
//   _qmm_rb_kernel, mode "rb" (the function of "b", the reference's
//                  reshape-broadcast form)                       -> ct_qmm_rb8
// and, on the legacy types' unfactored planes (the reference's sfactor == 0
// branches), ct_qmm_q8_legacy, ct_qmm_qx8_legacy, ct_qmm_b_legacy,
// ct_qmm_sb_legacy and ct_qmm_rb8_legacy.
//
// Weight layout (ctransformers_tpu_torch/ops/qmatmul.py, an unpacked
// QTensor) for a logical (K, N) weight padded to (Kp, Np):
//   qs     int8 (Kp, Np)      the grid q (Q6_K: [-32, 31]; Q5_K: [0, 31])
//   sub_s  int8 (Kp/G, Np)    sub-scales, one per group of G rows
//                             (G = 16 for Q6_K, 32 for Q5_K)
//   sub_m  int8 (Kp/G, Np)    sub-mins (Q5_K; null for Q6_K)
//   sd     f32  (Kp/256, Np)  superblock scale
//   sm     f32  (Kp/256, Np)  superblock min (Q5_K; null for Q6_K)
// so that W[k, n] = q * s + m with s = sd * sub_s and m = sm * sub_m, each
// an f32 product rounded once, as the reference's _apply_factors. The
// legacy types are not factored (PLAIN_S): qs int8 (Kp, Np) (Q8_0: q in
// [-128, 127]; Q5_0: [-16, 15]; Q5_1: [0, 31]) with f32 (Kp/32, Np) planes
// s and m (Q5_1 only) read as they are, passed as sd and sm with sub_s and
// sub_m null; the _legacy symbols say so, and whether there are mins,
// explicitly (a null pointer selects nothing).
//
// The kernels are templated on G, HAS_MINS and PLAIN_S (the layouts). Every
// block sums in a fixed order (no atomics; the K split's partial tiles are
// added in rank order), so runs are bitwise repeatable.
//
// ct_qmm_q8 and ct_qmm_q8_legacy, decode and short chunks (m <= 32):
//   out = xsum @ M + sum_g (int32 dot_g(xq, q[:, n]) * sx[t, g]) * s[g, n]
//   with xq, sx, xsum per group of G from ops/qmm_kernels.py
//   quantize_activations. Bound: bytes. One weight byte feeds at most 32
//   multiply-adds at m = 8, far below the ~295 operations per byte at which
//   the card turns compute-bound, so the kernel is as fast as it streams
//   the grid (1 B/weight) and its scale planes (~0.08 B/weight factored,
//   0.125 or 0.25 B/weight for the legacy types' f32 planes). At
//   1 <= m <= 32 both take q8_kernel of qmm_splitk.cuh: 128 columns a
//   block, K split over a thread-block cluster, a cp.async ring of grid,
//   x and scale stages, dp4a on transposed grid bytes, one rescale a whole
//   group. Above 32 (only a user's table sends them there) the first
//   design, qmm_q8_kernel below: a block owns 32 output columns; its 256
//   threads lie 8 across the columns (4 columns each, one 32-bit load per
//   row, so a warp reads 32 contiguous bytes from each of 4 rows) and 32
//   down K (one quant group each per chunk of 32 groups). Each thread loads
//   its group's G rows at once, takes exact int32 dots against the int8
//   activations staged in shared memory, rescales in f32, and the 32
//   K-lanes are reduced in shared memory in a fixed order at the end.
//
// ct_qmm_qx8, the same function on raw f32 activations (QUANT_IN): each
//   block quantizes x chunk by chunk as it stages it, as ct_qmm_qx does
//   (qmm_decode.cu): thread tid holds x[k0 + 4 tid .. + 3], the G / 4
//   threads of a group reduce absmax and sum with an xor butterfly, then
//   sx = absmax / 127 (IEEE division), xq = clip(rint(x / max(sx, 1e-20)),
//   +-127) and, with mins, xsum = the group's f32 sum. A chunk is at most
//   8 x 1024 int8 in shared memory whatever K is (at m = 8 the down shape's
//   x is 8 x 11008 f32 = 352 KB, more than a block holds), and groups never
//   cross a chunk. Every column block quantizes x again, as the reference
//   does per column tile: np / 32 blocks each read all of x (4 B/value
//   against q8's 1 B/value of xq), from L2.
//
// ct_qmm_b / ct_qmm_sb, prompt chunks (m > 32):
//   b:  out = bf16(x) @ bf16(q * s + m)            f32 accumulation
//   sb: out = xsum @ M + bf16(x) @ bf16(q * s)
//   Bound: at m = 128 a weight byte (1.08 B/weight) feeds ~237 operations,
//   just under the bf16 ridge, so bytes and tensor-core operations bound it
//   about equally; chip_smoke.py reports the larger. All four (ct_qmm_b,
//   ct_qmm_sb and their legacy forms) run the Hopper core of qmm_wgmma.cuh
//   (TMA ring, wgmma, K split over a cluster of 3): ct_qmm_sb on Q5_K folds
//   the factored M = sm * sub_m through the group sums of x, on Q6_K (no
//   mins) it is the product alone, ct_qmm_b's instantiation.
//
// ct_qmm_rb8 / ct_qmm_rb8_legacy compute ct_qmm_b's function (the reference
//   computes it again in its reshape-broadcast form, _qmm_rb_kernel): above
//   m = 32 they launch ct_qmm_b's and ct_qmm_b_legacy's instantiations of
//   the core; at 1 <= m <= 32 the K split's "b" form (qmm_splitk.cuh:
//   128 columns a block, K split over a cluster, each weight's q * s (+ m)
//   rounded once to bf16, f32 sums of the exact products at m = 1, bf16
//   mma.sync above), which the legacy grids feed their plain f32 planes.
//   Bound at m <= 32: the weight's bytes, as "q8".
#include "qmm_splitk.cuh"
#include "qmm_wgmma.cuh"

namespace {

// ---- ct_qmm_q8 ----------------------------------------------------------

constexpr int kTN = 32;               // output columns per block
constexpr int kThreads = 256;
constexpr int kCQ = kTN / 4;          // column quads per block
constexpr int kGL = kThreads / kCQ;   // K lanes (one group each per chunk)

template <int MT, int G>
struct Q8Smem {
  int8_t xq[MT][kGL * G];
  float sx[MT][kGL];
  float xs[MT][kGL];
  float red[kGL][MT][kTN];
};

template <int MT, int G, bool HAS_MINS, bool PLAIN_S, bool QUANT_IN>
__global__ void __launch_bounds__(kThreads)
qmm_q8_kernel(const float* __restrict__ x,       // (m, kp) f32     [QUANT_IN]
              const int8_t* __restrict__ xq_g,   // (m, kp) int8    [!QUANT_IN]
              const float* __restrict__ sx_g,    // (m, kp/G) f32   [!QUANT_IN]
              const float* __restrict__ xs_g,    // (m, kp/G) f32   [!QUANT_IN, HAS_MINS]
              const int8_t* __restrict__ qs,     // (kp, np)
              const int8_t* __restrict__ sub_s,  // (kp/G, np)      [!PLAIN_S]
              const int8_t* __restrict__ sub_m,  // (kp/G, np)      [!PLAIN_S, HAS_MINS]
              const float* __restrict__ sd,      // (kp/256, np); PLAIN_S: s (kp/G, np)
              const float* __restrict__ sm,      // (kp/256, np); PLAIN_S: m [HAS_MINS]
              float* __restrict__ out,           // (m, np)
              int m, int kp, int np) {
  constexpr int kKC = kGL * G;  // K rows staged per chunk
  constexpr int kSF = 256 / G;  // groups per superblock (factored planes)
  constexpr int kQT = G / 4;    // threads holding one group while quantizing
  static_assert(sizeof(Q8Smem<MT, G>) <= 48 * 1024, "static shared memory limit");
  static_assert(kKC % 128 == 0 && kKC <= 4 * kThreads && 32 % kQT == 0,
                "whole warps stage a chunk, a group's threads lie in one warp");
  __shared__ Q8Smem<MT, G> sh;
  const int tid = threadIdx.x;
  const int cq = tid % kCQ;
  const int gl = tid / kCQ;
  const int n = blockIdx.x * kTN + 4 * cq;  // first of this thread's columns
  const int t0 = blockIdx.y * MT;
  const int ng = kp / G;

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < kp; k0 += kKC) {
    // ---- stage this chunk's int8 activations and group statistics ----
    if constexpr (QUANT_IN) {
      // thread tid holds x[k0 + 4*tid .. +3]; G/4 neighbouring threads = 1
      // group (whole warps: the condition is uniform across a warp)
      if (4 * tid < kKC) {
        const int k = k0 + 4 * tid;
        const int gi = tid / kQT;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int t = t0 + i;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < m && k < kp)
            v = __ldg(reinterpret_cast<const float4*>(x + (size_t)t * kp + k));
          float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
          float sum = HAS_MINS ? __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w)) : 0.0f;
#pragma unroll
          for (int off = 1; off < kQT; off <<= 1) {
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
            if (HAS_MINS) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
          }
          const float sxv = __fdiv_rn(amax, 127.0f);
          const float den = fmaxf(sxv, 1e-20f);
          char4 q;
          q.x = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.x, den)), -127.f), 127.f);
          q.y = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.y, den)), -127.f), 127.f);
          q.z = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.z, den)), -127.f), 127.f);
          q.w = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.w, den)), -127.f), 127.f);
          *reinterpret_cast<char4*>(&sh.xq[i][4 * tid]) = q;
          if (tid % kQT == 0) {
            sh.sx[i][gi] = sxv;
            if (HAS_MINS) sh.xs[i][gi] = sum;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        for (int kk = 4 * tid; kk < kKC; kk += 4 * kThreads) {
          const int k = k0 + kk;
          int v = 0;
          if (t < m && k < kp)
            v = __ldg(reinterpret_cast<const int*>(xq_g + (size_t)t * kp + k));
          *reinterpret_cast<int*>(&sh.xq[i][kk]) = v;
        }
      }
      for (int e = tid; e < MT * kGL; e += kThreads) {
        const int i = e / kGL, gi = e % kGL;
        const int t = t0 + i, g = k0 / G + gi;
        const bool ok = t < m && g < ng;
        sh.sx[i][gi] = ok ? __ldg(sx_g + (size_t)t * ng + g) : 0.0f;
        if (HAS_MINS) sh.xs[i][gi] = ok ? __ldg(xs_g + (size_t)t * ng + g) : 0.0f;
      }
    }
    __syncthreads();

    // ---- one quant group per K lane: int32 dots, then f32 rescale ----
    const int g = k0 / G + gl;
    if (g < ng) {
      const int8_t* qrow = qs + (size_t)g * G * np + n;
      uint32_t w[G];
#pragma unroll
      for (int r = 0; r < G; ++r)
        w[r] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)r * np));
      int idot[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) idot[i][c] = 0;
#pragma unroll
      for (int r = 0; r < G; ++r) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int xv = sh.xq[i][gl * G + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) idot[i][c] += ctq::sbyte(w[r], c) * xv;
        }
      }
      float s[4], b[4];
      if (PLAIN_S) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(sd + (size_t)g * np + n));
        s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
        if (HAS_MINS) {
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(sm + (size_t)g * np + n));
          b[0] = m4.x, b[1] = m4.y, b[2] = m4.z, b[3] = m4.w;
        }
      } else {
        const uint32_t sw = __ldg(reinterpret_cast<const unsigned int*>(sub_s + (size_t)g * np + n));
        const size_t fo = (size_t)(g / kSF) * np + n;
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(sd + fo));
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
        if (HAS_MINS) {
          const uint32_t mw = __ldg(reinterpret_cast<const unsigned int*>(sub_m + (size_t)g * np + n));
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(sm + fo));
          const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = __fmul_rn(mv[c], static_cast<float>(ctq::sbyte(mw, c)));
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float sxv = sh.sx[i][gl];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float part = __fmul_rn(__fmul_rn(static_cast<float>(idot[i][c]), sxv), s[c]);
          if (HAS_MINS) part = __fadd_rn(part, __fmul_rn(sh.xs[i][gl], b[c]));
          acc[i][c] = __fadd_rn(acc[i][c], part);
        }
      }
    }
    __syncthreads();
  }

  // ---- fixed-order reduction of the K lanes ----
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

// xq given (ct_qmm_q8, ct_qmm_q8_legacy): the K split at 1 <= m <= 32, which
// refuses what it does not take; QUANT_IN (ct_qmm_qx8, its legacy form) and
// m > 32: qmm_q8_kernel
template <int G, bool HAS_MINS, bool PLAIN_S, bool QUANT_IN>
int launch_q8(const float* x, const int8_t* xq, const float* sx, const float* xs,
              const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
              const float* sd, const float* sm, float* out, int m, int kp,
              int np, cudaStream_t stream) {
  if (!QUANT_IN && m >= 1 && m <= ctsk::kMaxM)
    return ctsk::run_q8<G, HAS_MINS, PLAIN_S>(xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp,
                                              np, stream);
  if (m == 1) {
    dim3 grid(np / kTN, 1);
    qmm_q8_kernel<1, G, HAS_MINS, PLAIN_S, QUANT_IN><<<grid, kThreads, 0, stream>>>(
        x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  } else {
    constexpr int MT = 8;
    dim3 grid(np / kTN, (m + MT - 1) / MT);
    qmm_q8_kernel<MT, G, HAS_MINS, PLAIN_S, QUANT_IN><<<grid, kThreads, 0, stream>>>(
        x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  }
  return static_cast<int>(cudaGetLastError());
}

// The factored grids: group 16 without mins (Q6_K) or 32 with mins (Q5_K).
template <bool QUANT_IN>
int launch_q8_grid(const float* x, const int8_t* xq, const float* sx, const float* xs,
                   const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                   const float* sd, const float* sm, float* out, int m, int kp, int np,
                   int group, cudaStream_t st) {
  if (group == 16 && sub_m == nullptr)
    return launch_q8<16, false, false, QUANT_IN>(x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out,
                                                 m, kp, np, st);
  if (group == 32 && sub_m != nullptr)
    return launch_q8<32, true, false, QUANT_IN>(x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out,
                                                m, kp, np, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The legacy grids: group 32, f32 planes s and mn (null exactly when
// has_mins is 0: Q8_0 and Q5_0; Q5_1 has mins).
template <bool QUANT_IN>
int launch_q8_legacy(const float* x, const int8_t* xq, const float* sx, const float* xs,
                     const int8_t* qs, const float* s, const float* mn, float* out, int m,
                     int kp, int np, int has_mins, cudaStream_t st) {
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (has_mins)
    return launch_q8<32, true, true, QUANT_IN>(x, xq, sx, xs, qs, nullptr, nullptr, s, mn, out,
                                               m, kp, np, st);
  return launch_q8<32, false, true, QUANT_IN>(x, xq, sx, xs, qs, nullptr, nullptr, s, nullptr,
                                              out, m, kp, np, st);
}

// ct_qmm_b on the Hopper core: Q6_K (group 16, no mins) or Q5_K (group 32,
// mins added per weight)
int launch_b_core(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                  const float* sd, const float* sm, float* out, int m, int kp, int np,
                  int group, cudaStream_t stream) {
  const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
  if (group == 16 && sub_m == nullptr && sm == nullptr)
    return ctw::launch_core<16, false, false, false>(x, qs, p, stream);
  if (group == 32 && sub_m != nullptr && sm != nullptr)
    return ctw::launch_core<32, true, false, false>(x, qs, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ct_qmm_b_legacy on the Hopper core: plain f32 planes at group 32, the
// mins (Q5_1) added per weight (q * s + m in f32, rounded once to bf16);
// without mins (Q8_0, Q5_0) the instantiation of sb_legacy without mins
int launch_b_legacy_core(const float* x, const int8_t* qs, const float* s, const float* mn,
                         float* out, int m, int kp, int np, int has_mins,
                         cudaStream_t stream) {
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{nullptr, nullptr, s, mn, out, m, kp, np};
  if (has_mins) return ctw::launch_core<32, true, true, false>(x, qs, p, stream);
  return ctw::launch_core<32, false, true, false>(x, qs, p, stream);
}

// ct_qmm_sb_legacy on the Hopper core: plain f32 planes at group 32, the
// mins (Q5_1) folded through the group sums of x; without mins (Q8_0, Q5_0)
// the product alone
int launch_sb_legacy_core(const float* x, const int8_t* qs, const float* s, const float* mn,
                          float* out, int m, int kp, int np, int has_mins,
                          cudaStream_t stream) {
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{nullptr, nullptr, s, mn, out, m, kp, np};
  if (has_mins) return ctw::launch_core<32, true, true, true>(x, qs, p, stream);
  return ctw::launch_core<32, false, true, false>(x, qs, p, stream);
}

// ct_qmm_sb on the Hopper core: group 16 without mins (Q6_K: the product
// alone, ct_qmm_b's instantiation) or 32 with mins (Q5_K: the factored
// M = sm * sub_m folded through the group sums of x)
int launch_sb_core(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                   const float* sd, const float* sm, float* out, int m, int kp, int np,
                   int group, cudaStream_t stream) {
  const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
  if (group == 16 && sub_m == nullptr && sm == nullptr)
    return ctw::launch_core<16, false, false, false>(x, qs, p, stream);
  if (group == 32 && sub_m != nullptr && sm != nullptr)
    return ctw::launch_core<32, true, false, true>(x, qs, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ct_qmm_rb8: the K split's "b" form at 1 <= m <= 32 (which refuses what it
// does not take), ct_qmm_b's core above
int launch_rb8(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
               cudaStream_t stream) {
  if (m < 1 || m > ctsk::kMaxM)
    return launch_b_core(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group, stream);
  if (group == 16 && sub_m == nullptr)
    return ctsk::run<ctsk::kGridB, 16, false>(x, qs, sub_s, nullptr, sd, sm, out, m, kp, np,
                                              stream);
  if (group == 32 && sub_m != nullptr)
    return ctsk::run<ctsk::kGridB, 32, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ct_qmm_rb8_legacy: the same on the plain f32 planes at group 32 (s and,
// with mins, mn), ct_qmm_b_legacy's core above
int launch_rb8_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                      float* out, int m, int kp, int np, int has_mins, cudaStream_t stream) {
  if (m < 1 || m > ctsk::kMaxM)
    return launch_b_legacy_core(x, qs, s, mn, out, m, kp, np, has_mins, stream);
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (has_mins)
    return ctsk::run<ctsk::kGridB, 32, true, true>(x, qs, nullptr, nullptr, s, mn, out, m, kp,
                                                   np, stream);
  return ctsk::run<ctsk::kGridB, 32, false, true>(x, qs, nullptr, nullptr, s, nullptr, out, m,
                                                  kp, np, stream);
}

}  // namespace

extern "C" {

// mode "q" on an int8 grid: xq int8 (m, kp), sx and xsum f32 (m, kp/group).
// group 16 without mins (Q6_K) or 32 with mins (Q5_K); at m <= 32 the K
// split of qmm_splitk.cuh.
int ct_qmm_q8(const int8_t* xq, const float* sx, const float* xs,
              const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
              const float* sd, const float* sm, float* out, int m, int kp,
              int np, int group, void* stream) {
  return launch_q8_grid<false>(nullptr, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                               group, static_cast<cudaStream_t>(stream));
}

// the K split's plan (qmm_splitk.cuh) for ct_qmm_q8 (plain_s 0: group 16
// without mins, Q6_K, or 32 with them, Q5_K) or ct_qmm_q8_legacy (plain_s
// 1: group 32, with or without mins) at batch size m: the cluster's blocks
// P, or a negative CUDA error code (m outside 1..32 among them).
int ct_qmm_q8_split_plan(int plain_s, int has_mins, int group, int m, int kp, int np) {
  if (plain_s && group == 32)
    return has_mins ? ctsk::q8_plan_of<32, true, true>(m, kp, np)
                    : ctsk::q8_plan_of<32, false, true>(m, kp, np);
  if (!plain_s && group == 16 && !has_mins) return ctsk::q8_plan_of<16, false, false>(m, kp, np);
  if (!plain_s && group == 32 && has_mins) return ctsk::q8_plan_of<32, true, false>(m, kp, np);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// the clusters of p blocks that the split's kernel for that layout at batch
// size m runs on the card at once, or a negative CUDA error code
int ct_qmm_q8_split_capacity(int plain_s, int has_mins, int group, int m, int p) {
  if (plain_s && group == 32)
    return has_mins ? ctsk::q8_capacity_of<32, true, true>(m, p)
                    : ctsk::q8_capacity_of<32, false, true>(m, p);
  if (!plain_s && group == 16 && !has_mins) return ctsk::q8_capacity_of<16, false, false>(m, p);
  if (!plain_s && group == 32 && has_mins) return ctsk::q8_capacity_of<32, true, false>(m, p);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// mode "qx" on an int8 grid: x f32 (m, kp), quantized per group in the
// kernel. group 16 without mins (Q6_K) or 32 with mins (Q5_K).
int ct_qmm_qx8(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               int group, void* stream) {
  return launch_q8_grid<true>(x, nullptr, nullptr, nullptr, qs, sub_s, sub_m, sd, sm, out, m,
                              kp, np, group, static_cast<cudaStream_t>(stream));
}

// mode "b": bf16(x) @ bf16(q * s + m)
int ct_qmm_b(const float* x, const int8_t* qs, const int8_t* sub_s,
             const int8_t* sub_m, const float* sd, const float* sm,
             float* out, int m, int kp, int np, int group, void* stream) {
  return launch_b_core(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                       static_cast<cudaStream_t>(stream));
}

// mode "sb": xsum @ M + bf16(x) @ bf16(q * s)
int ct_qmm_sb(const float* x, const int8_t* qs, const int8_t* sub_s,
              const int8_t* sub_m, const float* sd, const float* sm,
              float* out, int m, int kp, int np, int group, void* stream) {
  return launch_sb_core(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                        static_cast<cudaStream_t>(stream));
}

// mode "q" on a legacy int8 grid (Q8_0, Q5_0, Q5_1): xq int8 (m, kp), sx and
// xsum f32 (m, kp/32); s and mn f32 (kp/32, np), mn null exactly when
// has_mins is 0; at m <= 32 the K split of qmm_splitk.cuh.
int ct_qmm_q8_legacy(const int8_t* xq, const float* sx, const float* xs,
                     const int8_t* qs, const float* s, const float* mn, float* out,
                     int m, int kp, int np, int has_mins, void* stream) {
  return launch_q8_legacy<false>(nullptr, xq, sx, xs, qs, s, mn, out, m, kp, np, has_mins,
                                 static_cast<cudaStream_t>(stream));
}

// mode "qx" on a legacy int8 grid (Q8_0, Q5_0, Q5_1): x f32 (m, kp),
// quantized per group of 32 in the kernel; s and mn f32 (kp/32, np), mn
// null exactly when has_mins is 0.
int ct_qmm_qx8_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                      float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_q8_legacy<true>(x, nullptr, nullptr, nullptr, qs, s, mn, out, m, kp, np,
                                has_mins, static_cast<cudaStream_t>(stream));
}

// mode "b" on a legacy int8 grid: bf16(x) @ bf16(q * s + mn)
int ct_qmm_b_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                    float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_b_legacy_core(x, qs, s, mn, out, m, kp, np, has_mins,
                              static_cast<cudaStream_t>(stream));
}

// mode "rb" on an int8 grid: bf16(x) @ bf16(q * s + m), the function of
// ct_qmm_b; group 16 without mins (Q6_K) or 32 with mins (Q5_K)
int ct_qmm_rb8(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
               void* stream) {
  return launch_rb8(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, group,
                    static_cast<cudaStream_t>(stream));
}

// mode "rb" on a legacy int8 grid (Q8_0, Q5_0, Q5_1): the function of
// ct_qmm_b_legacy; s and mn f32 (kp/32, np), mn null exactly when has_mins
// is 0
int ct_qmm_rb8_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                      float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_rb8_legacy(x, qs, s, mn, out, m, kp, np, has_mins,
                           static_cast<cudaStream_t>(stream));
}

// the K split's plan for ct_qmm_rb8 (plain_s 0: group 16 without mins, Q6_K,
// or 32 with them, Q5_K) or ct_qmm_rb8_legacy (plain_s 1: group 32, with or
// without mins) at batch size m: the cluster's blocks P, or a negative CUDA
// error code (m outside 1..32 among them: the core's).
int ct_qmm_rb8_split_plan(int plain_s, int has_mins, int group, int m, int kp, int np) {
  if (plain_s && group == 32)
    return has_mins ? ctsk::plan_of<ctsk::kGridB, 32, true, true>(m, kp, np)
                    : ctsk::plan_of<ctsk::kGridB, 32, false, true>(m, kp, np);
  if (!plain_s && group == 16 && !has_mins)
    return ctsk::plan_of<ctsk::kGridB, 16, false>(m, kp, np);
  if (!plain_s && group == 32 && has_mins) return ctsk::plan_of<ctsk::kGridB, 32, true>(m, kp, np);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// the clusters of p blocks that the split's "b" kernel for that layout at
// batch size m runs on the card at once, or a negative CUDA error code
int ct_qmm_rb8_split_capacity(int plain_s, int has_mins, int group, int m, int p) {
  if (plain_s && group == 32)
    return has_mins ? ctsk::capacity_of<ctsk::kGridB, 32, true, true>(m, p)
                    : ctsk::capacity_of<ctsk::kGridB, 32, false, true>(m, p);
  if (!plain_s && group == 16 && !has_mins)
    return ctsk::capacity_of<ctsk::kGridB, 16, false>(m, p);
  if (!plain_s && group == 32 && has_mins) return ctsk::capacity_of<ctsk::kGridB, 32, true>(m, p);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// mode "sb" on a legacy int8 grid: xsum @ mn + bf16(x) @ bf16(q * s)
int ct_qmm_sb_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                     float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_sb_legacy_core(x, qs, s, mn, out, m, kp, np, has_mins,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
