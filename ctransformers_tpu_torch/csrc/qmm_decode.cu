// Activation-quantized 4-bit matmul for small m (decode and short chunks),
// on Q4_K, Q2_K and Q3_K weights, on GPTQ 4-bit and Q4_1 weights and on Q4_0
// weights.
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_qx_kernel (mode "qx"): int8 quantization of x inside the kernel;
//   _qmm_q_kernel  (modes "q"/"q4"): the same function with x quantized
//                  outside (xq, sx, xsum given).
// Both compute, per output (t, n):
//   out = sum_g xsum[t,g] * B[g,n] + sum_g (dot_g(xq[t], w4[:,n]) * sx[t,g]) * s[g,n]
// with sx = absmax/127 per (token, group of G), xq = clip(rint(x / max(sx,
// 1e-20)), -127, 127) and the group dot taken exactly in int32.
//
// Three template choices cover the reference kernels' branches: the group G
// (32 for Q4_K and Q4_0; 16 for Q2_K and Q3_K; 32, 64 or 128 for GPTQ), the
// scale source (the k-quants: int8 sub-scales times f32 superblock factors,
// 256 / G groups a superblock; GPTQ and Q4_0, the reference's sfactor == 0
// branch: f32 planes read as they are) and the bias (Q4_0 and Q3_K, zero
// point 8 and no mins, have none: the reference's branch with qx_bias /
// g_bias False, where the kernel reads no min plane and carries no group
// sums).
//
// Bound on an H100: bytes. At m <= 32 every weight byte is used for at most
// 64 multiply-adds, far below the card's ~295 operations per byte, so the
// kernel is as fast as it streams the 4-bit planes (0.5 B/weight plus
// ~0.09 B/weight of scale planes). Design: one block owns 32 output columns
// and ALL of K, so every output element is summed by one block in a fixed
// order (no atomics, no split-K: runs are bitwise repeatable). Its 256
// threads lie 8 across the columns (4 columns each, one 32-bit load per
// byte row, so a warp reads 32 contiguous bytes from each of 4 rows) and 32
// down K (32 rows each per 1024-row chunk). The block stages the chunk's
// quantized activations in shared memory, takes int32 dots, rescales them
// in f32, and reduces the 32 K-lanes in shared memory in a fixed order at
// the end. A group of 64 or 128 rows spans 2 or 4 K lanes, which lie in one
// warp: their int32 partial dots are added with shuffles BEFORE the single
// f32 rescale, so the group dot is the reference's one exact integer (a
// rescale per quarter would round differently), and the group's first lane
// alone accumulates it. A group of 16 rows is half a lane: the lane loads
// its 32 rows at once, then takes the two groups' exact int32 dots one after
// the other, each rescaled once and added in K order. The in-kernel
// quantization reduces absmax and sum
// over the G/4 neighbouring threads of a group with an xor butterfly: every
// thread adds the same pairs in the same order, so runs stay bitwise
// repeatable.
//
// ct_qmm_qx takes another design at m <= 32: K split over a thread-block
// cluster, the nibble stream kept in flight by a cp.async ring, x quantized
// once a block, dp4a on transposed nibble bytes (qmm_splitk.cuh); this
// file's serves it above.
#include "qmm_common.cuh"
#include "qmm_splitk.cuh"

namespace {

constexpr int kTN = 32;                 // output columns per block
constexpr int kThreads = 256;
constexpr int kCQ = kTN / 4;            // column quads per block
constexpr int kGL = kThreads / kCQ;     // K lanes
constexpr int kLR = 32;                 // K rows per lane and chunk
constexpr int kKC = kGL * kLR;          // K rows staged per chunk

template <int MT, int G>
struct DecodeSmem {
  int8_t xq[MT][kKC];
  float sx[MT][kKC / G];
  float xs[MT][kKC / G];
  float red[kGL][MT][kTN];
};

// PLAIN_S: s and m are the f32 (kp/G, np) planes sd and sm themselves (GPTQ,
// Q4_0); otherwise the k-quants' int8 sub-scales times f32 superblock
// factors. HAS_BIAS: out adds xsum @ B (false for Q4_0 and Q3_K: sub_m, sm
// and xs_g are not read). Two blocks per SM are asked for at group 16 only:
// its lanes hold their 32 weight rows across two group dots.
template <int MT, bool QUANT_IN, int G, bool PLAIN_S, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, G < kLR ? 2 : 1)
qmm_q_kernel(const float* __restrict__ x,       // (m, kp) f32      [QUANT_IN]
             const int8_t* __restrict__ xq_g,   // (m, kp) int8     [!QUANT_IN]
             const float* __restrict__ sx_g,    // (m, kp/G) f32    [!QUANT_IN]
             const float* __restrict__ xs_g,    // (m, kp/G) f32    [!QUANT_IN, HAS_BIAS]
             const int8_t* __restrict__ qs,     // (kp/2, np)
             const int8_t* __restrict__ sub_s,  // (kp/G, np)       [!PLAIN_S]
             const int8_t* __restrict__ sub_m,  // (kp/G, np)       [!PLAIN_S, HAS_BIAS]
             const float* __restrict__ sd,      // (kp/256, np); PLAIN_S: s (kp/G, np)
             const float* __restrict__ sm,      // (kp/256, np); PLAIN_S: m (kp/G, np) [HAS_BIAS]
             float* __restrict__ out,           // (m, np)
             int m, int kp, int np) {
  static_assert((G % kLR == 0 && kLR * (32 / kCQ) % G == 0) || (G < kLR && kLR % G == 0),
                "a group is 1, 2 or 4 K lanes of one warp, or a part of one lane");
  static_assert(PLAIN_S || G == ctq::kGroup || G == 16,
                "factored groups are 32 rows (Q4_K) or 16 (Q2_K, Q3_K)");
  static_assert(PLAIN_S || HAS_BIAS || G == 16, "Q4_K has a bias");
  static_assert(sizeof(DecodeSmem<MT, G>) <= 48 * 1024, "static shared memory limit");
  constexpr int kLPG = G > kLR ? G / kLR : 1;  // K lanes per group
  constexpr int kGPL = G < kLR ? kLR / G : 1;  // groups per K lane
  constexpr int kRG = kLR / kGPL;              // rows of one group in one lane
  constexpr int kNG = kKC / G;                 // groups per chunk
  constexpr int kQT = G / 4;                   // threads holding one group while quantizing
  constexpr int kSF = ctq::kSuperblock / G;    // groups per superblock (factored planes)
  __shared__ DecodeSmem<MT, G> sh;
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
    // ---- stage this chunk's activations (int8) and group statistics ----
    if (QUANT_IN) {
      // thread tid holds x[k0 + 4*tid .. +3]; G/4 neighbouring threads = 1 group
      const int k = k0 + 4 * tid;
      const int gi = tid / kQT;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < m && k < kp)
          v = __ldg(reinterpret_cast<const float4*>(x + (size_t)t * kp + k));
        float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                           fmaxf(fabsf(v.z), fabsf(v.w)));
        float sum = HAS_BIAS ? __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w)) : 0.0f;
#pragma unroll
        for (int off = 1; off < kQT; off <<= 1) {
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
          if (HAS_BIAS) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
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
          if (HAS_BIAS) sh.xs[i][gi] = sum;
        }
      }
    } else {
      const int k = k0 + 4 * tid;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int t = t0 + i;
        int v = 0;
        if (t < m && k < kp)
          v = __ldg(reinterpret_cast<const int*>(xq_g + (size_t)t * kp + k));
        *reinterpret_cast<int*>(&sh.xq[i][4 * tid]) = v;
      }
      for (int e = tid; e < MT * kNG; e += kThreads) {
        const int i = e / kNG, gi = e % kNG;
        const int t = t0 + i, g = k0 / G + gi;
        const bool ok = t < m && g < ng;
        sh.sx[i][gi] = ok ? __ldg(sx_g + (size_t)t * ng + g) : 0.0f;
        if (HAS_BIAS) sh.xs[i][gi] = ok ? __ldg(xs_g + (size_t)t * ng + g) : 0.0f;
      }
    }
    __syncthreads();

    // ---- 32 rows per K lane: int32 dots per group (a group's lanes summed,
    // or a lane's groups in turn), then one f32 rescale per group ----
    const int r0 = k0 + gl * kLR;  // first K row of this lane
    const bool live = r0 < kp;     // whole warps: kp is a 256-multiple
    const int8_t* qrow = qs + (size_t)(r0 / 2) * np + n;
    // exact int32 dots of one group's kRG / 2 byte rows of w, from row rr0,
    // with the staged xq (a fixed trip count: w stays in registers)
    auto dot = [&](const uint32_t (&w)[kLR / 2], int rr0, int (&idot)[MT][4]) {
#pragma unroll
      for (int r = 0; r < kRG / 2; ++r) {
        const int rr = rr0 + r;
        const int kl = gl * kLR + 2 * rr;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int x0 = sh.xq[i][kl];
          const int x1 = sh.xq[i][kl + 1];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            idot[i][c] += ctq::nibble(w[rr], 2 * c) * x0 +
                          ctq::nibble(w[rr], 2 * c + 1) * x1;
        }
      }
    };
    // one f32 rescale of a group's dots into acc: g the group in the
    // weight, gi in this chunk
    auto rescale = [&](int g, int gi, const int (&idot)[MT][4]) {
      float s[4], b[4] = {0.f, 0.f, 0.f, 0.f};
      if (PLAIN_S) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(sd + (size_t)g * np + n));
        s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
        if (HAS_BIAS) {
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(sm + (size_t)g * np + n));
          const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) b[c] = ctq::plain_bias(s[c], mv[c]);
        }
      } else {
        // the four planes' loads issued together, before any use
        const uint32_t sw = __ldg(reinterpret_cast<const unsigned int*>(sub_s + (size_t)g * np + n));
        const uint32_t mw =
            HAS_BIAS ? __ldg(reinterpret_cast<const unsigned int*>(sub_m + (size_t)g * np + n)) : 0u;
        const size_t fo = (size_t)(g / kSF) * np + n;
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(sd + fo));
        const float4 m4 =
            HAS_BIAS ? __ldg(reinterpret_cast<const float4*>(sm + fo)) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        if (HAS_BIAS) {
          const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            ctq::group_scale(dv[c], ctq::sbyte(sw, c), mv[c], ctq::sbyte(mw, c), &s[c], &b[c]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float sxv = sh.sx[i][gi];
        const float xsv = HAS_BIAS ? sh.xs[i][gi] : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float part = __fmul_rn(__fmul_rn((float)idot[i][c], sxv), s[c]);
          acc[i][c] = __fadd_rn(acc[i][c], HAS_BIAS ? __fadd_rn(part, __fmul_rn(xsv, b[c])) : part);
        }
      }
    };
    if constexpr (kGPL == 1) {
      // a group is 1, 2 or 4 whole lanes: one dot over the lane's 32 rows
      int idot[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) idot[i][c] = 0;
      if (live) {
        uint32_t w[kLR / 2];
#pragma unroll
        for (int rr = 0; rr < kLR / 2; ++rr)
          w[rr] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)rr * np));
        dot(w, 0, idot);
      }
      if (kLPG > 1) {
        // the group's lanes are threads kCQ apart in one warp; integer sums
        // are exact in any order
#pragma unroll
        for (int off = kCQ; off < kCQ * kLPG; off <<= 1)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              idot[i][c] += __shfl_xor_sync(0xffffffffu, idot[i][c], off);
      }
      if (live && gl % kLPG == 0) rescale(r0 / G, gl / kLPG, idot);
    } else if (live) {
      // a lane holds kGPL groups: its rows loaded at once, then each group's
      // dot and rescale in K order
      uint32_t w[kLR / 2];
#pragma unroll
      for (int rr = 0; rr < kLR / 2; ++rr)
        w[rr] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)rr * np));
#pragma unroll
      for (int j = 0; j < kGPL; ++j) {
        int idot[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) idot[i][c] = 0;
        dot(w, j * kRG / 2, idot);
        rescale(r0 / G + j, gl * kLR / G + j, idot);
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

template <bool QUANT_IN, int G, bool PLAIN_S, bool HAS_BIAS>
int launch(const float* x, const int8_t* xq, const float* sx, const float* xs,
           const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
           const float* sd, const float* sm, float* out, int m, int kp,
           int np, cudaStream_t stream) {
  if (m == 1) {
    dim3 grid(np / kTN, 1);
    qmm_q_kernel<1, QUANT_IN, G, PLAIN_S, HAS_BIAS><<<grid, kThreads, 0, stream>>>(
        x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  } else {
    constexpr int MT = 8;
    dim3 grid(np / kTN, (m + MT - 1) / MT);
    qmm_q_kernel<MT, QUANT_IN, G, PLAIN_S, HAS_BIAS><<<grid, kThreads, 0, stream>>>(
        x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  }
  return static_cast<int>(cudaGetLastError());
}

// GPTQ4 and Q4_1: f32 planes s and m (kp/group, np), group 32, 64 or 128.
template <bool QUANT_IN>
int launch_gptq(const float* x, const int8_t* xq, const float* sx,
                const float* xs, const int8_t* qs, const float* s,
                const float* mn, float* out, int m, int kp, int np, int group,
                cudaStream_t stream) {
  switch (group) {
    case 32:
      return launch<QUANT_IN, 32, true, true>(x, xq, sx, xs, qs, nullptr, nullptr, s, mn,
                                              out, m, kp, np, stream);
    case 64:
      return launch<QUANT_IN, 64, true, true>(x, xq, sx, xs, qs, nullptr, nullptr, s, mn,
                                              out, m, kp, np, stream);
    case 128:
      return launch<QUANT_IN, 128, true, true>(x, xq, sx, xs, qs, nullptr, nullptr, s, mn,
                                               out, m, kp, np, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Q2_K (has_mins 1: sub_m and sm given, B = 8 * s + m) and Q3_K (has_mins 0:
// sub_m and sm null, no bias): int8 (kp/16, np) sub-scales over f32 (kp/256,
// np) factors. A flag that disagrees with the pointers is refused.
template <bool QUANT_IN>
int launch_k16(const float* x, const int8_t* xq, const float* sx, const float* xs,
               const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m, const float* sd,
               const float* sm, float* out, int m, int kp, int np, int has_mins,
               cudaStream_t stream) {
  if (has_mins != (sub_m != nullptr) || has_mins != (sm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (has_mins)
    return launch<QUANT_IN, 16, false, true>(x, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m,
                                             kp, np, stream);
  return launch<QUANT_IN, 16, false, false>(x, xq, sx, xs, qs, sub_s, nullptr, sd, nullptr, out,
                                            m, kp, np, stream);
}

}  // namespace

extern "C" {

// mode "qx" on Q4_K: x f32 (m, kp), quantized in the kernel; at m <= 32 the
// K split of qmm_splitk.cuh (which refuses a null plane).
int ct_qmm_qx(const float* x, const int8_t* qs, const int8_t* sub_s,
              const int8_t* sub_m, const float* sd, const float* sm,
              float* out, int m, int kp, int np, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m >= 1 && m <= ctsk::kMaxM)
    return ctsk::run_nibble<true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, st);
  return launch<true, ctq::kGroup, false, true>(x, nullptr, nullptr, nullptr, qs, sub_s, sub_m,
                                                sd, sm, out, m, kp, np, st);
}

// the K split's plan for ct_qmm_qx at batch size m: the cluster's blocks P,
// or a negative CUDA error code (m outside 1..32 among them)
int ct_qmm_qx_split_plan(int m, int kp, int np) { return ctsk::nibble_plan_of<true>(m, kp, np); }

// the clusters of p blocks that the split's kernel for ct_qmm_qx at batch
// size m runs on the card at once, or a negative CUDA error code
int ct_qmm_qx_split_capacity(int m, int p) { return ctsk::nibble_capacity_of<true>(m, p); }

// mode "q" on Q4_K: xq int8 (m, kp), sx and xsum f32 (m, kp/32) given.
int ct_qmm_q(const int8_t* xq, const float* sx, const float* xs,
             const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
             const float* sd, const float* sm, float* out, int m, int kp,
             int np, void* stream) {
  return launch<false, ctq::kGroup, false, true>(nullptr, xq, sx, xs, qs, sub_s, sub_m, sd, sm,
                                                 out, m, kp, np,
                                                 static_cast<cudaStream_t>(stream));
}

// mode "qx" on GPTQ4 and Q4_1: x f32 (m, kp); s and mn f32 (kp/group, np).
int ct_qmm_qx_gptq(const float* x, const int8_t* qs, const float* s,
                   const float* mn, float* out, int m, int kp, int np,
                   int group, void* stream) {
  return launch_gptq<true>(x, nullptr, nullptr, nullptr, qs, s, mn, out, m, kp, np,
                           group, static_cast<cudaStream_t>(stream));
}

// mode "q" on GPTQ4 and Q4_1: xq int8 (m, kp), sx and xsum f32 (m, kp/group)
// given.
int ct_qmm_q_gptq(const int8_t* xq, const float* sx, const float* xs,
                  const int8_t* qs, const float* s, const float* mn,
                  float* out, int m, int kp, int np, int group, void* stream) {
  return launch_gptq<false>(nullptr, xq, sx, xs, qs, s, mn, out, m, kp, np, group,
                            static_cast<cudaStream_t>(stream));
}

// mode "qx" on Q4_0: x f32 (m, kp); s f32 (kp/32, np); no mins (null), no
// bias.
int ct_qmm_qx_q4_0(const float* x, const int8_t* qs, const float* s, const float*,
                   float* out, int m, int kp, int np, void* stream) {
  return launch<true, 32, true, false>(x, nullptr, nullptr, nullptr, qs, nullptr, nullptr, s,
                                       nullptr, out, m, kp, np,
                                       static_cast<cudaStream_t>(stream));
}

// mode "q" on Q4_0: xq int8 (m, kp) and sx f32 (m, kp/32) given (xsum is not
// read); s f32 (kp/32, np); no mins (null), no bias.
int ct_qmm_q_q4_0(const int8_t* xq, const float* sx, const float* xs, const int8_t* qs,
                  const float* s, const float*, float* out, int m, int kp, int np,
                  void* stream) {
  return launch<false, 32, true, false>(nullptr, xq, sx, xs, qs, nullptr, nullptr, s, nullptr,
                                        out, m, kp, np, static_cast<cudaStream_t>(stream));
}

// mode "qx" on Q2_K and Q3_K: x f32 (m, kp), quantized per group of 16 in
// the kernel.
int ct_qmm_qx_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                  const float* sd, const float* sm, float* out, int m, int kp, int np,
                  int has_mins, void* stream) {
  return launch_k16<true>(x, nullptr, nullptr, nullptr, qs, sub_s, sub_m, sd, sm, out, m, kp,
                          np, has_mins, static_cast<cudaStream_t>(stream));
}

// mode "q" on Q2_K and Q3_K: xq int8 (m, kp), sx and xsum f32 (m, kp/16)
// given (xsum is not read for Q3_K).
int ct_qmm_q_k16(const int8_t* xq, const float* sx, const float* xs, const int8_t* qs,
                 const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm,
                 float* out, int m, int kp, int np, int has_mins, void* stream) {
  return launch_k16<false>(nullptr, xq, sx, xs, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                           has_mins, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
