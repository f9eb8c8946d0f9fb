// Quantized matmuls on float activations for small m (decode and short
// chunks): the grouped dot "g" on every served layout, the f32
// dequantize-and-dot modes "" and "s" on the int8 grids, and "sb" on ksplit
// nibbles (at m > 32 on the Hopper core). The ksplit modes "", "s", "b" and
// "rb" are qmm_ksplit.cu's.
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
//   _qmm_pack4_s_kernel (mode "sb", bf16 dots) -> ct_qmm_sb_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + bf16(x) @ bf16(v * s) on the
//       ksplit nibbles of every kind (qmm_common.cuh; x_lo, x_hi the two
//       halves of x's columns, xs their f32 group sums): at m <= 32 the
//       first design's ksplit lanes with x rounded to bf16 as it is staged
//       and each v * s rounded to bf16 before the f32 product (a bf16 x
//       bf16 product is exact in f32: the tensor core's products, summed in
//       a fixed order); at m > 32 the Hopper core's ksplit nibble tile
//       (qmm_wgmma.cuh)
// The scale planes are the k-quants' int8 sub-scales times f32 superblock
// factors (Q4_K at group 32, Q2_K and Q3_K at 16, the grids), or (PLAIN_S:
// GPTQ4, Q4_1, Q4_0 and the legacy grids Q8_0, Q5_0, Q5_1, the reference's
// sfactor == 0 branches) f32 (kp/G, np) planes s and m read as they are.
//
// Design: qmm_float.cuh (the first design) and, at m <= 32 for "g" and ""
// on the factored grids and "g" on Q4_K, qmm_splitk.cuh (the K split).
#include "qmm_float.cuh"
#include "qmm_splitk.cuh"
#include "qmm_wgmma.cuh"

namespace {

// ct_qmm_sb_ks of a layout dispatch_ksplit names: the first design at
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
// "g" and "" at m <= 32 on the K split of qmm_splitk.cuh, the rest on the
// first design.
template <int MODE>
int launch_grid(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                const float* sd, const float* sm, float* out, int m, int kp, int np,
                int group, cudaStream_t stream) {
  constexpr bool kSplit = MODE == kModeG || MODE == kModeF;
  constexpr int kSplitMode = MODE == kModeG ? ctsk::kGridG : ctsk::kGridF;
  const bool split = kSplit && m >= 1 && m <= ctsk::kMaxM;
  if (group == 16 && sub_m == nullptr) {
    if constexpr (kSplit)
      if (split)
        return ctsk::run<kSplitMode, 16, false>(x, qs, sub_s, nullptr, sd, nullptr, out, m,
                                                kp, np, stream);
    return launch<MODE, kGrid, false, 16, false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                                 stream);
  }
  if (group == 32 && sub_m != nullptr) {
    if constexpr (kSplit)
      if (split)
        return ctsk::run<kSplitMode, 32, true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
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
    return g8 ? ctsk::plan_of<ctsk::kGridG, 16, false>(m, kp, np)
              : ctsk::plan_of<ctsk::kGridF, 16, false>(m, kp, np);
  if (group == 32)
    return g8 ? ctsk::plan_of<ctsk::kGridG, 32, true>(m, kp, np)
              : ctsk::plan_of<ctsk::kGridF, 32, true>(m, kp, np);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// the clusters of p blocks the split's kernel for ct_qmm_g8 (g8 1) or
// ct_qmm_f at batch size m runs on the card at once (qmm_splitk.cuh), or a
// negative CUDA error code.
int ct_qmm_grid_split_capacity(int g8, int group, int m, int p) {
  if (group == 16)
    return g8 ? ctsk::capacity_of<ctsk::kGridG, 16, false>(m, p)
              : ctsk::capacity_of<ctsk::kGridF, 16, false>(m, p);
  if (group == 32)
    return g8 ? ctsk::capacity_of<ctsk::kGridG, 32, true>(m, p)
              : ctsk::capacity_of<ctsk::kGridF, 32, true>(m, p);
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
