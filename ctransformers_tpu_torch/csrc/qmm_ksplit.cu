// The f32 dequantize-and-dot modes "" and "s" on the ksplit nibbles of every
// kind (qmm_common.cuh: Q4_K, Q2_K, Q3_K, GPTQ4, Q4_1, Q4_0), one symbol per
// mode that reads the layout from its ints (ctq::dispatch_ksplit).
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_pack4_kernel   (:783, mode "",  f32 dots) -> ct_qmm_f_ks
//       out = x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), all f32
//   _qmm_pack4_s_kernel (:957, mode "s", f32 dots) -> ct_qmm_s_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + x_lo @ (l * s) + x_hi @ (f * s)
// with x_lo, x_hi the two halves of x's columns, xs their f32 group sums,
// l and f the low and high nibble's grid values, B_lo = -zp s + m and
// B_hi = (8 - zp) s + m (no mins: zp 8, B_lo = -8 s, no B_hi).
//
// Bound on an H100: the weight's bytes (half a byte a weight, the planes
// besides) at m = 1; at m = 8 the f32 pipes (8 products a weight at half a
// byte: 32 operations a byte against the card's ~20).
//
// Design: at 1 <= m <= 32 qmm_splitk.cuh's ksplit family (ksplit_kernel: a
// block of 128 columns whose 8 warps take 16 byte rows of each 128-row
// stage and both nibbles of each byte, K split over a thread-block cluster,
// the bytes and both halves' planes in a cp.async ring, x staged once a
// block, each nibble put into the mantissa of 2^23 instead of an I2F);
// above 32 the first design of qmm_float.cuh, which only a user's table
// reaches there (the race and the fixed rule offer "" and "s" up to 32).
#include "qmm_float.cuh"
#include "qmm_splitk.cuh"

namespace {

// The kernel of a layout dispatch_ksplit names: the K split at m <= 32,
// the first design above.
template <int MODE>
struct KsplitFloat {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    constexpr int kSplitMode = MODE == kModeS ? ctsk::kKsS : ctsk::kKsF;
    if (m >= 1 && m <= ctsk::kMaxM)
      return ctsk::run_ksplit<kSplitMode, G, SF, HAS_MINS>(x, qs, sub_s, sub_m, sd, sm, out, m,
                                                            kp, np, st);
    return launch<MODE, kKsplit, SF == 0, G, HAS_MINS>(x, qs, sub_s, sub_m, sd, sm, out, m, kp,
                                                       np, st);
  }
};

// The split's plan (P) or its cluster capacity for a layout; a negative
// CUDA error code for a layout there is not or m outside 1..32.
struct KsplitPlan {
  int mode_s, m, kp, np, p;
  bool capacity;
  template <int G, int SF, bool HAS_MINS>
  int run() const {
    if (capacity)
      return mode_s ? ctsk::ksplit_capacity_of<ctsk::kKsS, G, SF, HAS_MINS>(m, p)
                    : ctsk::ksplit_capacity_of<ctsk::kKsF, G, SF, HAS_MINS>(m, p);
    return mode_s ? ctsk::ksplit_plan_of<ctsk::kKsS, G, SF, HAS_MINS>(m, kp, np)
                  : ctsk::ksplit_plan_of<ctsk::kKsF, G, SF, HAS_MINS>(m, kp, np);
  }
};

}  // namespace

extern "C" {

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

// the K split's plan for ct_qmm_s_ks (mode_s 1) or ct_qmm_f_ks on the
// layout (group, has_mins, sfactor) at batch size m: the cluster's blocks
// P, or a negative CUDA error code (a layout there is not, m outside 1..32,
// kp not a multiple of 256 or np of 128)
int ct_qmm_ks_split_plan(int mode_s, int group, int has_mins, int sfactor, int m, int kp,
                         int np) {
  return ctq::ksplit_layout(KsplitPlan{mode_s, m, kp, np, 0, false}, group, has_mins, sfactor,
                            -static_cast<int>(cudaErrorInvalidValue));
}

// the clusters of p blocks that the split's kernel for that layout and
// batch size runs on the card at once, or a negative CUDA error code
int ct_qmm_ks_split_capacity(int mode_s, int group, int has_mins, int sfactor, int m, int p) {
  return ctq::ksplit_layout(KsplitPlan{mode_s, m, 0, 0, p, true}, group, has_mins, sfactor,
                            -static_cast<int>(cudaErrorInvalidValue));
}

}  // extern "C"
