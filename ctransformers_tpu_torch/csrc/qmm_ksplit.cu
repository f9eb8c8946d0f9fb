// The dequantize-and-dot modes "" and "s" (f32) and "b" / "rb" (bf16
// operands) on the ksplit nibbles of every kind (qmm_common.cuh: Q4_K, Q2_K,
// Q3_K, GPTQ4, Q4_1, Q4_0), one symbol per mode that reads the layout from
// its ints (ctq::dispatch_ksplit).
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_pack4_kernel   (:783, mode "",  f32 dots) -> ct_qmm_f_ks
//       out = x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), all f32
//   _qmm_pack4_s_kernel (:957, mode "s", f32 dots) -> ct_qmm_s_ks
//       out = xs_lo @ B_lo + xs_hi @ B_hi + x_lo @ (l * s) + x_hi @ (f * s)
//   _qmm_pack4_kernel   (:783, mode "b") and _qmm_pack4_rb_kernel (:872,
//   mode "rb") -> ct_qmm_b_ks, ct_qmm_rb_ks
//       out = bf16(x) @ bf16(v * s + B), f32 sums ("rb" is the reference's
//       reshape-broadcast form of the same function)
// with x_lo, x_hi the two halves of x's columns, xs their f32 group sums,
// l and f the low and high nibble's grid values (v = l in the low half of
// K, f in the high one), B_lo = -zp * s + m and B_hi = (8 - zp) * s + m (no
// mins: zp 8, B_lo = -8 s, no B_hi).
//
// Bound on an H100: the weight's bytes (half a byte a weight, the planes
// besides) at m = 1; at m = 8 the f32 pipes (8 products a weight at half a
// byte: 32 operations a byte against the card's ~20) for "" and "s"; "b"
// at m = 128 about equally bytes and tensor-core operations.
//
// Design: at 1 <= m <= 32 qmm_splitk.cuh's ksplit family (ksplit_kernel: a
// block of 128 columns whose 8 warps take 16 byte rows of each 128-row
// stage and both nibbles of each byte, K split over a thread-block cluster,
// the bytes and both halves' planes in a cp.async ring, x staged once a
// block, each nibble put into the mantissa of 2^23 instead of an I2F; "b"
// rounds each weight and x to bf16, on mma.sync at m > 1). Above 32: for
// "" and "s" the first design of qmm_float.cuh, which only a user's table
// reaches there (the race and the fixed rule offer "" and "s" up to 32);
// for "b" and "rb" the Hopper core's ksplit nibble tile without the sum
// fold (qmm_wgmma.cuh: each half's bias added to each weight before its one
// bf16 rounding). "rb" runs "b"'s instantiations.
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

// ct_qmm_b_ks and ct_qmm_rb_ks of a layout dispatch_ksplit names: the
// split's "b" at m <= 32, the Hopper core's ksplit nibble tile without the
// fold above
struct KsplitB {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    if (m >= 1 && m <= ctsk::kMaxM)
      return ctsk::run_ksplit<ctsk::kKsB, G, SF, HAS_MINS>(x, qs, sub_s, sub_m, sd, sm, out, m,
                                                            kp, np, st);
    const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
    return ctw::launch_core<G, HAS_MINS, SF == 0, false, true>(x, qs, p, st);
  }
};

// The split's plan (P) or its cluster capacity for a layout in mode 0 (""),
// 1 ("s") or 2 ("b"); a negative CUDA error code for a mode or a layout
// there is not, or m outside 1..32.
struct KsplitPlan {
  int mode, m, kp, np, p;
  bool capacity;
  template <int MODE, int G, int SF, bool HAS_MINS>
  int of() const {
    return capacity ? ctsk::ksplit_capacity_of<MODE, G, SF, HAS_MINS>(m, p)
                    : ctsk::ksplit_plan_of<MODE, G, SF, HAS_MINS>(m, kp, np);
  }
  template <int G, int SF, bool HAS_MINS>
  int run() const {
    switch (mode) {
      case 0: return of<ctsk::kKsF, G, SF, HAS_MINS>();
      case 1: return of<ctsk::kKsS, G, SF, HAS_MINS>();
      case 2: return of<ctsk::kKsB, G, SF, HAS_MINS>();
    }
    return -static_cast<int>(cudaErrorInvalidValue);
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

// modes "b" and "rb" on ksplit nibbles (one function, the same
// instantiations): the planes and ints as ct_qmm_f_ks takes them
int ct_qmm_b_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(KsplitB{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)},
                              scales, mins, sd, sm, group, has_mins, zp, sfactor);
}

int ct_qmm_rb_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                 const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                 int has_mins, int zp, int sfactor, void* stream) {
  return ct_qmm_b_ks(x, qs, scales, mins, sd, sm, out, m, kp, np, group, has_mins, zp, sfactor,
                     stream);
}

// the K split's plan for ct_qmm_f_ks (mode 0), ct_qmm_s_ks (1) or
// ct_qmm_b_ks and ct_qmm_rb_ks (2) on the layout (group, has_mins, sfactor)
// at batch size m: the cluster's blocks P, or a negative CUDA error code (a
// mode or a layout there is not, m outside 1..32, kp not a multiple of 256
// or np of 128)
int ct_qmm_ks_split_plan(int mode, int group, int has_mins, int sfactor, int m, int kp, int np) {
  return ctq::ksplit_layout(KsplitPlan{mode, m, kp, np, 0, false}, group, has_mins, sfactor,
                            -static_cast<int>(cudaErrorInvalidValue));
}

// the clusters of p blocks that the split's kernel for that mode, layout and
// batch size runs on the card at once, or a negative CUDA error code
int ct_qmm_ks_split_capacity(int mode, int group, int has_mins, int sfactor, int m, int p) {
  return ctq::ksplit_layout(KsplitPlan{mode, m, 0, 0, p, true}, group, has_mins, sfactor,
                            -static_cast<int>(cudaErrorInvalidValue));
}

}  // extern "C"
