// Dequantize-then-bf16-GEMM 4-bit matmul for prompt chunks (m > 32), on Q4_K
// and Q2_K weights ("si", "i"), on Q3_K weights ("si", "i", without a bias),
// on GPTQ 4-bit and Q4_1 weights ("si", "i") and on Q4_0 weights ("si", "i",
// without a bias).
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_i4_s_kernel (mode "si"): W' = w4 * s rounded to bf16, x rounded to
//       bf16, products summed in f32, plus the affine bias as an f32 sum
//       over groups: out = bf16(x) @ bf16(w4 * s) + xsum @ B;
//   _qmm_i4_kernel   (mode "i"):  W = w4 * s + B per element, rounded to
//       bf16: out = bf16(x) @ bf16(w4 * s + B).
//
// Bound on an H100: at m = 128 a 4-bit weight byte feeds 512 multiply-adds,
// above the bf16 ridge (~295 operations per byte), so the kernel is
// operation-bound once the tensor cores are kept busy; the dequantization
// (unpack, scale, round to bf16) is per weight and independent of m.
//
// Every adjk symbol here runs the Hopper core of qmm_wgmma.cuh through its
// adjk nibble tile: modes "si" and "i" on Q4_K (ct_qmm_si, ct_qmm_i:
// factored scales s = sd * sub_s and m = sm * sub_m at group 32, two groups
// a stage), on GPTQ4 and Q4_1 (ct_qmm_si_gptq, ct_qmm_i_gptq: the f32 planes
// s and m read as they are, one row per group of 32, 64 or 128 rows, the
// reference's sfactor == 0 branch; a group of 128 spans two of the core's
// 64-row stages), on Q2_K and Q3_K (ct_qmm_si_k16, ct_qmm_i_k16: factored
// scales at group 16, four groups a stage; Q3_K has no bias, so its "si"
// computes what "i" does) and on Q4_0 (ct_qmm_i_q4_0, ct_qmm_si_q4_0: the
// f32 s plane at group 32 and no min plane, the reference's `b is None`
// branch, W = w4 * s; "si" computes what "i" does). w4 * s (+ B in mode
// "i") is rounded once to bf16 and, in mode "si", B = 8 s + m folded
// through the f32 group sums of x.
//
// The ksplit nibbles' GEMMs ("b", "rb", "sb": ct_qmm_b_ks, ct_qmm_rb_ks in
// qmm_ksplit.cu, ct_qmm_sb_ks in qmm_float.cu) take the core's ksplit
// nibble tile above m = 32.
#include "qmm_wgmma.cuh"

namespace {

// GPTQ4 and Q4_1 at group 32, 64 or 128 on the Hopper core's adjk tile:
// mode "i" or, FOLD, mode "si"; both planes are needed
template <bool FOLD>
int launch_gptq(const float* x, const int8_t* qs, const float* s, const float* mn,
                float* out, int m, int kp, int np, int group, cudaStream_t st) {
  if (s == nullptr || mn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{nullptr, nullptr, s, mn, out, m, kp, np};
  switch (group) {
    case 32: return ctw::launch_core<32, true, true, FOLD, false, true>(x, qs, p, st);
    case 64: return ctw::launch_core<64, true, true, FOLD, false, true>(x, qs, p, st);
    case 128: return ctw::launch_core<128, true, true, FOLD, false, true>(x, qs, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Q4_K on the Hopper core's adjk tile with factored scales at group 32: mode
// "i" or, FOLD, mode "si"; every plane is needed (Q4_K always has mins)
template <bool FOLD>
int launch_q4k(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               cudaStream_t st) {
  if (sub_s == nullptr || sub_m == nullptr || sd == nullptr || sm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
  return ctw::launch_core<32, true, false, FOLD, false, true>(x, qs, p, st);
}

// Q4_0 on the Hopper core's adjk tile: the plain s plane (kp/32, np) and no
// min plane (the reference's `b is None` branch: no bias, so "si" has nothing
// to fold and computes what "i" does, W = w4 * s); a min plane is refused
int launch_q40(const float* x, const int8_t* qs, const float* s, const float* mn, float* out,
               int m, int kp, int np, cudaStream_t st) {
  if (s == nullptr || mn != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{nullptr, nullptr, s, nullptr, out, m, kp, np};
  return ctw::launch_core<32, false, true, false, false, true>(x, qs, p, st);
}

// Q2_K (has_mins 1: sub_m and sm given, B = 8 * s + m) and Q3_K (has_mins 0:
// both null, no bias) on the Hopper core's adjk tile with factored scales at
// group 16; a flag that disagrees with the pointers is refused. Mode "i"
// adds Q2_K's bias to each weight before its one bf16 rounding, mode "si"
// (FOLD) folds it through the group sums of x, four groups a stage; Q3_K has
// nothing to fold, so both modes run one instantiation.
template <bool FOLD>
int launch_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
               const float* sd, const float* sm, float* out, int m, int kp, int np,
               int has_mins, cudaStream_t st) {
  if (has_mins != (sub_m != nullptr) || has_mins != (sm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctw::Params p{sub_s, sub_m, sd, sm, out, m, kp, np};
  if (has_mins) return ctw::launch_core<16, true, false, FOLD, false, true>(x, qs, p, st);
  return ctw::launch_core<16, false, false, false, false, true>(x, qs, p, st);
}

}  // namespace

extern "C" {

// mode "si" on Q4_K: bf16(x) @ bf16(w4 * s) + xsum @ B, xsum the f32 sums
// of x over each group of 32 rows
int ct_qmm_si(const float* x, const int8_t* qs, const int8_t* sub_s,
              const int8_t* sub_m, const float* sd, const float* sm,
              float* out, int m, int kp, int np, void* stream) {
  return launch_q4k<true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                          static_cast<cudaStream_t>(stream));
}

// mode "i" on Q4_K: bf16(x) @ bf16(w4 * s + B)
int ct_qmm_i(const float* x, const int8_t* qs, const int8_t* sub_s,
             const int8_t* sub_m, const float* sd, const float* sm,
             float* out, int m, int kp, int np, void* stream) {
  return launch_q4k<false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                           static_cast<cudaStream_t>(stream));
}

// mode "i" on GPTQ4 and Q4_1: bf16(x) @ bf16(w4 * s + B), B = 8 * s + mn; s
// and mn f32 (kp/group, np), group 32, 64 or 128.
int ct_qmm_i_gptq(const float* x, const int8_t* qs, const float* s,
                  const float* mn, float* out, int m, int kp, int np,
                  int group, void* stream) {
  return launch_gptq<false>(x, qs, s, mn, out, m, kp, np, group,
                            static_cast<cudaStream_t>(stream));
}

// mode "si" on GPTQ4 and Q4_1: bf16(x) @ bf16(w4 * s) + xsum @ B,
// B = 8 * s + mn, xsum the f32 sums of x over each group of 32, 64 or 128
// rows.
int ct_qmm_si_gptq(const float* x, const int8_t* qs, const float* s,
                   const float* mn, float* out, int m, int kp, int np,
                   int group, void* stream) {
  return launch_gptq<true>(x, qs, s, mn, out, m, kp, np, group,
                           static_cast<cudaStream_t>(stream));
}

// mode "i" on Q4_0: bf16(x) @ bf16(w4 * s); s f32 (kp/32, np), no mins (null).
int ct_qmm_i_q4_0(const float* x, const int8_t* qs, const float* s, const float* mn,
                  float* out, int m, int kp, int np, void* stream) {
  return launch_q40(x, qs, s, mn, out, m, kp, np, static_cast<cudaStream_t>(stream));
}

// mode "si" on Q4_0: the reference's sum-fold kernel with no bias to fold,
// bf16(x) @ bf16(w4 * s), as "i" (the same instantiation).
int ct_qmm_si_q4_0(const float* x, const int8_t* qs, const float* s, const float* mn,
                   float* out, int m, int kp, int np, void* stream) {
  return launch_q40(x, qs, s, mn, out, m, kp, np, static_cast<cudaStream_t>(stream));
}

// mode "i" on Q2_K and Q3_K: bf16(x) @ bf16(w4 * s + B) (B absent for Q3_K).
int ct_qmm_i_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                 const float* sd, const float* sm, float* out, int m, int kp, int np,
                 int has_mins, void* stream) {
  return launch_k16<false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, has_mins,
                           static_cast<cudaStream_t>(stream));
}

// mode "si" on Q2_K and Q3_K: bf16(x) @ bf16(w4 * s) + xsum @ B, xsum the f32
// sums of x over each group of 16 rows (Q3_K: no bias to fold, as "i").
int ct_qmm_si_k16(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                  const float* sd, const float* sm, float* out, int m, int kp, int np,
                  int has_mins, void* stream) {
  return launch_k16<true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, has_mins,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
