// Shared helpers for the quantized-matmul kernels.
//
// Weight layout (ctransformers_tpu_torch/ops/qmatmul.py, QTensor in the
// "adjk" layout): for a logical (K, N) weight padded to (Kp, Np),
//   qs     int8 (Kp/2, Np)   byte (r, n) holds rows 2r (low nibble) and
//                            2r+1 (high nibble) of column n, each stored as
//                            the two's-complement value w4 = q - 8 in [-8, 7]
//   sub_s  int8 (Kp/32, Np)  6-bit sub-scales, one per group of 32 rows
//   sub_m  int8 (Kp/32, Np)  6-bit sub-mins
//   sd     f32  (Kp/256, Np) superblock scale d
//   sm     f32  (Kp/256, Np) superblock min (-dmin)
// so that W[k, n] = w4 * s + B with s = sd * sub_s, m = sm * sub_m and the
// per-group bias B = 8 * s + m.
//
// Q2_K and Q3_K share that layout at group 16: sub_s (and Q2_K's sub_m) are
// int8 (Kp/16, Np), 16 groups a superblock. Q2_K stores its grid q in [0, 3]
// as w4 = q - 8 with 4-bit sub-scales and sub-mins, so B = 8 * s + m as
// Q4_K's; Q3_K stores its signed grid q in [-4, 3] as the nibble itself
// (zero point 8) with signed 6-bit sub-scales and no mins: W = w4 * s, no
// bias.
//
// GPTQ 4-bit and Q4_1 weights share the qs layout; their scale planes are
// not factored: s and m are f32 (Kp/G, Np) planes read as they are, one row
// per group of G = 32, 64 or 128 rows (Q4_1: 32), and B = 8 * s + m as
// above. Q4_0 stores its signed grid q in [-8, 7] as the nibble itself (zero
// point 8) with one f32 (Kp/32, Np) plane s and no mins: W = w4 * s, no bias.
//
// The same six nibble kinds packed "ksplit": qs is uint8 (Kp/2, Np), byte
// (r, n) holds row r in the low nibble as lo = q + zp and row r + Kp/2 in
// the high nibble as hi = q + zp, the byte XOR 0x80, so that the byte read
// as int8 is b = 16 (hi - 8) + lo: f = floor(b / 16) = hi - 8 and
// l = b - 16 f = lo. Then W = l * s + B_lo in the low half and f * s + B_hi
// in the high half, with B_lo = -zp * s + m and B_hi = (8 - zp) * s + m
// (zp 0 with mins: m and 8 s + m; zp 8 without: -8 s and none). The scale
// planes are indexed by the logical row (a superblock of a small weight may
// span both halves).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ctq {

constexpr int kGroup = 32;       // K rows per Q4_K quant group
constexpr int kSuperblock = 256; // K rows per k-quant superblock (sd, sm)

// Sign-extended nibble `idx` (0..7, low nibble first) of a 32-bit word.
__device__ __forceinline__ int nibble(uint32_t w, int idx) {
  return static_cast<int>(w << (28 - 4 * idx)) >> 28;
}

// Signed byte `idx` (0..3) of a 32-bit word.
__device__ __forceinline__ int sbyte(uint32_t w, int idx) {
  return static_cast<int>(w << (24 - 8 * idx)) >> 24;
}

// Group scale and bias for one column of a factored nibble weight with mins
// (Q4_K, Q2_K), rounded exactly as the reference formula: s = sd * sub_s,
// B = 8 * s + sm * sub_m (no fused multiply-add, so the f32 values match the
// plain PyTorch version bit for bit).
__device__ __forceinline__ void group_scale(float d, int sub_s, float dm,
                                            int sub_m, float* s, float* b) {
  const float sv = __fmul_rn(d, static_cast<float>(sub_s));
  const float mv = __fmul_rn(dm, static_cast<float>(sub_m));
  *s = sv;
  *b = __fadd_rn(__fmul_rn(8.0f, sv), mv);
}

// The bias of an unfactored nibble group with mins (GPTQ4, Q4_1):
// B = 8 * s + m, rounded as the reference formula (no fused multiply-add).
__device__ __forceinline__ float plain_bias(float s, float m) {
  return __fadd_rn(__fmul_rn(8.0f, s), m);
}

// Scale s and min m (0 without mins) of group g, column n: factored with SF
// groups a superblock (s = sd * sub_s, m = sm * sub_m, each an f32 product
// rounded once, as the reference's _apply_factors), or, SF = 0, the f32
// planes s and m themselves, passed as sd and sm.
template <int SF, bool HAS_MINS>
__device__ __forceinline__ void group_sm(const int8_t* __restrict__ sub_s,
                                         const int8_t* __restrict__ sub_m,
                                         const float* __restrict__ sd,
                                         const float* __restrict__ sm, int np, int g, int n,
                                         float* s, float* m) {
  const size_t go = (size_t)g * np + n;
  *m = 0.0f;
  if constexpr (SF == 0) {
    *s = __ldg(sd + go);
    if constexpr (HAS_MINS) *m = __ldg(sm + go);
  } else {
    const size_t fo = (size_t)(g / SF) * np + n;
    *s = __fmul_rn(__ldg(sd + fo), static_cast<float>(__ldg(sub_s + go)));
    if constexpr (HAS_MINS)
      *m = __fmul_rn(__ldg(sm + fo), static_cast<float>(__ldg(sub_m + go)));
  }
}

// The bias of a ksplit group, rounded as the reference: the low half
// -zp * s + m, the high half (8 - zp) * s + m; with mins (zp 0) m and
// 8 s + m, without (zp 8) -8 s and none (0).
template <bool HAS_MINS>
__device__ __forceinline__ float ksplit_bias(float s, float m, bool hi) {
  if constexpr (HAS_MINS) return hi ? __fadd_rn(__fmul_rn(8.0f, s), m) : m;
  return hi ? 0.0f : __fmul_rn(-8.0f, s);
}

// The grid value a ksplit byte (read as int8, b = 16 (hi - 8) + lo) gives
// its half: f = floor(b / 16) = hi - 8 in the high half, l = b - 16 f = lo
// in the low one.
__device__ __forceinline__ int ksplit_value(int b, bool hi) { return hi ? (b >> 4) : (b & 15); }

// The ksplit layouts there are, named by (group, has mins, superblock
// factor count): factored Q4_K (group 32, with mins), Q2_K and Q3_K (group
// 16, with and without); unfactored GPTQ4 and Q4_1 (group 32, 64 or 128,
// with mins) and Q4_0 (group 32, without). Returns f.run<G, SF, HAS_MINS>(),
// or `bad` for a layout there is not.
template <class F>
int ksplit_layout(const F& f, int group, int has_mins, int sfactor,
                  int bad = static_cast<int>(cudaErrorInvalidValue)) {
  if (sfactor == 0) {
    if (!has_mins) return group == 32 ? f.template run<32, 0, false>() : bad;
    switch (group) {
      case 32: return f.template run<32, 0, true>();
      case 64: return f.template run<64, 0, true>();
      case 128: return f.template run<128, 0, true>();
    }
    return bad;
  }
  if (group * sfactor != kSuperblock) return bad;
  if (group == 32 && has_mins) return f.template run<32, 8, true>();
  if (group == 16) return has_mins ? f.template run<16, 16, true>() : f.template run<16, 16, false>();
  return bad;
}

// f.run<G, SF, HAS_MINS> on the planes in the kernels' order (unfactored:
// no sub-planes, s and m as sd and sm)
template <class F>
struct KsplitPlanes {
  const F& f;
  const void* scales;
  const void* mins;
  const float* sd;
  const float* sm;
  template <int G, int SF, bool HAS_MINS>
  int run() const {
    if constexpr (SF == 0)
      return f.template run<G, SF, HAS_MINS>(nullptr, nullptr, static_cast<const float*>(scales),
                                             static_cast<const float*>(mins));
    else
      return f.template run<G, SF, HAS_MINS>(static_cast<const int8_t*>(scales),
                                             static_cast<const int8_t*>(mins), sd, sm);
  }
};

// The ksplit layouts a symbol takes, read from the ints it is given (the
// pointers must agree, they select nothing; ksplit_layout). With mins the
// zero point is 0, without it 8. Calls f.run<G, SF, HAS_MINS> on the planes
// (KsplitPlanes), or returns cudaErrorInvalidValue for a layout there is
// not or pointers that disagree.
template <class F>
int dispatch_ksplit(const F& f, const void* scales, const void* mins, const float* sd,
                    const float* sm, int group, int has_mins, int zp, int sfactor) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (scales == nullptr || has_mins != (mins != nullptr) || zp != (has_mins ? 0 : 8)) return bad;
  if (sfactor == 0 ? sd != nullptr || sm != nullptr : sd == nullptr || has_mins != (sm != nullptr))
    return bad;
  return ksplit_layout(KsplitPlanes<F>{f, scales, mins, sd, sm}, group, has_mins, sfactor);
}

}  // namespace ctq
