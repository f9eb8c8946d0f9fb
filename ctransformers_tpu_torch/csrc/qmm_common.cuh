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

}  // namespace ctq
