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
// The ksplit nibbles of every kind (ops/qmatmul.py; qmm_common.cuh) take
// qmm_gemm.cuh's 64 x 64 WMMA GEMM (tiles, fixed-order sums, no fold)
// through a tile of this file:
//   _qmm_pack4_kernel,   mode "b":  out = bf16(x) @ bf16(v * s + B)
//                                    -> ct_qmm_b_ks
// with v = l in the low half of K and f in the high half and B that half's
// bias. A byte row holds one row of each half; a 32-row K step lies wholly
// in one half (kp/2 is a multiple of 128), so the tile knows its nibble and
// its half's bias and reads only the byte rows of its step (one nibble of
// each byte: ksplit streams the weight twice over a prompt chunk, once per
// half). One symbol serves every kind; it reads the layout from its ints
// (ctq::dispatch_ksplit). Mode "sb" on ksplit (ct_qmm_sb_ks) is
// qmm_float.cu's, on the Hopper core's ksplit tile at m > 32.
#include "qmm_gemm.cuh"
#include "qmm_wgmma.cuh"

namespace {

// ksplit nibbles (kp/2, np) of any kind: G, SF groups a superblock (0:
// the f32 planes s and m come as sd and sm) and whether there are mins. Each
// of the 128 threads takes 4 byte rows x 4 columns of the step (one 32-bit
// load per row), which lie in one group. Mode "b".
template <int G, int SF, bool HAS_MINS>
struct KsplitTile {
  static constexpr int kGroup = G;
  static constexpr int kWRows = ctq::kGemmBK * ctq::kGemmBN / 4 / ctq::kGemmThreads;
  static_assert(kWRows * ctq::kGemmThreads * 4 == ctq::kGemmBK * ctq::kGemmBN,
                "threads must tile the weight step");
  static_assert(G % kWRows == 0, "a thread's rows lie in one quant group");

  __device__ __forceinline__ static void load(
      const int8_t* __restrict__ qs,     // (kp/2, np) ksplit bytes
      const int8_t* __restrict__ sub_s,  // (kp/G, np)     [SF]
      const int8_t* __restrict__ sub_m,  // (kp/G, np)     [SF, HAS_MINS]
      const float* __restrict__ sd,      // (kp/256, np); SF 0: s (kp/G, np)
      const float* __restrict__ sm,      // (kp/256, np) [HAS_MINS]; SF 0: m
      int np, int kp, int k0, int col0, int tid, __nv_bfloat16* Bs) {
    const int half = kp / 2;
    const bool hi = k0 >= half;  // the step's half: its nibble and its bias
    // logical rows wr .. wr+kWRows-1 of the step, columns wc .. wc+3
    const int wr = (tid / 16) * kWRows, wc = (tid % 16) * 4;
    const int n = col0 + wc;
    const int g = (k0 + wr) / G;
    float s[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mv;
      ctq::group_sm<SF, HAS_MINS>(sub_s, sub_m, sd, sm, np, g, n + j, &s[j], &mv);
      b[j] = ctq::ksplit_bias<HAS_MINS>(s[j], mv, hi);
    }
    const int8_t* qrow = qs + (size_t)(k0 - (hi ? half : 0) + wr) * np + n;
    uint32_t w[kWRows];
#pragma unroll
    for (int r = 0; r < kWRows; ++r)
      w[r] = __ldg(reinterpret_cast<const unsigned int*>(qrow + (size_t)r * np));
#pragma unroll
    for (int r = 0; r < kWRows; ++r) {
      __nv_bfloat16* dst = Bs + (wr + r) * ctq::kGemmLDB + wc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = ctq::ksplit_value(ctq::sbyte(w[r], j), hi);
        dst[j] = __float2bfloat16(__fadd_rn(__fmul_rn(static_cast<float>(v), s[j]), b[j]));
      }
    }
  }
};

// The ksplit "b" GEMM of a layout dispatch_ksplit names.
struct KsplitGemm {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    return ctq::launch_gemm<KsplitTile<G, SF, HAS_MINS>>(x, qs, sub_s, sub_m, sd, sm, out, m,
                                                         kp, np, st);
  }
};

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

// mode "b" on ksplit nibbles: scales and mins the QTensor's planes
// (int8 sub-planes where sfactor > 0, else f32 s and m), sd and sm its
// factors (null where sfactor is 0); group, has_mins, zp and sfactor name
// the layout (ctq::dispatch_ksplit refuses one there is not).
int ct_qmm_b_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(
      KsplitGemm{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, scales, mins, sd, sm,
      group, has_mins, zp, sfactor);
}

}  // extern "C"
