// The reshape-broadcast dequantize-and-matmul "r" (f32 dots) on int8 grids
// and on ksplit nibbles. Its bf16 form "rb" computes the function of "b"
// and runs "b"'s designs: the int8 grids' ct_qmm_rb8 and ct_qmm_rb8_legacy
// in qmm_grid.cu, the ksplit ct_qmm_rb_ks in qmm_ksplit.cu.
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py:
//   _qmm_rb_kernel       (mode "r") -> ct_qmm_r8 (Q6_K, Q5_K) and
//       ct_qmm_r8_legacy (Q8_0, Q5_0, Q5_1): out = x @ (q * s + m), all f32
//   _qmm_pack4_rb_kernel (mode "r") -> ct_qmm_r_ks on the ksplit nibbles of
//       every kind (qmm_common.cuh):
//       out = x_lo @ (l * s + B_lo) + x_hi @ (f * s + B_hi), the same way
// These compute the functions of _qmm_kernel and _qmm_pack4_kernel (ct_qmm_f,
// ct_qmm_f_ks). The reference's variant applies the per-group planes
// through a (groups, group, columns) reshape and a broadcast instead of a
// repeat along the rows; the Hopper reading of that form organises the
// dequantization by (group, column) pair:
//   1. a thread holds one pair's s and B in registers (read once),
//   2. it dequantizes that group's rows of the K step in its column into a
//      tile in shared memory (each row an f32 product and sum rounded once,
//      as the reference's),
//   3. the dot reads the tile.
// ct_qmm_f and the ksplit kernels instead apply the scale per row inside
// the dot loop. "r" keeps the dot on the f32 pipes: a block owns 8 rows (1
// at decode) x 32 output columns and all of K, its 256 threads dequantize a
// 128-row step of the 32 columns into an f32 tile, 16 rows (one pair) each,
// then each thread sums 16 rows of the tile, taken 8 apart, for its column;
// the 8 partial sums of a column are added in a fixed order at the end, so
// runs are bitwise repeatable. A segment of 16 rows lies in one group (G is
// 16 to 128) and a 128-row step in one half of a ksplit weight (kp/2 is a
// multiple of 128).
//
// Bound on an H100: as "" (bytes at decode, f32 operations above m = 8).
// This simple version reads one byte per thread and row (a warp reads 32
// neighbouring bytes of a row) and re-reads the weight once per 8 rows of
// x; no gain over the per-row forms is claimed.
#include "qmm_common.cuh"

namespace {

enum Fmt { kGridFmt, kKsplitFmt };

// Rows k .. k+ROWS-1 (one group, one ksplit half) of column n dequantized
// into dst[0], dst[ld], ...: q * s (+ m) on a grid, v * s + B on ksplit
// nibbles, the pair's s and B read once.
template <int FMT, int G, int SF, bool HAS_MINS, int ROWS>
__device__ __forceinline__ void dequant_pair(const int8_t* __restrict__ qs,
                                             const int8_t* __restrict__ sub_s,
                                             const int8_t* __restrict__ sub_m,
                                             const float* __restrict__ sd,
                                             const float* __restrict__ sm, int np, int kp,
                                             int k, int n, float* dst, int ld) {
  static_assert(G % ROWS == 0, "a segment lies in one group");
  float s, b;
  ctq::group_sm<SF, HAS_MINS>(sub_s, sub_m, sd, sm, np, k / G, n, &s, &b);
  const bool hi = FMT == kKsplitFmt && k >= kp / 2;
  if (FMT == kKsplitFmt) b = ctq::ksplit_bias<HAS_MINS>(s, b, hi);
  const int8_t* q = qs + (size_t)(k - (hi ? kp / 2 : 0)) * np + n;
  int raw[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) raw[r] = __ldg(q + (size_t)r * np);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int v = FMT == kKsplitFmt ? ctq::ksplit_value(raw[r], hi) : raw[r];
    float w = __fmul_rn(static_cast<float>(v), s);
    if (FMT == kKsplitFmt || HAS_MINS) w = __fadd_rn(w, b);
    dst[r * ld] = w;
  }
}

// ---- "r": f32 dots -------------------------------------------------------

constexpr int kRTN = 32;                 // output columns per block
constexpr int kRRows = 16;               // rows of one (group, column) pair per step
constexpr int kRSeg = 8;                 // pairs down a step
constexpr int kRKC = kRSeg * kRRows;     // 128 K rows per step
constexpr int kRThreads = kRTN * kRSeg;  // 256

template <int MT>
struct RSmem {
  float x[MT][kRKC];
  float w[kRKC][kRTN];
  float red[kRSeg][MT][kRTN];
};

template <int MT, int FMT, int G, int SF, bool HAS_MINS>
__global__ void __launch_bounds__(kRThreads)
qmm_r_kernel(const float* __restrict__ x,       // (m, kp) f32
             const int8_t* __restrict__ qs,     // (kp, np) grid or (kp/2, np) ksplit bytes
             const int8_t* __restrict__ sub_s,  // (kp/G, np)     [SF]
             const int8_t* __restrict__ sub_m,  // (kp/G, np)     [SF, HAS_MINS]
             const float* __restrict__ sd,      // (kp/256, np); SF 0: s (kp/G, np)
             const float* __restrict__ sm,      // (kp/256, np) [HAS_MINS]; SF 0: m
             float* __restrict__ out,           // (m, np)
             int m, int kp, int np) {
  static_assert(sizeof(RSmem<MT>) <= 48 * 1024, "static shared memory limit");
  __shared__ RSmem<MT> sh;
  const int tid = threadIdx.x;
  const int c = tid % kRTN, seg = tid / kRTN;  // a warp is one segment
  const int n = blockIdx.x * kRTN + c;
  const int t0 = blockIdx.y * MT;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < kp; k0 += kRKC) {
    for (int e = tid; e < MT * kRKC; e += kRThreads) {
      const int i = e / kRKC, kk = e % kRKC;
      sh.x[i][kk] = t0 + i < m ? __ldg(x + (size_t)(t0 + i) * kp + k0 + kk) : 0.0f;
    }
    // 1-2: this thread's (group, column) pair, its 16 rows of the step
    dequant_pair<FMT, G, SF, HAS_MINS, kRRows>(qs, sub_s, sub_m, sd, sm, np, kp,
                                               k0 + seg * kRRows, n, &sh.w[seg * kRRows][c],
                                               kRTN);
    __syncthreads();
    // 3: the dot reads the tile, rows seg, seg + 8, ... of column c
#pragma unroll
    for (int j = 0; j < kRRows; ++j) {
      const int kk = seg + kRSeg * j;
      const float wv = sh.w[kk][c];
#pragma unroll
      for (int i = 0; i < MT; ++i) acc[i] = fmaf(sh.x[i][kk], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) sh.red[seg][i][c] = acc[i];
  __syncthreads();
  for (int e = tid; e < MT * kRTN; e += kRThreads) {
    const int i = e / kRTN, col = e % kRTN;
    float v = 0.0f;
    for (int l = 0; l < kRSeg; ++l) v = __fadd_rn(v, sh.red[l][i][col]);
    if (t0 + i < m) out[(size_t)(t0 + i) * np + blockIdx.x * kRTN + col] = v;
  }
}

template <int FMT>
struct RLaunch {
  const float* x;
  const int8_t* qs;
  float* out;
  int m, kp, np;
  cudaStream_t st;
  template <int G, int SF, bool HAS_MINS>
  int run(const int8_t* sub_s, const int8_t* sub_m, const float* sd, const float* sm) const {
    if (m == 1) {
      qmm_r_kernel<1, FMT, G, SF, HAS_MINS><<<dim3(np / kRTN, 1), kRThreads, 0, st>>>(
          x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
    } else {
      constexpr int MT = 8;
      qmm_r_kernel<MT, FMT, G, SF, HAS_MINS><<<dim3(np / kRTN, (m + MT - 1) / MT), kRThreads, 0,
                                              st>>>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// factored int8 grids: group 16 without mins (Q6_K) or 32 with mins (Q5_K)
template <class L>
int dispatch_grid(const L& l, const int8_t* sub_s, const int8_t* sub_m, const float* sd,
                  const float* sm, int group) {
  if (group == 16 && sub_m == nullptr)
    return l.template run<16, 16, false>(sub_s, nullptr, sd, nullptr);
  if (group == 32 && sub_m != nullptr) return l.template run<32, 8, true>(sub_s, sub_m, sd, sm);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the legacy grids: group 32, f32 planes s and mn, mn null exactly when
// has_mins is 0 (Q8_0, Q5_0; Q5_1 has mins)
template <class L>
int dispatch_legacy(const L& l, const float* s, const float* mn, int has_mins) {
  if (has_mins != (mn != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  return has_mins ? l.template run<32, 0, true>(nullptr, nullptr, s, mn)
                  : l.template run<32, 0, false>(nullptr, nullptr, s, nullptr);
}

}  // namespace

extern "C" {

// mode "r" on a factored int8 grid (Q6_K, Q5_K)
int ct_qmm_r8(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
              const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
              void* stream) {
  return dispatch_grid(RLaunch<kGridFmt>{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)},
                       sub_s, sub_m, sd, sm, group);
}

// mode "r" on a legacy int8 grid (Q8_0, Q5_0, Q5_1): s and mn f32
// (kp/32, np), mn null exactly when has_mins is 0
int ct_qmm_r8_legacy(const float* x, const int8_t* qs, const float* s, const float* mn,
                     float* out, int m, int kp, int np, int has_mins, void* stream) {
  return dispatch_legacy(
      RLaunch<kGridFmt>{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, s, mn,
      has_mins);
}

// mode "r" on ksplit nibbles: scales and mins the QTensor's planes
// (int8 sub-planes where sfactor > 0, else f32 s and m), sd and sm its
// factors (null where sfactor is 0); group, has_mins, zp and sfactor name
// the layout (ctq::dispatch_ksplit refuses one there is not).
int ct_qmm_r_ks(const float* x, const int8_t* qs, const void* scales, const void* mins,
                const float* sd, const float* sm, float* out, int m, int kp, int np, int group,
                int has_mins, int zp, int sfactor, void* stream) {
  return ctq::dispatch_ksplit(
      RLaunch<kKsplitFmt>{x, qs, out, m, kp, np, static_cast<cudaStream_t>(stream)}, scales,
      mins, sd, sm, group, has_mins, zp, sfactor);
}

}  // extern "C"
