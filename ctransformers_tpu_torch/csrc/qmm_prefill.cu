// Dequantize-then-bf16-GEMM Q4_K matmul for prompt chunks (m > 32).
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
// (unpack, scale, round to bf16) is per weight and independent of m. Design
// (simple first): a block owns a 64 x 64 output tile and walks all of K one
// quant group (32 rows) at a time, so every output element is summed by one
// block in a fixed order (no atomics, no split-K). Per step its 128 threads
// load the 64 x 32 activation tile (rounded to bf16) and dequantize the
// 32 x 64 weight tile into shared memory, then four warps multiply 32 x 32
// sub-tiles on the tensor cores with WMMA bf16 16x16x16 fragments and f32
// accumulators. For "si" each thread also keeps the bias sum for 32 of the
// tile's outputs, from the group sums of the f32 activations it loaded.
// Later work: a TMA + wgmma pipeline with several stages in flight.
#include <cuda_bf16.h>
#include <mma.h>

#include "qmm_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = ctq::kGroup;  // one quant group per K step
constexpr int kThreads = 128;
constexpr int kLDA = kBK + 8;  // bf16 elements, multiple of 8 for WMMA
constexpr int kLDB = kBN + 8;
constexpr int kLDC = kBN + 4;  // f32 elements, multiple of 4 for WMMA
constexpr int kRowsPerThread = kBM * kBN / kThreads / 1;  // 32 outputs per thread

template <bool SUMFOLD>
__global__ void __launch_bounds__(kThreads)
qmm_prefill_kernel(const float* __restrict__ x,       // (m, kp) f32
                   const int8_t* __restrict__ qs,     // (kp/2, np)
                   const int8_t* __restrict__ sub_s,  // (kp/32, np)
                   const int8_t* __restrict__ sub_m,  // (kp/32, np)
                   const float* __restrict__ sd,      // (kp/256, np)
                   const float* __restrict__ sm,      // (kp/256, np)
                   float* __restrict__ out,           // (m, np)
                   int m, int kp, int np) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLDB];
  __shared__ __align__(128) float Cs[kBM * kLDC];
  __shared__ float xs_s[kBM];
  __shared__ float b_s[kBN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  // bias sums: this thread owns column bn of the tile, rows br0 .. br0+31
  const int bn = tid % kBN;
  const int br0 = (tid / kBN) * kRowsPerThread;
  float bacc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) bacc[i] = 0.0f;

  // activation tile: rows ar + 16*i, columns ac .. ac+3
  const int ar = tid / 8, ac = (tid % 8) * 4;
  // weight tile: byte row wr (= K rows 2wr, 2wr+1), columns wc .. wc+7
  const int wr = tid / 8, wc = (tid % 8) * 8;

  const int ng = kp / kBK;
  for (int g = 0; g < ng; ++g) {
    const int k0 = g * kBK;
#pragma unroll
    for (int i = 0; i < kBM / 16; ++i) {
      const int r = ar + 16 * i;
      const int grow = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (grow < m)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)grow * kp + k0 + ac));
      if (SUMFOLD) {
        float s = __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        if ((tid & 7) == 0) xs_s[r] = s;
      }
      __nv_bfloat16* a = As + r * kLDA + ac;
      a[0] = __float2bfloat16(v.x);
      a[1] = __float2bfloat16(v.y);
      a[2] = __float2bfloat16(v.z);
      a[3] = __float2bfloat16(v.w);
    }
    {
      const int n = col0 + wc;
      const size_t go = (size_t)g * np + n;
      const size_t fo = (size_t)(g / ctq::kSfactor) * np + n;
      const uint2 sw = __ldg(reinterpret_cast<const uint2*>(sub_s + go));
      const uint2 mw = __ldg(reinterpret_cast<const uint2*>(sub_m + go));
      const float4 d0 = __ldg(reinterpret_cast<const float4*>(sd + fo));
      const float4 d1 = __ldg(reinterpret_cast<const float4*>(sd + fo + 4));
      const float4 m0 = __ldg(reinterpret_cast<const float4*>(sm + fo));
      const float4 m1 = __ldg(reinterpret_cast<const float4*>(sm + fo + 4));
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(
          qs + ((size_t)g * (kBK / 2) + wr) * np + n));
      const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      __nv_bfloat16* b0 = Bs + (2 * wr) * kLDB + wc;
      __nv_bfloat16* b1 = b0 + kLDB;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t swj = j < 4 ? sw.x : sw.y;
        const uint32_t mwj = j < 4 ? mw.x : mw.y;
        const uint32_t wj = j < 4 ? wv.x : wv.y;
        float s, b;
        ctq::group_scale(dv[j], ctq::sbyte(swj, j % 4), mv[j], ctq::sbyte(mwj, j % 4), &s, &b);
        float w0 = __fmul_rn(static_cast<float>(ctq::nibble(wj, 2 * (j % 4))), s);
        float w1 = __fmul_rn(static_cast<float>(ctq::nibble(wj, 2 * (j % 4) + 1)), s);
        if (!SUMFOLD) {
          w0 = __fadd_rn(w0, b);
          w1 = __fadd_rn(w1, b);
        } else if (wr == 0) {
          b_s[wc + j] = b;
        }
        b0[j] = __float2bfloat16(w0);
        b1[j] = __float2bfloat16(w1);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + 16 * i) * kLDA + kk, kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kLDB + wn * 32 + 16 * j, kLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
    if (SUMFOLD) {
      const float bv = b_s[bn];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        bacc[i] = __fadd_rn(bacc[i], __fmul_rn(xs_s[br0 + i], bv));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + 16 * i) * kLDC + wn * 32 + 16 * j,
                              c[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = br0 + i;
    const int grow = row0 + r;
    if (grow < m) {
      float v = Cs[r * kLDC + bn];
      if (SUMFOLD) v = __fadd_rn(v, bacc[i]);
      out[(size_t)grow * np + col0 + bn] = v;
    }
  }
}

template <bool SUMFOLD>
int launch(const float* x, const int8_t* qs, const int8_t* sub_s,
           const int8_t* sub_m, const float* sd, const float* sm, float* out,
           int m, int kp, int np, cudaStream_t stream) {
  dim3 grid(np / kBN, (m + kBM - 1) / kBM);
  qmm_prefill_kernel<SUMFOLD><<<grid, kThreads, 0, stream>>>(
      x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode "si": bf16(x) @ bf16(w4 * s) + xsum @ B
int ct_qmm_si(const float* x, const int8_t* qs, const int8_t* sub_s,
              const int8_t* sub_m, const float* sd, const float* sm,
              float* out, int m, int kp, int np, void* stream) {
  return launch<true>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                      static_cast<cudaStream_t>(stream));
}

// mode "i": bf16(x) @ bf16(w4 * s + B)
int ct_qmm_i(const float* x, const int8_t* qs, const int8_t* sub_s,
             const int8_t* sub_m, const float* sd, const float* sm,
             float* out, int m, int kp, int np, void* stream) {
  return launch<false>(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
