// Dequantize-then-bf16-GEMM, shared by the two ksplit nibble kernels of
// the bf16 function "b" at every m: mode "b" (qmm_prefill.cu: ct_qmm_b_ks)
// and its reshape-broadcast form "rb" (qmm_rb.cu: ct_qmm_rb_ks). Every other
// prompt GEMM runs the Hopper core of qmm_wgmma.cuh instead: the int8-grid
// GEMMs (qmm_grid.cu; the grids' "rb", ct_qmm_rb8 and ct_qmm_rb8_legacy,
// above m = 32, and the K split of qmm_splitk.cuh below), every adjk
// nibble GEMM (qmm_prefill.cu: Q4_K, GPTQ4, Q4_1, Q2_K, Q3_K and Q4_0,
// modes "si" and "i") and the ksplit "sb" (qmm_float.cu).
// Only the weight tile's decoding differs between formats; it comes in as a
// tile type W:
//
//   W::kGroup    K rows per quant group (16 for Q2_K and Q3_K; 32, 64 or
//                128 for a plain ksplit group). A group larger than the K
//                step is walked in several steps, each reading the group's
//                one row of s and B.
//   W::load(qs, sub_s, sub_m, sd, sm, np, kp, k0, col0, tid, Bs)
//                dequantizes rows k0 .. k0+kGemmBK-1 of columns
//                col0 .. col0+kGemmBN-1 into Bs (bf16, row stride
//                kGemmLDB): W = q * s + B rounded once to bf16 (B the
//                format's per-group bias). A format with unfactored planes
//                (plain ksplit) takes sub_s = sub_m = null
//                and its f32 (kp/G, np) planes s and m as sd and sm (m null
//                where it has none). kp tells a ksplit tile which half, and
//                so which nibble, row k0 is in.
//
// The kernel computes out = bf16(x) @ bf16(q * s + B) with f32
// accumulation. No symbol folds a bias through the group sums of x here:
// the sum-fold modes run the Hopper core.
//
// Design (simple first): a block owns a 64 x 64 output tile and walks all
// of K 32 rows at a time, so every output element is summed by one block in
// a fixed order (no atomics, no split-K) and runs are bitwise repeatable.
// Per step its 128 threads round the 64 x 32 activation tile to bf16 and
// dequantize the 32 x 64 weight tile into shared memory, then four warps
// multiply 32 x 32 sub-tiles on the tensor cores with WMMA bf16 16x16x16
// fragments and f32 accumulators. The Hopper core (qmm_wgmma.cuh) is the
// TMA + wgmma design that replaces this one symbol by symbol.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "qmm_common.cuh"

namespace ctq {

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;  // K rows per step
constexpr int kGemmThreads = 128;
constexpr int kGemmLDA = kGemmBK + 8;  // bf16 elements, multiple of 8 for WMMA
constexpr int kGemmLDB = kGemmBN + 8;
constexpr int kGemmLDC = kGemmBN + 4;  // f32 elements, multiple of 4 for WMMA
constexpr int kGemmRowsPerThread = kGemmBM * kGemmBN / kGemmThreads;  // 32 outputs

template <class W>
__global__ void __launch_bounds__(kGemmThreads)
qmm_gemm_kernel(const float* __restrict__ x,       // (m, kp) f32
                const int8_t* __restrict__ qs,     // weight grid, W's layout
                const int8_t* __restrict__ sub_s,  // (kp/G, np)
                const int8_t* __restrict__ sub_m,  // (kp/G, np)   [mins]
                const float* __restrict__ sd,      // (kp/256, np); unfactored: s (kp/G, np)
                const float* __restrict__ sm,      // (kp/256, np) [mins]; unfactored: m
                float* __restrict__ out,           // (m, np)
                int m, int kp, int np) {
  using namespace nvcuda;
  constexpr int G = W::kGroup;
  static_assert(G >= kGemmBK ? G % kGemmBK == 0 : kGemmBK % G == 0,
                "a K step holds whole quant groups, or is a whole part of one");
  __shared__ __align__(128) __nv_bfloat16 As[kGemmBM * kGemmLDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kGemmBK * kGemmLDB];
  __shared__ __align__(128) float Cs[kGemmBM * kGemmLDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int row0 = blockIdx.y * kGemmBM;
  const int col0 = blockIdx.x * kGemmBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  // the output: this thread stores column bn of the tile, rows br0 .. br0+31
  const int bn = tid % kGemmBN;
  const int br0 = (tid / kGemmBN) * kGemmRowsPerThread;

  // activation tile: rows ar + 16*i, columns ac .. ac+3
  const int ar = tid / 8, ac = (tid % 8) * 4;

  for (int k0 = 0; k0 < kp; k0 += kGemmBK) {
#pragma unroll
    for (int i = 0; i < kGemmBM / 16; ++i) {
      const int r = ar + 16 * i;
      const int grow = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (grow < m)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)grow * kp + k0 + ac));
      __nv_bfloat16* a = As + r * kGemmLDA + ac;
      a[0] = __float2bfloat16(v.x);
      a[1] = __float2bfloat16(v.y);
      a[2] = __float2bfloat16(v.z);
      a[3] = __float2bfloat16(v.w);
    }
    W::load(qs, sub_s, sub_m, sd, sm, np, kp, k0, col0, tid, Bs);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + 16 * i) * kGemmLDA + kk, kGemmLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kGemmLDB + wn * 32 + 16 * j, kGemmLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + 16 * i) * kGemmLDC + wn * 32 + 16 * j,
                              c[i][j], kGemmLDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kGemmRowsPerThread; ++i) {
    const int r = br0 + i;
    const int grow = row0 + r;
    if (grow < m) out[(size_t)grow * np + col0 + bn] = Cs[r * kGemmLDC + bn];
  }
}

// Launch over an (m, np) output: one block per 64 x 64 tile.
template <class W>
int launch_gemm(const float* x, const int8_t* qs, const int8_t* sub_s,
                const int8_t* sub_m, const float* sd, const float* sm,
                float* out, int m, int kp, int np, cudaStream_t stream) {
  dim3 grid(np / kGemmBN, (m + kGemmBM - 1) / kGemmBM);
  qmm_gemm_kernel<W><<<grid, kGemmThreads, 0, stream>>>(
      x, qs, sub_s, sub_m, sd, sm, out, m, kp, np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ctq
