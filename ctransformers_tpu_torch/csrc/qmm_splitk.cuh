// The decode GEMVs on the factored int8 grids (Q6_K: group 16, no mins;
// Q5_K: group 32, with mins) at m <= 32: ct_qmm_g8 (mode "g") and ct_qmm_f
// (mode "") of qmm_float.cu take this design there, the file's own above.
//
// Replaces, in ctransformers_tpu/ops/qmatmul.py (what they compute is
// qmm_float.cu's, unchanged):
//   _qmm_g_kernel (:1206) on the grids -> ct_qmm_g8
//       out = sum_g s[g,n] * dot_g(bf16(x), q)[t,n] + xsum @ M (Q5_K)
//   _qmm_kernel mode "" (:734) on the grids -> ct_qmm_f
//       out = x @ (q * s + m), all f32
//
// Bound on an H100: the weight's bytes (1 B a weight, 1/G B of sub-scales,
// 4/256 B of factors) at m = 1; at m = 8 the f32 pipes come near (two f32
// operations a weight byte a row: 67 TFLOP/s over 3.35 TB/s is 20). The
// file's first design held a block to 32 columns and all of K: 128 blocks
// at N = 4096, each chunk's weights loaded only after the barrier that
// staged its x, 16 KB in flight an SM, so the narrow long-K shapes ran at
// 2.6-3.0x their bound.
//
// Design:
//   - A block owns 128 output columns (a warp's 32 threads x 4) and a range
//     of K. Its 8 warps are K lanes: warp w takes rows [16 w, 16 w + 16) of
//     each 128-row stage, so a Q6_K group is one warp's and a Q5_K group
//     two warps'. Each thread's cp.async copies are fixed chunks of the
//     stage. m = 1 runs one row of x a block, m > 1 eight (kMT).
//   - K is split over a thread-block cluster of P blocks along x: block r
//     of the cluster takes stages [r nst / P, (r + 1) nst / P) of the nst =
//     kp / kKR, and the cluster adds its P partial tiles through
//     distributed shared memory in rank order, each output element by one
//     thread: runs are bitwise repeatable, a replayed CUDA graph too.
//   - plan() chooses P on the host from the shape alone: the first of 8, 6,
//     4, 3, 2 (up to kMaxP and nst) whose clusters all fit on the card at
//     once (cudaOccupancyMaxActiveClusters), else 1, so that no partial
//     second wave doubles the time: at N = 4096 and m = 1 P = 8, at
//     N = 32768 P = 1 or 2.
//   - The weight stream is kept in flight: a ring of kStages stages in
//     shared memory, each filled by cp.async (16 bytes a copy, L2 only) with
//     its weights, its x rows (zero past m), its sub-scales (and sub-mins)
//     and its superblock row of factors. The loads of stage i + kStages - 1
//     are issued right after the barrier that opens stage i, before its
//     compute: kStages - 1 stages are in flight a block while it computes
//     (the design's 2: 18-19 KB a block at m = 1, up to four blocks an SM,
//     22 KB at 8 rows of x; 3 and 4 stages ran 3-6% slower on an H100,
//     PERF.md).
//   - The int8 grid becomes f32 without a conversion instruction (16 a
//     clock an SM, the stream needs ~15 bytes a clock): each byte, biased
//     by 128, is permuted into the mantissa of 2^23 and 2^23 + 128 is
//     subtracted, exactly.
//   - "g": x is rounded to bf16 in place once a stage (after the group sums
//     of the unrounded x, Q5_K), the exact products summed in f32 over a
//     group, the sum multiplied once by s = sd * sub_s; a Q5_K group's
//     second warp hands its sum to the first through shared memory before
//     that multiply. "": each weight dequantized as __fmul_rn(q, s) (then
//     __fadd_rn(., m), Q5_K) and multiplied in f32 (no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "qmm_wgmma.cuh"

namespace ctsk {

// scripts/torch_qmm_split_ablate.py builds variants of these three
constexpr int kStages = 2;  // stages in the ring
constexpr int kMaxP = 8;    // the largest cluster
constexpr int kMT = 8;      // rows of x a block at m > 1
constexpr int kTN = 128;             // output columns a block
constexpr int kWarps = 8;            // K lanes
constexpr int kThreads = 32 * kWarps;
constexpr int kLR = 16;              // K rows a lane and stage
constexpr int kKR = kWarps * kLR;    // K rows a stage
constexpr int kMaxM = 32;            // the m this design serves
static_assert(kStages >= 2 && kMaxP >= 1 && kMaxP <= 8,
              "a ring of two stages or more, a portable cluster (8 blocks at most)");
// the cluster sizes plan() tries, largest first: 6 and 3 where the card
// holds just too few clusters of 8 or 4 for a shape (the GPCs' SMs are not
// multiples of 4)
constexpr int kPlanParts[] = {8, 6, 4, 3, 2};
static_assert(kMT == 2 || kMT == 4 || kMT == 8, "2, 4 or 8 rows of x a block at m > 1");

// blocks an SM asked of the compiler: three at m = 1 (85 registers a
// thread), two at 8 rows of x (the f32 products take 128)
template <int MT>
constexpr int kMinBlocks = MT >= 8 ? 2 : 3;

// byte offsets of one stage's parts (each a multiple of 16)
template <int MT, int G, bool HAS_MINS>
struct Stage {
  static constexpr int kW = 0;                                   // int8 [kKR][kTN]
  static constexpr int kX = kW + kKR * kTN;                      // f32 [MT][kKR]
  static constexpr int kSub = kX + MT * kKR * 4;                 // int8 [kKR / G][kTN]
  static constexpr int kSubM = kSub + kKR / G * kTN;             // int8 [kKR / G][kTN]
  static constexpr int kSd = kSubM + (HAS_MINS ? kKR / G * kTN : 0);  // f32 [kTN]
  static constexpr int kSm = kSd + 4 * kTN;                      // f32 [kTN]
  static constexpr int kBytes = kSm + (HAS_MINS ? 4 * kTN : 0);
};

// shared memory of a block: the ring, then ("g" on Q5_K) the hand-over of
// a group's second warp and the group sums of x
template <int MT, bool G8, int G, bool HAS_MINS>
struct Smem {
  static constexpr bool kComb = G8 && G > kLR;
  static constexpr bool kBias = G8 && HAS_MINS;
  static constexpr int kRing = kStages * Stage<MT, G, HAS_MINS>::kBytes;
  static constexpr int kComb0 = kRing;  // f32 [kWarps / 2][MT][kTN]
  static constexpr int kXs0 = kComb0 + (kComb ? kWarps / 2 * MT * kTN * 4 : 0);  // f32 [MT][kKR / G]
  static constexpr int kBytes = kXs0 + (kBias ? MT * (kKR / G) * 4 : 0);
  // after the loop the ring holds the warps' tiles, then the block's
  static_assert((kWarps + 1) * MT * kTN * 4 <= kRing, "the reduction fits in the ring");
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(ctw::smem_addr(dst)), "l"(src)
               : "memory");
}

// 16 bytes, or zeros where `full` is false (nothing is read)
__device__ __forceinline__ void cp16z(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(ctw::smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// signed byte c of w as an f32, exactly: wb = w ^ 0x80808080 holds q + 128,
// permuted into the low mantissa byte of 2^23
__device__ __forceinline__ float byte_f32(uint32_t wb, int c) {
  return __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(wb, 0x4B000000u, 0x7540 + c))),
                   8388736.0f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// MT: rows of x a block (1, or kMT at m > 1); G8: mode "g", else ""; G: 16 (Q6_K, no
// mins) or 32 (Q5_K, mins). Grid (np / kTN * parts, ceil(m / MT)) in
// clusters of `parts` along x.
template <int MT, bool G8, int G, bool HAS_MINS>
__global__ void __launch_bounds__(kThreads, kMinBlocks<MT>)
splitk_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
              const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
              const float* __restrict__ sd, const float* __restrict__ sm,
              float* __restrict__ out, int m, int kp, int np, int parts) {
  using St = Stage<MT, G, HAS_MINS>;
  using Sm = Smem<MT, G8, G, HAS_MINS>;
  static_assert(G == kLR || G == 2 * kLR, "a group is one K lane or two");
  static_assert(kKR % G == 0 && ctq::kSuperblock % kKR == 0, "a stage holds whole groups "
                "and lies in one superblock");
  extern __shared__ __align__(16) uint8_t smem[];
  float* comb = reinterpret_cast<float*>(smem + Sm::kComb0);
  float* xs = reinterpret_cast<float*>(smem + Sm::kXs0);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t rank = ctw::cluster_rank();
  const int n0 = static_cast<int>(blockIdx.x) / parts * kTN;
  const int t0 = blockIdx.y * MT;
  const int nst = kp / kKR;
  const int s0 = static_cast<int>(rank) * nst / parts;
  const int n_it = (static_cast<int>(rank) + 1) * nst / parts - s0;

  // ---- stage it of this block's range into ring slot it % kStages ----
  // Each thread's copies are fixed: 16-byte chunks tid + u * kThreads of the
  // weight tile (row tid / 8 + u * kThreads / 8, chunk tid % 8), chunk tid
  // of x's rows, of the sub-scale rows, or of the factor row.
  static_assert(kKR * kTN / 16 == 4 * kThreads, "four weight chunks a thread");
  constexpr int kXChunks = MT * kKR / 4, kSubChunks = kKR / G * kTN / 16;
  constexpr int kSdThread = kThreads - kTN / 4;  // the last warp copies the factors
  static_assert(kXChunks <= kThreads && kSubChunks <= kSdThread, "one chunk a thread");
  const int8_t* wsrc = qs + (size_t)(s0 * kKR + tid / 8) * np + n0 + 16 * (tid % 8);
  const size_t wstep = (size_t)kThreads / 8 * np;  // rows between a thread's chunks
  const bool xlive = tid < kXChunks && t0 + tid / (kKR / 4) < m;
  const float* xsrc = x + (size_t)(xlive ? t0 + tid / (kKR / 4) : 0) * kp + s0 * kKR +
                      4 * (tid % (kKR / 4));
  const size_t ssrc = (size_t)(s0 * kKR / G + tid / 8) * np + n0 + 16 * (tid % 8);
  auto load = [&](int it) {
    uint8_t* b = smem + (it % kStages) * St::kBytes;
    const int8_t* wp = wsrc + (size_t)it * kKR * np;
#pragma unroll
    for (int u = 0; u < 4; ++u) cp16(b + St::kW + 16 * (tid + u * kThreads), wp + u * wstep);
    if (tid < kXChunks) cp16z(b + St::kX + 16 * tid, xsrc + it * kKR, xlive);
    if (tid < kSubChunks) {
      const size_t o = ssrc + (size_t)it * (kKR / G) * np;
      cp16(b + St::kSub + 16 * tid, sub_s + o);
      if (HAS_MINS) cp16(b + St::kSubM + 16 * tid, sub_m + o);
    } else if (tid >= kSdThread) {  // a stage lies in one superblock
      const size_t o = (size_t)((s0 + it) * kKR / ctq::kSuperblock) * np + n0 +
                       4 * (tid - kSdThread);
      cp16(b + St::kSd + 16 * (tid - kSdThread), sd + o);
      if (HAS_MINS) cp16(b + St::kSm + 16 * (tid - kSdThread), sm + o);
    }
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_it) load(it);
    cp_commit();
  }
  const int r0 = w * kLR;  // this lane's first row in a stage
  const int gs = r0 / G;   // its group in the stage
  for (int it = 0; it < n_it; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; slot (it - 1) % kStages is free
    if (it + kStages - 1 < n_it) load(it + kStages - 1);
    cp_commit();
    const uint8_t* b = smem + (it % kStages) * St::kBytes;
    float* xb = reinterpret_cast<float*>(const_cast<uint8_t*>(b) + St::kX);
    if constexpr (G8) {
      // x rounded to bf16 in place; with mins first the group sums of the
      // unrounded x, over the G / 4 neighbouring threads of a group (whole
      // warps: kXChunks is a multiple of 32)
      if (tid < kXChunks) {
        const int c = tid;
        float4 v = reinterpret_cast<float4*>(xb)[c];
        if (Sm::kBias) {
          float s = __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
#pragma unroll
          for (int off = 1; off < G / 4; off <<= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
          if (c % (G / 4) == 0) xs[c / (G / 4)] = s;  // [i][group]
        }
        v.x = bf16_round(v.x);
        v.y = bf16_round(v.y);
        v.z = bf16_round(v.z);
        v.w = bf16_round(v.w);
        reinterpret_cast<float4*>(xb)[c] = v;
      }
      __syncthreads();
    }

    // the group's scale (and min) for this thread's 4 columns
    float s[4], mn[4];
    {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(b + St::kSub + gs * kTN + 4 * lane);
      const float4 d4 = *reinterpret_cast<const float4*>(b + St::kSd + 16 * lane);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = __fmul_rn(dv[c], static_cast<float>(ctq::sbyte(sw, c)));
      if (HAS_MINS) {
        const uint32_t mw =
            *reinterpret_cast<const uint32_t*>(b + St::kSubM + gs * kTN + 4 * lane);
        const float4 m4 = *reinterpret_cast<const float4*>(b + St::kSm + 16 * lane);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) mn[c] = __fmul_rn(mv[c], static_cast<float>(ctq::sbyte(mw, c)));
      }
    }

    // ---- the lane's 16 rows, four at a time ----
    float part[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < kLR; rr += 4) {
      float wv[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t wd =
            *reinterpret_cast<const uint32_t*>(b + St::kW + (r0 + rr + q) * kTN + 4 * lane) ^
            0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wv[q][c] = byte_f32(wd, c);
          if (!G8) {  // q * s (+ m), rounded as the reference's f32 multiply and add
            wv[q][c] = __fmul_rn(wv[q][c], s[c]);
            if (HAS_MINS) wv[q][c] = __fadd_rn(wv[q][c], mn[c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(xb + i * kKR + r0 + rr);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (G8)
              part[i][c] = fmaf(xv[q], wv[q][c], part[i][c]);
            else
              acc[i][c] = fmaf(xv[q], wv[q][c], acc[i][c]);
          }
      }
    }

    if constexpr (G8) {
      if constexpr (Sm::kComb) {
        // a group's second warp hands its partial sum to the first
        float* cb = comb + (w / 2) * MT * kTN + 4 * lane;
        if (w & 1) {
#pragma unroll
          for (int i = 0; i < MT; ++i)
            *reinterpret_cast<float4*>(cb + i * kTN) =
                make_float4(part[i][0], part[i][1], part[i][2], part[i][3]);
        }
        __syncthreads();
        if (!(w & 1)) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float4 o = *reinterpret_cast<const float4*>(cb + i * kTN);
            part[i][0] = __fadd_rn(part[i][0], o.x);
            part[i][1] = __fadd_rn(part[i][1], o.y);
            part[i][2] = __fadd_rn(part[i][2], o.z);
            part[i][3] = __fadd_rn(part[i][3], o.w);
          }
        }
      }
      if (!Sm::kComb || !(w & 1)) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xsv = Sm::kBias ? xs[i * (kKR / G) + gs] : 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float v = __fmul_rn(part[i][c], s[c]);
            if (Sm::kBias) v = __fadd_rn(v, __fmul_rn(xsv, mn[c]));
            acc[i][c] = __fadd_rn(acc[i][c], v);
          }
        }
      }
    }
  }

  // ---- the warps' tiles, added in warp order; then the cluster's, in rank order ----
  cp_wait<0>();
  __syncthreads();  // the ring is free
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MT][kTN]
  float* blk = red + kWarps * MT * kTN;         // [MT][kTN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
    *reinterpret_cast<float4*>(red + (w * MT + i) * kTN + 4 * lane) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int e = tid; e < MT * kTN; e += kThreads) {
    float v = 0.0f;
#pragma unroll
    for (int l = 0; l < kWarps; ++l) v = __fadd_rn(v, red[l * MT * kTN + e]);
    blk[e] = v;
  }
  ctw::cluster_sync();  // every block's tile written
  // block `rank` adds its share of the tile's float4s over the cluster
  constexpr int kE4 = MT * kTN / 4;
  for (int e = static_cast<int>(rank) * kE4 / parts + tid;
       e < (static_cast<int>(rank) + 1) * kE4 / parts; e += kThreads) {
    const uint32_t local = ctw::smem_addr(blk + 4 * e);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < parts; ++q) {
      const float4 v = ctw::ld_cluster(local, static_cast<uint32_t>(q));
      sum.x = __fadd_rn(sum.x, v.x);
      sum.y = __fadd_rn(sum.y, v.y);
      sum.z = __fadd_rn(sum.z, v.z);
      sum.w = __fadd_rn(sum.w, v.w);
    }
    const int t = t0 + 4 * e / kTN;
    if (t < m) *reinterpret_cast<float4*>(out + (size_t)t * np + n0 + 4 * e % kTN) = sum;
  }
  ctw::cluster_sync();  // no block leaves while another reads its tile
}

template <int MT, bool G8, int G, bool HAS_MINS>
struct Split {
  static constexpr size_t kSmem = Smem<MT, G8, G, HAS_MINS>::kBytes;

  static cudaError_t prepare() {
    return cudaFuncSetAttribute(splitk_kernel<MT, G8, G, HAS_MINS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmem));
  }

  // clusters of p blocks the card runs at once, asked once per device and p
  static cudaError_t capacity(int p, int* n) {
    static int cache[16][9] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (p < 1 || p > 8) return cudaErrorInvalidValue;
    if (dev < 16 && cache[dev][p] > 0) {
      *n = cache[dev][p];
      return cudaSuccess;
    }
    e = prepare();
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(n, splitk_kernel<MT, G8, G, HAS_MINS>, &cfg);
    if (e != cudaSuccess) return e;
    if (*n <= 0) return cudaErrorInvalidConfiguration;  // no cluster of p fits an SM group
    if (dev < 16) cache[dev][p] = *n;
    return cudaSuccess;
  }

  // P: the first of kPlanParts up to kMaxP and up to the stage count whose
  // clusters (tiles x row tiles of them) all fit on the card at once
  static cudaError_t plan(int m, int kp, int np, int* parts) {
    const long long clusters = static_cast<long long>(np / kTN) * ((m + MT - 1) / MT);
    const int nst = kp / kKR;
    for (const int p : kPlanParts) {
      if (p > kMaxP || p > nst) continue;
      int n = 0;
      const cudaError_t e = capacity(p, &n);
      if (e != cudaSuccess) return e;
      if (clusters <= n) {
        *parts = p;
        return cudaSuccess;
      }
    }
    *parts = 1;
    return cudaSuccess;
  }

  static int launch(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
                    const float* sd, const float* sm, float* out, int m, int kp, int np,
                    cudaStream_t stream) {
    int parts = 1;
    cudaError_t e = plan(m, kp, np, &parts);
    if (e == cudaSuccess) e = prepare();
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = parts;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(np / kTN * parts, (m + MT - 1) / MT);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, splitk_kernel<MT, G8, G, HAS_MINS>, x, qs, sub_s, sub_m, sd, sm,
                           out, m, kp, np, parts);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
};

// ct_qmm_g8 (G8) or ct_qmm_f at 1 <= m <= kMaxM: group 16 without mins
// (Q6_K) or 32 with both min planes (Q5_K); kp a multiple of 256, np of 128
// (the QTensor's padding)
template <bool G8, int G, bool HAS_MINS>
int run(const float* x, const int8_t* qs, const int8_t* sub_s, const int8_t* sub_m,
        const float* sd, const float* sm, float* out, int m, int kp, int np,
        cudaStream_t stream) {
  if (m < 1 || m > kMaxM || kp < ctq::kSuperblock || kp % ctq::kSuperblock || np < kTN ||
      np % kTN || sub_s == nullptr || sd == nullptr ||
      (HAS_MINS && (sub_m == nullptr || sm == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 1)
    return Split<1, G8, G, HAS_MINS>::launch(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np, stream);
  return Split<kMT, G8, G, HAS_MINS>::launch(x, qs, sub_s, sub_m, sd, sm, out, m, kp, np,
                                              stream);
}

// the clusters of p blocks that run()'s kernel for batch size m runs on the
// card at once, or a negative CUDA error code
template <bool G8, int G, bool HAS_MINS>
int capacity_of(int m, int p) {
  if (m < 1 || m > kMaxM) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t e = m == 1 ? Split<1, G8, G, HAS_MINS>::capacity(p, &n)
                               : Split<kMT, G8, G, HAS_MINS>::capacity(p, &n);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// the plan of run() for a shape: P, or a negative CUDA error code
template <bool G8, int G, bool HAS_MINS>
int plan_of(int m, int kp, int np) {
  if (m < 1 || m > kMaxM || kp < ctq::kSuperblock || kp % ctq::kSuperblock || np < kTN ||
      np % kTN)
    return -static_cast<int>(cudaErrorInvalidValue);
  int parts = 0;
  const cudaError_t e = m == 1 ? Split<1, G8, G, HAS_MINS>::plan(m, kp, np, &parts)
                               : Split<kMT, G8, G, HAS_MINS>::plan(m, kp, np, &parts);
  return e == cudaSuccess ? parts : -static_cast<int>(e);
}

}  // namespace ctsk
