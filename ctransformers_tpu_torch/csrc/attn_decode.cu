// Decode attention (T = 1) over the stacked KV cache, one launch per layer
// per decode token.
//
// Replaces the Pallas kernel scripts/_attention_kernel.py:_kernel (launched
// by decode_attention there): for each slot b and query head, the context
// sum_s softmax(q . k_s / sqrt(dh))[s] * v_s over the cache positions
// s <= n_past[b] of one layer, as an online softmax over chunks of `chunk`
// positions counted from 0. The plain version, which fixes every rounding
// this kernel repeats, is ops/attention.py:plain_decode_attention:
//   * q * scale (f32) is rounded to the compute dtype cdt (bf16 for an int8
//     cache, the cache dtype otherwise) before the QK dot; cache elements
//     widen to f32 exactly (int8 -> f32 equals int8 -> f32 -> bf16);
//   * q . k is summed in f32, times ks[s] for int8, plus slope * kpos with
//     ALiBi (__fmul_rn / __fadd_rn: no contraction into an FMA), masked to
//     kpos <= n_past[b];
//   * per chunk j: the running max m_j over chunks 0..j, alpha_j =
//     exp(m_{j-1} - m_j), p = expf(score - m_j); l sums the unscaled p;
//     p * vs[s] is rounded to cdt (round to nearest even) before the PV
//     dot, summed in f32;
//   * out = acc / max(l, 1e-30).
//
// Bound: bytes. A decode step reads each live K/V row of the layer once
// (2 * (n_past + 1) * Hkv * dh * sizeof(cache) per slot, plus the int8
// scales) and does 4 * H * dh operations a row, far below the card's ridge:
// at llama-2-7B (32 heads of 128) and n_past 2000 that is 65.6 MB of an f32
// cache, 19.6 us at 3.35 TB/s (int8: 16.9 MB, 5.0 us).
//
// Design: a sequence split over a thread-block cluster. One cluster serves
// one (slot, kv head, group of that kv head's rep = H / Hkv query heads)
// and, for a head wider than 256, one column slice of 256 (blockIdx.z).
// `plan` (mirrored by ops/attention.py:decode_plan) chooses on the host,
// from B, Hkv, rep, the window and the card's SM count alone (never from
// n_past, which the card reads and a captured graph replays at every
// value): P, a power of two up to 8 blocks a cluster, the most whose grid
// still fits two blocks an SM (a block of 256 threads and <= 80 registers
// lets three share one, so that the H100 holds 45 clusters of 8 at once;
// at one block an SM llama-2-7B's 32 clusters of 4 ran in two waves), each
// part at least kMinPart rows; and the group (1, 2, 4 or 8 heads, a
// template bucket), halved while the grid would give an SM at most one
// block (a group reads its kv head's rows again, mostly from L2).
// llama-2-7B at B = 1: 32 clusters of 8, 256 blocks of 256 rows each at a
// window of 2048. Each block takes a contiguous part of the window and
// reads only its rows up to n_past[b]: a block whose whole part lies past
// n_past loads nothing and adds a neutral part (max -inf, sums 0). On one
// H100 the time is set by each block's chain of dependent loads, lane sums
// and barriers, not by the bytes (a build that loads no K and V takes half
// the time: PERF.md), so the design buys warps an SM and short chains. A
// block:
//   1. computes its part's scores into shared memory: each row by kTpr
//      lanes with 4-element vector loads, several rows in flight a lane, the
//      rows' and heads' lane sums folded together (fold: a lane keeps half
//      of its values and sends the other half at each level, the same
//      pairs added as in a butterfly of each value); a head wider than 256
//      as the sum of its slices' dots in slice order; then each (head,
//      chunk)'s max over them;
//   2. after a cluster barrier, reads every block's maxima through
//      distributed shared memory (fmaxf: exact in any order) and forms each
//      chunk's running max m_j and alpha_j in chunk order with the same
//      operations as the sequential loop, so every block holds the same
//      bits and rounds p as the Pallas function does;
//   3. computes p, its sums per (head, chunk), p * vs rounded to cdt, and
//      acc = acc * alpha_j + p . v chunk by chunk over its rows (V read the
//      same way as K), then scales acc and its l by the alphas of the later
//      chunks: its part's share of the sequential sums;
//   4. after a second cluster barrier, sums the P parts' l and acc in part
//      order for its share of the output columns (DH / P of them), divides,
//      and waits at a third barrier until no block still reads its memory.
// Only the sums of l and p . v are re-associated (per part, then across
// parts in a fixed order): the result is bitwise repeatable. A part whose
// scores exceed kScoreBudget is taken in spans: the maxima from a first
// pass over all spans, then each span's scores again (K read twice). A head
// of width dh <= 256 runs in a template padded to DH = 64, 128 or 256
// lanes' worth of elements, the lanes past dh loading zeros (so q . k and
// p . v are unchanged); rows whose element offsets are not all multiples
// of 4 (dh % 4 != 0, or odd strides) take element-wise loads in the DH =
// 256 template. An int8 cache's scales go through shared memory, a span at
// a time, out of the score pass's registers (kept beside the rows in flight,
// they made the int8 kernel spill).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;        // blocks an SM at least (__launch_bounds__)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;           // query heads a kv head
constexpr int kVec = 4;              // cache elements a lane loads at once
constexpr int kScoreBudget = 64 * 1024;  // shared bytes for a span's scores
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDh = 256;          // widest template (padded width of the
                                     // element-wise one), the width of a
                                     // wider head's column slices
constexpr int kMaxParts = 8;         // blocks of a cluster (the portable most)
constexpr int kMinPart = 64;         // rows of a part, at least
// floats of `red`: the PV rows' sums, then a part's rep x DH column sums
constexpr int kRed = kThreads * kVec > kMaxRep * kMaxDh ? kThreads * kVec : kMaxRep * kMaxDh;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

struct Vec4 {
  float x[kVec];
};

// kVec cache elements as loaded (16, 8 or 4 bytes); widened to f32 where used,
// so that a lane keeps many rows' loads in flight in few registers
template <typename T>
struct Raw {
  using type = typename std::conditional<
      std::is_same<T, float>::value, float4,
      typename std::conditional<std::is_same<T, int8_t>::value, char4, uint2>::type>::type;
};

// rows a lane has in flight: 64 bytes of f32, bf16 or f16, 32 of int8
template <typename T>
constexpr int kRowsInFlight = sizeof(T) == 4 ? 4 : 8;

template <typename T>
__device__ __forceinline__ typename Raw<T>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T>::type*>(p);
}

// the kVec elements at p of which the first `valid` lie in the head (none
// where valid <= 0), zeros past them: one vector load where the offsets are
// multiples of kVec, else (kScalar) one load per element
template <typename T, bool kScalar>
__device__ __forceinline__ typename Raw<T>::type load_part(const T* p, int valid) {
  typename Raw<T>::type r{};
  if constexpr (!kScalar) {
    if (valid > 0) r = load_raw(p);
  } else {
    using E = typename std::conditional<
        sizeof(T) == 4, uint32_t,
        typename std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type>::type;
    E* e = reinterpret_cast<E*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (i < valid) e[i] = reinterpret_cast<const E*>(p)[i];
    }
  }
  return r;
}

template <typename T>
__device__ __forceinline__ Vec4 widen(const typename Raw<T>::type t) {
  if constexpr (std::is_same<T, float>::value) {
    return {{t.x, t.y, t.z, t.w}};
  } else if constexpr (std::is_same<T, int8_t>::value) {
    return {{static_cast<float>(t.x), static_cast<float>(t.y), static_cast<float>(t.z),
             static_cast<float>(t.w)}};
  } else if constexpr (std::is_same<T, __half>::value) {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&t.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&t.y));
    return {{a.x, a.y, b.x, b.y}};
  } else {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    return {{a.x, a.y, b.x, b.y}};
  }
}

// round an f32 to the compute dtype of a cache of T (identity for f32)
template <typename T>
__device__ __forceinline__ float to_cdt(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {  // bf16, and int8 (cdt bf16)
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// a barrier of every thread of the cluster, ordering its shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// the f32 at the same shared-memory address as p in block `rank` of the cluster
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// the lane sums of V = H values a lane (V a power of two, at most G) over
// groups of G lanes (xor offsets O = G / 2 down to 1): while more than one
// value is left, each lane keeps one half of its values and sends the
// other, so that the level's sums take H / 2 shuffles, not H; then one
// value is summed over the remaining offsets. The same pairs are added as
// in a butterfly of each value, in the same order. After it, v[0] of lane
// l holds the sum of value (l % G) / (G / V).
template <int H, int O>
__device__ __forceinline__ void fold(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (H > 1) {
      constexpr int h = H / 2;
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      fold<h, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      fold<1, O / 2>(v, lane);
    }
  }
}

struct Args {
  const float* q;        // (B, H, dh)
  const void* k;         // the full stacked cache, either layout
  const void* v;
  const float* ks;       // int8 scale planes, or null
  const float* vs;
  const float* slopes;   // (H,) ALiBi slopes, or null
  const int* n_past;     // (B,)
  float* out;            // (B, H, dh)
  int h, hkv, dh, win, chunk;
  int nc;                // chunks of the window
  int parts, part;       // blocks of a cluster; rows of the window a block
  int span;              // rows whose scores share memory at once
  int qw;                // q_s row: DH, or the slices' widths of a wider head
  int rep, grp, ngrp;    // query heads a kv head; a group's; groups a kv head
  float scale;
  long long k_l, k_b, k_s, k_h;  // cache: layer il's offset, slot, position, kv head strides
  long long s_l, s_b, s_s, s_h;  // scale planes, the same
};

// kRep: the query heads of a group, the plan's 1, 2, 4 or 8 (a kv head's
// last group may hold fewer: the heads past it are skipped); DH: the head width a.dh
// padded to 64, 128 or 256, or a slice of 256 of a wider head (a.qw / DH
// slices, this block's blockIdx.z); kScalar: element-wise loads
template <typename T, int DH, int kRep, bool kScalar>
__global__ void __launch_bounds__(kThreads, kMinBlocks) decode_attn_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // score pass: kTpr lanes a row, kNv vectors a lane, kRpw rows a warp
  constexpr int kTpr = DH / kVec < 32 ? DH / kVec : 32;
  constexpr int kNv = DH / (kVec * kTpr);
  constexpr int kRpw = 32 / kTpr;
  // PV pass: kVtpr threads a row, kVrows rows at once
  constexpr int kVtpr = DH / kVec;
  constexpr int kVrows = kThreads / kVtpr;
  static_assert(kNv * kVec * kTpr == DH && kVrows * kVtpr == kThreads, "tiling");
  static_assert(DH <= kThreads, "a thread a column");
  // rows a lane loads before it uses them, in the score pass (at most 16
  // partial dots a lane) and the PV pass
  constexpr int kUnrollK =
      kRowsInFlight<T> / kNv < 16 / kRep ? kRowsInFlight<T> / kNv : 16 / kRep;
  constexpr int kUnrollV = kRowsInFlight<T>;

  extern __shared__ float smem[];
  __shared__ float l_part[kMaxRep];  // this part's share of l, read by the cluster
  // this cluster's kv head g and group of rep query heads from head0; this
  // block's part of the window
  const int part = static_cast<int>(cluster_rank()), unit = blockIdx.x / a.parts;
  const int g = unit / a.ngrp, grp = unit % a.ngrp, b = blockIdx.y;
  const int head0 = g * a.rep + grp * a.grp;
  const int rep = min(a.grp, a.rep - grp * a.grp);
  const int nsl = a.qw / DH, d0 = blockIdx.z * DH;  // slices; this block's first column
  float* q_s = smem;                  // rep x qw: q * scale rounded to cdt
  float* sc = q_s + rep * a.qw;       // rep x span: scores, then p * vs rounded
  float* red = sc + rep * a.span;     // kRed: the PV rows' sums, then this
                                      // part's rep x DH column sums
  float* cmax = red + kRed;             // rep x nc: each chunk's max over this part
  float* msafe = cmax + rep * a.nc;     // rep x nc: running max (0 where -inf)
  float* alpha = msafe + rep * a.nc;    // rep x nc: rescale of the chunks before
  float* psum = alpha + rep * a.nc;     // rep x nc: each chunk's sum of p over this part
  float* ksc = psum + rep * a.nc;       // int8: the span's K scales,
  float* vsc = ksc + a.span;            // and its V scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long off = a.k_l + b * a.k_b + g * a.k_h;
  const T* kb = static_cast<const T*>(a.k) + off;
  const T* vb = static_cast<const T*>(a.v) + off + d0;
  const long long soff = a.s_l + b * a.s_b + g * a.s_h;
  const float* ksb = kQuant ? a.ks + soff : nullptr;
  const float* vsb = kQuant ? a.vs + soff : nullptr;

  for (int i = tid; i < rep * a.qw; i += kThreads) {
    const int r = i / a.qw, d = i % a.qw;
    q_s[i] = d < a.dh
        ? to_cdt<T>(__fmul_rn(a.q[(static_cast<long long>(b) * a.h + head0 + r) * a.dh + d],
                              a.scale))
        : 0.f;
  }
  for (int i = tid; i < rep * a.nc; i += kThreads) {
    cmax[i] = -INFINITY;
    psum[i] = 0.f;
  }
  const int np = a.n_past[b];
  const int n_chunks = min(a.nc, np / a.chunk + 1);
  // this block's live rows [lo, hi): its part up to n_past
  const int lo = part * a.part, hi = min(min(lo + a.part, a.win), np + 1);
  const int nspan = hi > lo ? (hi - lo + a.span - 1) / a.span : 0;
  const int ksub = lane % kTpr, krow = warp * kRpw + lane / kTpr;
  const int vsub = tid % kVtpr, vrow = tid / kVtpr;

  // the scores of rows [s0, s0 + rows) into sc (an int8 cache's scales
  // first into ksc and vsc, out of the score pass's registers), slice by
  // slice (one slice up to width 256)
  auto scores = [&](int s0, int rows) {
    if constexpr (kQuant) {
      for (int i = tid; i < rows; i += kThreads) {
        const long long so = static_cast<long long>(s0 + i) * a.s_s;
        ksc[i] = ksb[so];
        vsc[i] = vsb[so];
      }
      __syncthreads();
    }
    // after the lane sums, lane ksub of a row group holds value `mine` of
    // its kUnrollK x kRep (row, head) dots
    constexpr int kVals = kUnrollK * kRep;
    static_assert(kVals <= kTpr, "a value a lane at least");
    const int mine = ksub / (kTpr / kVals), mu = mine / kRep, mr = mine % kRep;
    for (int base = 0; base < rows; base += kWarps * kRpw * kUnrollK) {
      float dot = 0.f;  // this lane's (row, head) score: the slices' sums in order
      for (int sl = 0; sl < nsl; ++sl) {
        typename Raw<T>::type kr[kUnrollK][kNv];
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
          const int row = base + u * kWarps * kRpw + krow;
#pragma unroll
          for (int n = 0; n < kNv; ++n) {
            const int e0 = sl * DH + (n * kTpr + ksub) * kVec;
            kr[u][n] = load_part<T, kScalar>(kb + static_cast<long long>(s0 + row) * a.k_s + e0,
                                             row < rows ? a.dh - e0 : 0);
          }
        }
        // the rows' partial dots, then their sums over the kTpr lanes of a
        // row group (fold)
        float pd[kUnrollK][kRep];
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
#pragma unroll
          for (int r = 0; r < kRep; ++r) {
            pd[u][r] = 0.f;
            if (r < rep) {
#pragma unroll
              for (int n = 0; n < kNv; ++n) {
                const float* qq = q_s + r * a.qw + sl * DH + (n * kTpr + ksub) * kVec;
                const Vec4 kv = widen<T>(kr[u][n]);
#pragma unroll
                for (int e = 0; e < kVec; ++e) pd[u][r] = fmaf(qq[e], kv.x[e], pd[u][r]);
              }
            }
          }
        }
        fold<kVals, kTpr / 2>(&pd[0][0], ksub);
        dot = sl == 0 ? pd[0][0] : dot + pd[0][0];
      }
      const int row = base + mu * kWarps * kRpw + krow;
      if (ksub % (kTpr / kVals) == 0 && row < rows && mr < rep) {
        float x = dot;
        if constexpr (kQuant) x = __fmul_rn(x, ksc[row]);
        if (a.slopes) {
          x = __fadd_rn(x, __fmul_rn(a.slopes[head0 + mr], static_cast<float>(s0 + row)));
        }
        sc[mr * a.span + row] = x;
      }
    }
  };

  // 1. every span's scores and each (head, chunk)'s max over this part
  for (int sp = 0; sp < nspan; ++sp) {
    const int s0 = lo + sp * a.span, rows = min(a.span, hi - s0);
    __syncthreads();  // q_s and cmax written; the previous span's sc read
    scores(s0, rows);
    __syncthreads();
    const int j0 = s0 / a.chunk, nj = (s0 + rows - 1) / a.chunk - j0 + 1;
    for (int pr = warp; pr < rep * nj; pr += kWarps) {
      const int r = pr / nj, j = j0 + pr % nj;
      const int r1 = min(s0 + rows, (j + 1) * a.chunk) - s0;
      const float* row = sc + r * a.span;
      float mx = -INFINITY;
      for (int i = max(s0, j * a.chunk) - s0 + lane; i < r1; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) cmax[r * a.nc + j] = fmaxf(cmax[r * a.nc + j], mx);
    }
  }
  cluster_sync();  // every part's maxima written

  // 2. each chunk's max over the cluster's parts, then the running max
  // through the chunks in order: the same bits in every block
  for (int i = tid; i < rep * n_chunks; i += kThreads) {
    const int at = i / n_chunks * a.nc + i % n_chunks;
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < kMaxParts; ++p) {
      if (p < a.parts) mx = fmaxf(mx, ld_peer(cmax + at, p));
    }
    msafe[at] = mx;
  }
  __syncthreads();
  if (tid < rep) {
    float m = -INFINITY;
    for (int j = 0; j < n_chunks; ++j) {
      const float m_new = fmaxf(m, msafe[tid * a.nc + j]);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      alpha[tid * a.nc + j] = isfinite(m) ? expf(m - m_safe) : 0.f;
      msafe[tid * a.nc + j] = m_safe;
      m = m_new;
    }
  }
  __syncthreads();

  // 3. p, its sums, p * vs rounded to cdt, and acc = acc * alpha + p . v
  // chunk by chunk over this part's rows
  float acc[kRep][kVec];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }
  int jcur = lo / a.chunk - 1;  // the last chunk whose alpha acc holds
  for (int sp = 0; sp < nspan; ++sp) {
    const int s0 = lo + sp * a.span, rows = min(a.span, hi - s0);
    if (nspan > 1) {  // the span's scores again (pass 1 kept the last span's)
      if (sp > 0) __syncthreads();  // the previous span's sc read
      scores(s0, rows);
      __syncthreads();
    }
    const int j0 = s0 / a.chunk, nj = (s0 + rows - 1) / a.chunk - j0 + 1;
    for (int pr = warp; pr < rep * nj; pr += kWarps) {
      const int r = pr / nj, j = j0 + pr % nj;
      const int r1 = min(s0 + rows, (j + 1) * a.chunk) - s0;
      float* row = sc + r * a.span;
      const float m_safe = msafe[r * a.nc + j];
      float sum = 0.f;
      for (int i = max(s0, j * a.chunk) - s0 + lane; i < r1; i += 32) {
        const float p = expf(row[i] - m_safe);
        sum += p;
        row[i] = to_cdt<T>(kQuant ? __fmul_rn(p, vsc[i]) : p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) psum[r * a.nc + j] += sum;
    }
    __syncthreads();
    for (int j = j0; j < j0 + nj; ++j) {
      if (j > jcur) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          if (r < rep) {
            const float al = alpha[r * a.nc + j];
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[r][e] *= al;
          }
        }
        jcur = j;
      }
      const int r1 = min(s0 + rows, (j + 1) * a.chunk) - s0;
      for (int base = max(s0, j * a.chunk) - s0 + vrow; base < r1; base += kVrows * kUnrollV) {
        typename Raw<T>::type vr[kUnrollV];
#pragma unroll
        for (int u = 0; u < kUnrollV; ++u) {
          const int row = base + u * kVrows;
          vr[u] = load_part<T, kScalar>(
              vb + static_cast<long long>(s0 + row) * a.k_s + vsub * kVec,
              row < r1 ? a.dh - d0 - vsub * kVec : 0);
        }
#pragma unroll
        for (int u = 0; u < kUnrollV; ++u) {
          const int row = base + u * kVrows;
          if (row < r1) {
            const Vec4 vv = widen<T>(vr[u]);
#pragma unroll
            for (int r = 0; r < kRep; ++r) {
              if (r < rep) {
                const float p = sc[r * a.span + row];
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vv.x[e], acc[r][e]);
              }
            }
          }
        }
      }
    }
  }
  // the alphas of the chunks after this part's last; l of this part
  for (int j = jcur + 1; j < n_chunks; ++j) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      if (r < rep) {
        const float al = alpha[r * a.nc + j];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] *= al;
      }
    }
  }
  __syncthreads();  // psum complete
  if (tid < rep) {
    float l = 0.f;
    for (int j = lo / a.chunk; j < n_chunks; ++j) {
      l = __fadd_rn(__fmul_rn(l, alpha[tid * a.nc + j]), psum[tid * a.nc + j]);
    }
    l_part[tid] = l;
  }
  // the PV rows' partial sums, head by head: column tid's sums in colsum
  float colsum[kRep];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    colsum[r] = 0.f;
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[tid * kVec + e] = acc[r][e];
      __syncthreads();
      if (tid < DH) {
        for (int gi = 0; gi < kVrows; ++gi) colsum[r] += red[gi * DH + tid];
      }
      __syncthreads();
    }
  }
  if (tid < DH) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      if (r < rep) red[r * DH + tid] = colsum[r];
    }
  }
  cluster_sync();  // every part's l and column sums written

  // 4. this block's DH / parts output columns: the parts summed in order
  const int cols = DH / a.parts;
  for (int i = tid; i < rep * cols; i += kThreads) {
    const int r = i / cols, d = part * cols + i % cols;
    if (d0 + d < a.dh) {
      float s = 0.f, l = 0.f;
      for (int p = 0; p < a.parts; ++p) {
        s += ld_peer(red + r * DH + d, p);
        l += ld_peer(l_part + r, p);
      }
      a.out[(static_cast<long long>(b) * a.h + head0 + r) * a.dh + d0 + d] =
          __fdiv_rn(s, fmaxf(l, 1e-30f));
    }
  }
  cluster_sync();  // no block leaves while another reads its memory
}

template <typename T, int DH, int kRep, bool kScalar>
cudaError_t launch(const Args& a, int batch, size_t smem, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, DH, kRep, kScalar>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.hkv * a.ngrp * a.parts, batch, a.qw / DH);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int DH, bool kScalar>
cudaError_t by_rep(const Args& a, int batch, size_t smem, cudaStream_t st) {
  const int group = a.grp;
  if (group == 1) return launch<T, DH, 1, kScalar>(a, batch, smem, st);
  if (group == 2) return launch<T, DH, 2, kScalar>(a, batch, smem, st);
  if (group == 4) return launch<T, DH, 4, kScalar>(a, batch, smem, st);
  return launch<T, DH, 8, kScalar>(a, batch, smem, st);
}

template <typename T>
cudaError_t by_head_dim(const Args& a, bool scalar, int batch, size_t smem, cudaStream_t st) {
  if (scalar) return by_rep<T, kMaxDh, true>(a, batch, smem, st);
  if (a.dh > kMaxDh) return by_rep<T, kMaxDh, false>(a, batch, smem, st);
  if (a.dh <= 64) return by_rep<T, 64, false>(a, batch, smem, st);
  if (a.dh <= 128) return by_rep<T, 128, false>(a, batch, smem, st);
  return by_rep<T, 256, false>(a, batch, smem, st);
}

// the split (ops/attention.py:decode_plan): a kv head's query heads in
// groups of `group` (1, 2, 4 or 8), a cluster of `parts` blocks a (slot, kv
// head, group), each taking `part` rows of the window. parts: the most, up
// to kMaxParts, whose grid still fits two blocks an SM (three fit: the
// H100 holds 45 clusters of 8 at once), each part at least kMinPart rows;
// the group halved while the grid would give an SM at most one block (each
// group reads the kv head's rows again, mostly from L2)
void plan(int batch, int hkv, int rep, int win, int sms, int* parts, int* part, int* group) {
  int grp = 1;
  while (grp < std::min(rep, kMaxRep)) grp *= 2;
  for (;;) {
    const long long units = static_cast<long long>(batch) * hkv * ((rep + grp - 1) / grp);
    int p = 1;
    while (p < kMaxParts && win >= 2 * p * kMinPart && units * 2 * p <= 2 * sms) p *= 2;
    if (grp > 1 && units * p <= sms) {
      grp /= 2;
      continue;
    }
    *parts = p;
    *part = (win + p - 1) / p;
    *group = grp;
    return;
  }
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16, 3 int8 (ks and vs given exactly for int8);
// dh: any head width whose q rows and scores fit the block's shared memory
// (widths above 256 in slices of 256); h / hkv query heads a kv head, any
// number;
// strides in elements of the cache's (layer, slot, position, kv head) axes
// and of the scale planes' (zero without them). Returns a CUDA error code.
extern "C" int ct_decode_attn(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* slopes, const void* n_past, void* out,
                              int dtype, int batch, int h, int hkv, int dh, int win, int chunk,
                              int il, float scale, long long k_sl, long long k_sb,
                              long long k_ss, long long k_sh, long long s_sl, long long s_sb,
                              long long s_ss, long long s_sh, void* stream) {
  const bool quant = dtype == kI8;
  if ((ks != nullptr) != quant || (vs != nullptr) != quant || batch <= 0 || hkv <= 0 ||
      h % hkv || dh <= 0 || chunk <= 0 || win % chunk || il < 0) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int rep = h / hkv;
  int parts = 1, part = win, grp_rep = 1;  // grp_rep: query heads of a block
  plan(batch, hkv, rep, win, sms, &parts, &part, &grp_rep);
  const int span = std::min(part, std::max(1, kScoreBudget / (4 * grp_rep)));
  const int nc = win / chunk;
  // vector loads need every row's elements at multiples of kVec (the cache
  // pointer itself is 16-byte aligned)
  const bool scalar = dh % kVec || k_sl % kVec || k_sb % kVec || k_ss % kVec || k_sh % kVec;
  // q_s's row: the padded template width, or 256 a slice of a wider head
  const int qw = dh > kMaxDh ? (dh + kMaxDh - 1) / kMaxDh * kMaxDh
                             : scalar ? kMaxDh : dh <= 64 ? 64 : dh <= 128 ? 128 : kMaxDh;
  const size_t smem =
      4 * (static_cast<size_t>(grp_rep) * qw + static_cast<size_t>(grp_rep) * span +
           kRed + 4 * static_cast<size_t>(grp_rep) * nc + (quant ? 2 * span : 0));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
         static_cast<const float*>(vs), static_cast<const float*>(slopes),
         static_cast<const int*>(n_past), static_cast<float*>(out), h, hkv, dh, win, chunk,
         nc, parts, part, span, qw, rep, grp_rep, (rep + grp_rep - 1) / grp_rep, scale, il * k_sl,
         k_sb, k_ss, k_sh, il * s_sl, s_sb, s_ss, s_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return by_head_dim<float>(a, scalar, batch, smem, st);
    case kBF16: return by_head_dim<__nv_bfloat16>(a, scalar, batch, smem, st);
    case kF16: return by_head_dim<__half>(a, scalar, batch, smem, st);
    case kI8: return by_head_dim<int8_t>(a, scalar, batch, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
