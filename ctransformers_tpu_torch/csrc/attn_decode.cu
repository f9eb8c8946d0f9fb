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
//   * per chunk: the running max, alpha = exp(m_old - m_new), p = expf(score
//     - m_new); l sums the unscaled p; p * vs[s] is rounded to cdt
//     (round to nearest even) before the PV dot, summed in f32;
//   * out = acc / max(l, 1e-30).
//
// Bound: bytes. A decode step reads each live K/V row of the layer once
// (2 * n_past * Hkv * dh * sizeof(cache) per slot, plus the int8 scales)
// and does 4 * H * dh operations a row, far below the card's ridge.
// Design: one block per (slot, kv head, group of at most 8 of that kv
// head's rep = H / Hkv query heads; a template bucket of 1, 2, 4 or 8), so
// each K/V row is read from device memory once per group (once in all
// where rep <= 8; twice for a 16-over-1 GQA). A loop over the chunks takes
// the place of the Pallas grid's sequential axis and stops after the chunk
// that holds n_past (later chunks are fully masked and add nothing). The
// scores of a span of chunks stay in shared memory, never in device
// memory. Each score
// row is taken by kTpr lanes with 4-element vector loads, several rows in
// flight a lane, and the rows' lane sums (shuffles) interleaved: a warp's
// work per row is a chain of dependent steps, and with only B * Hkv blocks
// (32 at llama-2-7B, B = 1) those chains, not the bytes, set the time. The
// PV pass reads V rows the same way. A head of width dh <= 256 runs in a
// template padded to DHP = 64, 128 or 256 lanes' worth of elements, the
// lanes past dh loading zeros (so q . k and p . v are unchanged); rows
// whose element offsets are not all multiples of 4 (dh % 4 != 0, or odd
// strides) take element-wise loads in the DHP = 256 template. A wider
// head (any width; shared memory bounds it) runs in the 256 templates in
// column slices of 256: the score pass adds each slice's partial dot to
// the row's score in slice order, and the block's slice (blockIdx.z, one
// block per slice) takes that slice of the PV pass and of the output.
// Each slice's block computes the same scores, softmax and rounded p (the
// same operations in the same order), reading K once per slice and V
// once. Splitting the sequence across blocks, with a combine pass that
// keeps the running max's rounding of p, is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;           // query heads a kv head
constexpr int kVec = 4;              // cache elements a lane loads at once
constexpr int kScoreBudget = 64 * 1024;  // shared bytes for a span's scores
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDh = 256;          // widest template (padded width of the
                                     // element-wise one), the width of a
                                     // wider head's column slices

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

// rows a lane has in flight: 128 bytes of f32, bf16 or f16, 64 of int8
template <typename T>
constexpr int kRowsInFlight = sizeof(T) == 4 ? 8 : 16;

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

struct Args {
  const float* q;        // (B, H, dh)
  const void* k;         // the full stacked cache, either layout
  const void* v;
  const float* ks;       // int8 scale planes, or null
  const float* vs;
  const float* slopes;   // (H,) ALiBi slopes, or null
  const int* n_past;     // (B,)
  float* out;            // (B, H, dh)
  int h, hkv, dh, win, chunk, span;  // span: chunks whose scores share memory at once
  int qw;                // q_s row: DH, or the slices' widths of a wider head
  int rep, ngrp;         // query heads a kv head; groups of kMaxRep of them
  float scale;
  long long k_l, k_b, k_s, k_h;  // cache: layer il's offset, slot, position, kv head strides
  long long s_l, s_b, s_s, s_h;  // scale planes, the same
};

// kRep: the query heads of a group, min(rep, 8) rounded up to 1, 2, 4 or 8
// (the heads past the group's own are skipped); DH: the head width a.dh
// padded to 64, 128 or 256, or a slice of 256 of a wider head (a.qw / DH
// slices, this block's blockIdx.z); kScalar: element-wise loads
template <typename T, int DH, int kRep, bool kScalar>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  // score pass: kTpr lanes a row, kNv vectors a lane, kRpw rows a warp
  constexpr int kTpr = DH / kVec < 32 ? DH / kVec : 32;
  constexpr int kNv = DH / (kVec * kTpr);
  constexpr int kRpw = 32 / kTpr;
  // PV pass: kVtpr threads a row, kVrows rows at once
  constexpr int kVtpr = DH / kVec;
  constexpr int kVrows = kThreads / kVtpr;
  static_assert(kNv * kVec * kTpr == DH && kVrows * kVtpr == kThreads, "tiling");
  // rows a lane loads before it uses them, in the score pass (at most 16
  // partial dots a lane) and the PV pass
  constexpr int kUnrollK =
      kRowsInFlight<T> / kNv < 16 / kRep ? kRowsInFlight<T> / kNv : 16 / kRep;
  constexpr int kUnrollV = kRowsInFlight<T>;

  extern __shared__ float smem[];
  __shared__ float m_run[kMaxRep], l_run[kMaxRep];
  // this block's kv head g and its group of rep query heads from head0
  const int g = blockIdx.x / a.ngrp, grp = blockIdx.x % a.ngrp, b = blockIdx.y;
  const int head0 = g * a.rep + grp * kMaxRep;
  const int rep = min(kMaxRep, a.rep - grp * kMaxRep);
  const int span_len = a.span * a.chunk;
  const int nsl = a.qw / DH, d0 = blockIdx.z * DH;  // slices; this block's first column
  float* q_s = smem;                  // rep x qw: q * scale rounded to cdt
  float* sc = q_s + rep * a.qw;       // rep x span_len: scores, then p * vs rounded
  float* red = sc + rep * span_len;   // kThreads * kVec: the final sum over PV rows
  float* cmax = red + kThreads * kVec;  // rep x span: each chunk's max score
  float* msafe = cmax + rep * a.span;   // rep x span: running max (0 where -inf)
  float* alpha = msafe + rep * a.span;  // rep x span: rescale of the chunks before
  float* psum = alpha + rep * a.span;   // rep x span: each chunk's sum of p
  float* vsc = psum + rep * a.span;     // int8: span_len V scales, loaded beside K

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
  if (tid < kMaxRep) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  const int np = a.n_past[b];
  const int n_chunks = min(a.win / a.chunk, np / a.chunk + 1);
  const int ksub = lane % kTpr, krow = warp * kRpw + lane / kTpr;
  const int vsub = tid % kVtpr, vrow = tid / kVtpr;
  float acc[kRep][kVec];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }

  for (int c0 = 0; c0 < n_chunks; c0 += a.span) {
    const int nch = min(a.span, n_chunks - c0);
    const int s0 = c0 * a.chunk, rows = nch * a.chunk;
    __syncthreads();  // q_s written; the previous span's sc read

    // 1. the span's scores, slice by slice (one slice up to width 256)
    for (int base = 0; base < rows; base += kWarps * kRpw * kUnrollK) {
      float ksr[kUnrollK], vsr[kUnrollK];  // int8: the rows' scales, loaded with them
      float dot[kUnrollK][kRep];           // the rows' scores: the slices' sums in order
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
          if constexpr (kQuant) {
            if (sl == 0) {
              const long long so = static_cast<long long>(s0 + row) * a.s_s;
              ksr[u] = row < rows ? ksb[so] : 0.f;
              vsr[u] = row < rows ? vsb[so] : 0.f;
            }
          }
        }
        // the rows' partial dots, then their sums over the kTpr lanes of a
        // row, every row's shuffles interleaved
        float part[kUnrollK][kRep];
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
#pragma unroll
          for (int r = 0; r < kRep; ++r) {
            part[u][r] = 0.f;
            if (r < rep) {
#pragma unroll
              for (int n = 0; n < kNv; ++n) {
                const float* qq = q_s + r * a.qw + sl * DH + (n * kTpr + ksub) * kVec;
                const Vec4 kv = widen<T>(kr[u][n]);
#pragma unroll
                for (int e = 0; e < kVec; ++e) part[u][r] = fmaf(qq[e], kv.x[e], part[u][r]);
              }
            }
          }
        }
#pragma unroll
        for (int o = kTpr / 2; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < kUnrollK; ++u) {
#pragma unroll
            for (int r = 0; r < kRep; ++r) {
              part[u][r] += __shfl_xor_sync(0xffffffffu, part[u][r], o);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnrollK; ++u) {
#pragma unroll
          for (int r = 0; r < kRep; ++r) dot[u][r] = sl == 0 ? part[u][r] : dot[u][r] + part[u][r];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollK; ++u) {
        const int row = base + u * kWarps * kRpw + krow;
        if (ksub == 0 && row < rows) {
          const int s = s0 + row;
          if constexpr (kQuant) vsc[row] = vsr[u];
#pragma unroll
          for (int r = 0; r < kRep; ++r) {
            if (r < rep) {
              float x = dot[u][r];
              if constexpr (kQuant) x = __fmul_rn(x, ksr[u]);
              if (a.slopes) x = __fadd_rn(x, __fmul_rn(a.slopes[head0 + r], static_cast<float>(s)));
              sc[r * span_len + row] = s <= np ? x : -INFINITY;
            }
          }
        }
      }
    }
    __syncthreads();

    // 2. each chunk's max, one warp a (head, chunk)
    for (int pr = warp; pr < rep * nch; pr += kWarps) {
      const int r = pr / nch, j = pr % nch;
      const float* row = sc + r * span_len + j * a.chunk;
      float mx = -INFINITY;
      for (int i = lane; i < a.chunk; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) cmax[r * a.span + j] = mx;
    }
    __syncthreads();
    // the running max through the chunks, in order
    if (tid < rep) {
      float m = m_run[tid];
      for (int j = 0; j < nch; ++j) {
        const float m_new = fmaxf(m, cmax[tid * a.span + j]);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        alpha[tid * a.span + j] = isfinite(m) ? expf(m - m_safe) : 0.f;
        msafe[tid * a.span + j] = m_safe;
        m = m_new;
      }
      m_run[tid] = m;
    }
    __syncthreads();
    // p, its sum, and p * vs rounded to cdt in place of the score
    for (int pr = warp; pr < rep * nch; pr += kWarps) {
      const int r = pr / nch, j = pr % nch;
      float* row = sc + r * span_len + j * a.chunk;
      const float m_safe = msafe[r * a.span + j];
      float sum = 0.f;
      for (int i = lane; i < a.chunk; i += 32) {
        const float p = expf(row[i] - m_safe);
        sum += p;
        const float pv =
            kQuant ? __fmul_rn(p, vsc[j * a.chunk + i]) : p;
        row[i] = to_cdt<T>(pv);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) psum[r * a.span + j] = sum;
    }
    __syncthreads();
    if (tid < rep) {
      float l = l_run[tid];
      for (int j = 0; j < nch; ++j) {
        l = __fadd_rn(__fmul_rn(l, alpha[tid * a.span + j]), psum[tid * a.span + j]);
      }
      l_run[tid] = l;
    }

    // 3. acc = acc * alpha + p . v, chunk by chunk
    for (int j = 0; j < nch; ++j) {
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        if (r < rep) {
          const float al = alpha[r * a.span + j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[r][e] *= al;
        }
      }
      const int r0 = j * a.chunk;
      for (int base = vrow; base < a.chunk; base += kVrows * kUnrollV) {
        typename Raw<T>::type vr[kUnrollV];
#pragma unroll
        for (int u = 0; u < kUnrollV; ++u) {
          const int row = base + u * kVrows;
          vr[u] = load_part<T, kScalar>(
              vb + static_cast<long long>(s0 + r0 + row) * a.k_s + vsub * kVec,
              row < a.chunk ? a.dh - d0 - vsub * kVec : 0);
        }
#pragma unroll
        for (int u = 0; u < kUnrollV; ++u) {
          const int row = base + u * kVrows;
          if (row < a.chunk) {
            const Vec4 vv = widen<T>(vr[u]);
#pragma unroll
            for (int r = 0; r < kRep; ++r) {
              if (r < rep) {
                const float p = sc[r * span_len + r0 + row];
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vv.x[e], acc[r][e]);
              }
            }
          }
        }
      }
    }
  }

  // the PV rows' partial sums, head by head, divided by l
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[tid * kVec + e] = acc[r][e];
      __syncthreads();
      for (int d = tid; d < min(DH, a.dh - d0); d += kThreads) {
        float s = 0.f;
        for (int gi = 0; gi < kVrows; ++gi) s += red[gi * DH + d];
        a.out[(static_cast<long long>(b) * a.h + head0 + r) * a.dh + d0 + d] =
            __fdiv_rn(s, fmaxf(l_run[r], 1e-30f));
      }
      __syncthreads();
    }
  }
}

template <typename T, int DH, int kRep, bool kScalar>
cudaError_t launch(const Args& a, int batch, size_t smem, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, DH, kRep, kScalar>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.hkv * a.ngrp, batch, a.qw / DH), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DH, bool kScalar>
cudaError_t by_rep(const Args& a, int batch, size_t smem, cudaStream_t st) {
  const int rep = std::min(a.rep, kMaxRep);
  if (rep == 1) return launch<T, DH, 1, kScalar>(a, batch, smem, st);
  if (rep == 2) return launch<T, DH, 2, kScalar>(a, batch, smem, st);
  if (rep <= 4) return launch<T, DH, 4, kScalar>(a, batch, smem, st);
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
  const int rep = h / hkv;
  const int grp_rep = std::min(rep, kMaxRep);  // query heads of a block
  const long long chunk_bytes = 4LL * grp_rep * chunk;
  const int span = static_cast<int>(
      std::min(static_cast<long long>(win / chunk), std::max(1LL, kScoreBudget / chunk_bytes)));
  // vector loads need every row's elements at multiples of kVec (the cache
  // pointer itself is 16-byte aligned)
  const bool scalar = dh % kVec || k_sl % kVec || k_sb % kVec || k_ss % kVec || k_sh % kVec;
  // q_s's row: the padded template width, or 256 a slice of a wider head
  const int qw = dh > kMaxDh ? (dh + kMaxDh - 1) / kMaxDh * kMaxDh
                             : scalar ? kMaxDh : dh <= 64 ? 64 : dh <= 128 ? 128 : kMaxDh;
  const size_t smem =
      4 * (static_cast<size_t>(grp_rep) * qw +
           static_cast<size_t>(grp_rep) * span * chunk + kThreads * kVec +
           4 * static_cast<size_t>(grp_rep) * span +
           (quant ? static_cast<size_t>(span) * chunk : 0));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), k, v, static_cast<const float*>(ks),
         static_cast<const float*>(vs), static_cast<const float*>(slopes),
         static_cast<const int*>(n_past), static_cast<float*>(out), h, hkv, dh, win, chunk,
         span, qw, rep, (rep + kMaxRep - 1) / kMaxRep, scale, il * k_sl, k_sb, k_ss, k_sh,
         il * s_sl, s_sb, s_ss, s_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return by_head_dim<float>(a, scalar, batch, smem, st);
    case kBF16: return by_head_dim<__nv_bfloat16>(a, scalar, batch, smem, st);
    case kF16: return by_head_dim<__half>(a, scalar, batch, smem, st);
    case kI8: return by_head_dim<int8_t>(a, scalar, batch, smem, st);
    default: return cudaErrorInvalidValue;
  }
}
