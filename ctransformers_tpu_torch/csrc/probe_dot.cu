// Dot-product probes: one template over the operand pair, each pair on the
// card's own unit for it, and the per-group rescale epilogue.
//
// Replaces the Pallas kernels of scripts/probe_int8_dot.py (its kernels at
// :49, :58, :67, :80, :91, :107, :116, launched through :29; the epilogue
// :133), scripts/probe_bf16_dot.py (kA-kF, :34-:125, launched at :41, :55,
// :70, :88, :113, :127) and the int16 dots of scripts/probe_q5.py (k_i16i8
// :104, launched through :86). Each asked the TPU whether an operand pair
// lowers and what it costs; on Hopper every pair has a unit:
//
//   op 0  s8 x s8 -> s32 (or its f32 conversion): tensor cores, wmma
//         m16n16k16 on signed char, exact int32 sums.
//   op 1  bf16 x bf16 -> f32: tensor cores, wmma m16n16k16 on bf16 with f32
//         accumulators. Operands given as bf16 are used as they are; int8
//         and f32 operands are rounded to bf16 (round to nearest even) as a
//         block stages them, after the rhs transform of probe_bf16_dot.py:
//         the floor chain (kC: f = floor(w / 16), l = w - 16 f, l + f) and
//         2 w on every step after the first (kE), each an f32 operation
//         rounded once (no contraction into an FMA). `steps` partial dots,
//         step s over x columns [s * x_step, + k_step) and w rows
//         [s * w_step, + k_step), each summed in its own accumulators and
//         added in step order (kB's halves, kD's grid steps, kE's two dots).
//   op 2  f32 x f32 or f32 x s8 (cast in the kernel) -> f32, batched over a
//         leading axis: CUDA-core FFMA, since TF32 would round x and the
//         Pallas function keeps it whole.
//   op 3  s16 x s8 -> s32 through __dp2a_lo / __dp2a_hi (two s16 against
//         four s8 a word), and s16 x s16 -> s32 through IMAD. Neither
//         lowered on the TPU (probe_q5.py:121).
//
// M (8 or 16 in the probes) is padded to the fragments' 16 rows inside the
// block. Bound: at these shapes (M <= 16, K <= 2048) every operand byte is
// used for at most 32 operations, far below the card's ridge, so bytes and,
// for the small ones, the launch set the time. Design (simple first): a
// block of four warps owns 16 x 64 outputs, one 16 x 16 fragment a warp, and
// walks K sixteen rows at a time through shared memory (each warp's B
// fragment in its own 16 x 16 array, 32-byte aligned as wmma needs); the
// CUDA-core ops take one output a thread, K in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

// dtype codes shared with ops/probes.py
enum { kI8 = 0, kI16 = 1, kBF16 = 2, kF32 = 3, kI32 = 4 };
enum { kFloor = 1, kTwice = 2 };

constexpr int kBM = 16, kBN = 64, kBK = 16, kWarps = kBN / 16, kTC = 32 * kWarps;

__device__ __forceinline__ float load_f(const void* p, size_t i, int t) {
  switch (t) {
    case kI8: return static_cast<float>(static_cast<const int8_t*>(p)[i]);
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

// the rhs of op 1 as probe_bf16_dot.py forms it, in f32, before the bf16 cast
__device__ __forceinline__ float rhs_value(float w, int flags, int step) {
  if (flags & kFloor) {
    const float f = floorf(__fmul_rn(w, 0.0625f));
    const float l = __fsub_rn(w, __fmul_rn(f, 16.0f));
    w = __fadd_rn(l, f);
  }
  if ((flags & kTwice) && step > 0) w = __fmul_rn(w, 2.0f);
  return w;
}

template <bool S8>
__global__ void __launch_bounds__(kTC)
probe_mma_kernel(const void* __restrict__ x, const void* __restrict__ w, void* __restrict__ out,
                 int xt, int wt, int ot, int m, int n, int kx, int k_step, int steps, int x_step,
                 int w_step, int flags) {
  using namespace nvcuda;
  using T = typename std::conditional<S8, signed char, __nv_bfloat16>::type;
  using Acc = typename std::conditional<S8, int, float>::type;
  __shared__ __align__(32) T As[kBM * kBK];
  __shared__ __align__(32) T Bs[kWarps][kBK * 16];
  __shared__ __align__(32) Acc Cs[kWarps][kBM * 16];
  const int tid = threadIdx.x, warp = tid / 32;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> tot, part;
  wmma::fill_fragment(tot, static_cast<Acc>(0));
  const int ar = tid / 8, ac = (tid % 8) * 2;   // A: 2 of a row's 16 columns
  const int br = tid / 8, bc = (tid % 8) * 8;   // B: 8 of a row's 64 columns
  for (int s = 0; s < steps; ++s) {
    wmma::fill_fragment(part, static_cast<Acc>(0));
    const int xc = s * x_step, wr = s * w_step;
    for (int k0 = 0; k0 < k_step; k0 += kBK) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row0 + ar;
        const size_t xi = (size_t)r * kx + xc + k0 + ac + j;
        T v;
        if constexpr (S8) {
          v = r < m ? static_cast<const int8_t*>(x)[xi] : 0;
        } else {
          v = __float2bfloat16_rn(r < m ? load_f(x, xi, xt) : 0.0f);
        }
        As[ar * kBK + ac + j] = v;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = bc + j;
        const size_t wi = (size_t)(wr + k0 + br) * n + col0 + c;
        T v;
        if constexpr (S8) {
          v = static_cast<const int8_t*>(w)[wi];
        } else {
          v = __float2bfloat16_rn(rhs_value(load_f(w, wi, wt), flags, s));
        }
        Bs[c / 16][br * 16 + c % 16] = v;
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, As, kBK);
      wmma::load_matrix_sync(fb, Bs[warp], 16);
      wmma::mma_sync(part, fa, fb, part);
      __syncthreads();
    }
    // steps are summed in order, each from its own accumulators
#pragma unroll
    for (int t = 0; t < part.num_elements; ++t) {
      if constexpr (S8)
        tot.x[t] += part.x[t];
      else
        tot.x[t] = s == 0 ? part.x[t] : __fadd_rn(tot.x[t], part.x[t]);
    }
  }
  wmma::store_matrix_sync(Cs[warp], tot, 16, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kTC) {
    const int r = e / kBN, c = e % kBN;
    if (row0 + r >= m) continue;
    const Acc v = Cs[c / 16][r * 16 + c % 16];
    const size_t oi = (size_t)(row0 + r) * n + col0 + c;
    if (ot == kI32)
      static_cast<int*>(out)[oi] = static_cast<int>(v);
    else
      static_cast<float*>(out)[oi] = static_cast<float>(v);
  }
}

// op 2: out[b, i, j] = sum_k x[b, i, k] * float(w[b, k, j]), k in order.
template <int WT>
__global__ void probe_ffma_kernel(const float* __restrict__ x, const void* __restrict__ w,
                                  float* __restrict__ out, int batch, int m, int n, int k) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * m * n) return;
  const int j = idx % n, i = (idx / n) % m, b = idx / ((long long)m * n);
  const float* xr = x + ((size_t)b * m + i) * k;
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    const size_t wi = ((size_t)b * k + kk) * n + j;
    const float wv = WT == kI8 ? static_cast<float>(static_cast<const int8_t*>(w)[wi])
                               : static_cast<const float*>(w)[wi];
    acc = fmaf(xr[kk], wv, acc);
  }
  out[idx] = acc;
}

// op 3: out[i, j] = sum_k x[i, k] * w[k, j] in int32; s8 w through dp2a
// (four K rows of column j gathered into one word), s16 w through IMAD.
template <int WT>
__global__ void probe_s16_kernel(const int16_t* __restrict__ x, const void* __restrict__ w,
                                 int* __restrict__ out, int m, int n, int k) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  const int j = idx % n, i = idx / n;
  const int16_t* xr = x + (size_t)i * k;
  int acc = 0;
  if constexpr (WT == kI8) {
    const uint8_t* wb = static_cast<const uint8_t*>(w);
    for (int kk = 0; kk < k; kk += 4) {
      const uint32_t w4 = wb[(size_t)kk * n + j] | (uint32_t)wb[(size_t)(kk + 1) * n + j] << 8 |
                          (uint32_t)wb[(size_t)(kk + 2) * n + j] << 16 |
                          (uint32_t)wb[(size_t)(kk + 3) * n + j] << 24;
      const int x01 = *reinterpret_cast<const int*>(xr + kk);
      const int x23 = *reinterpret_cast<const int*>(xr + kk + 2);
      acc = __dp2a_lo(x01, static_cast<int>(w4), acc);
      acc = __dp2a_hi(x23, static_cast<int>(w4), acc);
    }
  } else {
    const int16_t* ws = static_cast<const int16_t*>(w);
    for (int kk = 0; kk < k; ++kk) acc += static_cast<int>(xr[kk]) * ws[(size_t)kk * n + j];
  }
  out[idx] = acc;
}

__global__ void probe_rescale_kernel(const float* __restrict__ parts, const float* __restrict__ s,
                                     float* __restrict__ out, int ng, int m, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  const int j = idx % n;
  float acc = 0.0f;
  for (int g = 0; g < ng; ++g)
    acc = __fadd_rn(acc, __fmul_rn(parts[((size_t)g * m) * n + idx], s[(size_t)g * n + j]));
  out[idx] = acc;
}

int blocks(long long count, int threads) { return static_cast<int>((count + threads - 1) / threads); }

}  // namespace

extern "C" {

// x (batch, m, kx), w (batch, kw, n), out (batch, m, n), dtypes by the codes
// above (op 0: s8, s8 -> i32 or f32; op 1: bf16 / f32, s8 / bf16 / f32 -> f32;
// op 2: f32, f32 / s8 -> f32; op 3: s16, s8 / s16 -> i32). Ops 0 and 1 take
// batch 1, n a multiple of 64 and k_step a multiple of 16; ops 2 and 3 one
// step over all of k (kx = kw = k_step; op 3 with s8 w a multiple of 4).
int ct_probe_dot(const void* x, const void* w, void* out, int op, int xt, int wt, int ot,
                 int batch, int m, int n, int kx, int kw, int k_step, int steps, int x_step,
                 int w_step, int flags, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || k_step < 1 || steps < 1 || batch < 1) return bad;
  if (op == 0 || op == 1) {
    if (batch != 1 || n % kBN || k_step % kBK || (steps - 1) * x_step + k_step > kx ||
        (steps - 1) * w_step + k_step > kw)
      return bad;
    dim3 grid(n / kBN, (m + kBM - 1) / kBM);
    if (op == 0) {
      if (xt != kI8 || wt != kI8 || (ot != kI32 && ot != kF32) || steps != 1 || flags) return bad;
      probe_mma_kernel<true><<<grid, kTC, 0, st>>>(x, w, out, xt, wt, ot, m, n, kx, k_step,
                                                   steps, x_step, w_step, flags);
    } else {
      if ((xt != kBF16 && xt != kF32) || (wt != kI8 && wt != kBF16 && wt != kF32) || ot != kF32)
        return bad;
      probe_mma_kernel<false><<<grid, kTC, 0, st>>>(x, w, out, xt, wt, ot, m, n, kx, k_step,
                                                    steps, x_step, w_step, flags);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (steps != 1 || flags || kx != k_step || kw != k_step) return bad;
  if (op == 2) {
    if (xt != kF32 || ot != kF32) return bad;
    const int nb = blocks((long long)batch * m * n, 256);
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    if (wt == kI8)
      probe_ffma_kernel<kI8><<<nb, 256, 0, st>>>(xf, w, of, batch, m, n, k_step);
    else if (wt == kF32)
      probe_ffma_kernel<kF32><<<nb, 256, 0, st>>>(xf, w, of, batch, m, n, k_step);
    else
      return bad;
    return static_cast<int>(cudaGetLastError());
  }
  if (op == 3) {
    if (xt != kI16 || ot != kI32 || batch != 1) return bad;
    const int nb = blocks((long long)m * n, 256);
    const int16_t* xs = static_cast<const int16_t*>(x);
    int* oi = static_cast<int*>(out);
    if (wt == kI8 && k_step % 4 == 0)
      probe_s16_kernel<kI8><<<nb, 256, 0, st>>>(xs, w, oi, m, n, k_step);
    else if (wt == kI16)
      probe_s16_kernel<kI16><<<nb, 256, 0, st>>>(xs, w, oi, m, n, k_step);
    else
      return bad;
    return static_cast<int>(cudaGetLastError());
  }
  return bad;
}

// parts (ng, m, n) f32, s (ng, n) f32 -> out (m, n) = sum_g parts * s, g in
// order (the epilogue of probe_int8_dot.py:133).
int ct_probe_rescale(const float* parts, const float* s, float* out, int ng, int m, int n,
                     void* stream) {
  if (ng < 1 || m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  probe_rescale_kernel<<<blocks((long long)m * n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      parts, s, out, ng, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
