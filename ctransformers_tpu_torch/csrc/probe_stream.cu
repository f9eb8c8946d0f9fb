// Read-stream probe: sums every byte of a tiled uint8 array, one tile (or
// one band of a tile's rows) a block, so that the tile pattern is the only
// thing that differs between runs.
//
// Replaces scripts/probe_dma.py's kernel (:63, called at :94): a Pallas
// grid that DMAs every tile of a (4096, 22528) uint8 array into VMEM and
// reduces every byte (read as int8) through ones-matrices into an (8, 128)
// f32 sum, over three layouts: strided column tiles of the row-major array,
// full-width row tiles, and the same bytes pre-tiled to (nn, K, tn) so that
// a column tile is contiguous.
//
// Here the layout is given by strides (ops/probes.py:stream_tiling): tile
// (ty, tx) starts at ty * ty_stride + tx * tx_stride, and holds `rows` rows
// of `cols` bytes, row_stride apart. bands > 1 splits each tile's rows into
// that many bands, one block each, so that a layout with few tiles can
// still fill the card; bands = 1 is one block a tile, the Pallas grid's
// step. Each block writes the exact int32 sum of its bytes (read as int8),
// out[(ty * ntx + tx) * bands + band]; the plain version sums the same
// bytes in float64.
//
// Bound: bytes. Every byte is read once and summed with one dp4a a word, so
// no load can be elided. Design: 256 threads a block, 16-byte loads, four
// in flight a thread, the block's linear index over its band walked in
// 16-byte units (neighbouring threads on neighbouring addresses within a
// row), a warp-shuffle and shared-memory reduction at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;

__device__ __forceinline__ int sum16(uint4 v) {
  // four signed bytes a word, each times 1
  int s = __dp4a(static_cast<int>(v.x), 0x01010101, 0);
  s = __dp4a(static_cast<int>(v.y), 0x01010101, s);
  s = __dp4a(static_cast<int>(v.z), 0x01010101, s);
  return __dp4a(static_cast<int>(v.w), 0x01010101, s);
}

__global__ void __launch_bounds__(kThreads)
probe_stream_kernel(const uint8_t* __restrict__ a, int* __restrict__ out, int ntx, int rows,
                    int cols, long long row_stride, long long ty_stride, long long tx_stride,
                    int bands) {
  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int ty = tile / ntx, tx = tile % ntx;
  const int r0 = static_cast<int>((long long)rows * band / bands);
  const int r1 = static_cast<int>((long long)rows * (band + 1) / bands);
  const int w16 = cols / 16;  // 16-byte units a row
  const long long units = (long long)(r1 - r0) * w16;
  const uint8_t* base = a + ty * ty_stride + tx * tx_stride + r0 * row_stride;

  int acc = 0;
  for (long long e0 = threadIdx.x; e0 < units; e0 += (long long)kThreads * kInFlight) {
    uint4 v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const long long e = e0 + (long long)j * kThreads;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (e < units) {
        const long long r = e / w16, c = e % w16;
        v[j] = __ldg(reinterpret_cast<const uint4*>(base + r * row_stride + c * 16));
      }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) acc += sum16(v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ int warp_sums[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    out[tile * bands + band] = s;
  }
}

}  // namespace

extern "C" {

// a: the array's first byte (16-byte aligned); out: int32 (nty * ntx * bands).
// cols, row_stride, ty_stride and tx_stride must be 16-byte multiples.
int ct_probe_stream(const uint8_t* a, int* out, int nty, int ntx, int rows, int cols,
                    long long row_stride, long long ty_stride, long long tx_stride, int bands,
                    void* stream) {
  if (nty < 1 || ntx < 1 || rows < bands || bands < 1 || bands > 65535 || cols % 16 ||
      row_stride % 16 || ty_stride % 16 || tx_stride % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nty * ntx, bands);
  probe_stream_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, ntx, rows, cols, row_stride, ty_stride, tx_stride, bands);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
