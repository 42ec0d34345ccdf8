// Deterministic row scatter-add, the backward of every row gather:
//   out[b, i, :] = sum over r with idx[b, r] == i of g[b, r, :],
// each output row summed in ascending r from 0.0, so the result is bitwise
// the sequential sum (the CPU's `index_add_`) on every run. An index
// outside [0, n) is dropped.
//
// Replaces garment4d_tpu/ops/pallas/scatter.py:scatter_add_rows_pallas
// (pallas_call at :102). The TPU kernel built a one-hot matrix per 128-row
// group and summed on the MXU (with a three-way bf16 split of the payload),
// because XLA's TPU scatter was a serial loop; none of that carries over.
//
// What bounds it on the H100: device-memory bytes, one read of the payload
// g and one write of out (the index rows are re-read from L2). The design
// avoids float atomics, whose order changes from run to run: one block owns
// a tile of output rows of one batch row and keeps their sums in shared
// memory; every warp of the block scans the batch row's indices in
// ascending r, 32 at a time (the next 32 loaded while these are summed), and
// a ballot picks out the ones that fall in the tile. Each thread owns one
// channel of the tile, so it alone adds into it, in the order of the scan,
// and the warps never synchronise. A hit row's payload is one coalesced read
// per warp; the reads of up to kBatch hits are issued before their adds, so
// their latencies overlap, and the adds still run in ascending r.
#include "common.cuh"

namespace {

constexpr int kBatch = 8;  // hits whose payload reads are in flight together

__global__ void scatter_add_kernel(const float* __restrict__ g,
                                   const int* __restrict__ idx, int R, int C,
                                   int n, int tile_rows,
                                   float* __restrict__ out) {
  extern __shared__ float acc[];  // (tile_rows, C)
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, n - i0);
  const int lane = threadIdx.x % 32;
  const int c = threadIdx.x;  // this thread's channel
  const bool active = c < C;
  if (active)
    for (int i = 0; i < rows; ++i) acc[i * C + c] = 0.f;
  const int* ix = idx + (size_t)b * R;
  const float* gb = g + (size_t)b * R * C;
  // row of index r within the tile; out-of-range indices and other tiles'
  // rows come out >= rows as unsigned
  auto tile_row = [&](int r) {
    return r < R ? (unsigned)__ldg(ix + r) - (unsigned)i0 : 0xffffffffu;
  };
  unsigned next = tile_row(lane);
  for (int r0 = 0; r0 < R; r0 += 32) {
    const unsigned i = next;
    next = tile_row(r0 + 32 + lane);
    unsigned hits = __ballot_sync(0xffffffffu, i < (unsigned)rows);
    while (hits) {  // warp-uniform
      int at[kBatch], row[kBatch];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (hits) {
          at[u] = __ffs(hits) - 1;
          hits &= hits - 1;
          row[u] = __shfl_sync(0xffffffffu, (int)i, at[u]);
          cnt = u + 1;
        }
      }
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (u < cnt && active) v[u] = __ldg(gb + (size_t)(r0 + at[u]) * C + c);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (u < cnt && active) acc[row[u] * C + c] = acc[row[u] * C + c] + v[u];
    }
  }
  if (!active) return;
  float* dst = out + ((size_t)b * n + i0) * C;
  for (int i = 0; i < rows; ++i) dst[(size_t)i * C + c] = acc[i * C + c];
}

}  // namespace

// g (B, R, C) f32, idx (B, R) i32 -> out (B, n, C) f32, C <= 1024; tile_rows
// output rows per block, tile_rows * C * 4 bytes of shared memory (<= 48 KB).
extern "C" int g4d_scatter_add(const float* g, const int* idx, int B, int R,
                               int C, int n, int tile_rows, float* out,
                               cudaStream_t stream) {
  if (B < 0 || R < 0 || C < 0 || C > 1024 || n < 0 || tile_rows < 1 ||
      (size_t)tile_rows * C * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0 || n == 0) return (int)cudaSuccess;
  const int threads = (C + 31) / 32 * 32;
  const dim3 grid(g4d_blocks(n, tile_rows), B);
  scatter_add_kernel<<<grid, threads, (size_t)tile_rows * C * 4, stream>>>(
      g, idx, R, C, n, tile_rows, out);
  return (int)cudaGetLastError();
}
