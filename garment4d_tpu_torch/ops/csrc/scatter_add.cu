// Deterministic row scatter-add, the backward of every row gather:
//   out[b, i, :] = sum over r with idx[b, r] == i of g[b, r, :],
// each output row summed in ascending r from 0.0, so the result is bitwise
// the sequential sum (the CPU's `index_add_`) on every run. An index
// outside [0, n) is dropped; with `wrap` (the row gather's backward, the
// JAX package's rule) an index in [-n, 0) adds into row idx + n first, in
// the sort's index test, at no memory traffic.
//
// Replaces garment4d_tpu/ops/pallas/scatter.py:scatter_add_rows_pallas
// (pallas_call at :102). The TPU kernel built a one-hot matrix per 128-row
// group and summed on the MXU (with a three-way bf16 split of the payload),
// because XLA's TPU scatter was a serial loop; none of that carries over.
//
// What bounds it on the H100: device-memory bytes, one read of the payload
// g and one write of out. Float atomics would add in an order that changes
// from run to run, so the kernel sorts instead, in two launches:
//
// 1. A stable counting sort of each frame's indices (one block per frame,
//    kWarps warps). Warp w owns the w-th contiguous range of r. Pass 1
//    counts, per warp, how often each output row occurs in its range
//    (`__match_any_sync` groups equal indices of 32 consecutive r, the
//    group's lowest lane adds the group's size) into hist[i][w]; an
//    exclusive scan of hist in (i, w) order gives each (row, warp) its first
//    slot and start[b, i]; pass 2 repeats the walk and places each r at its
//    group's cursor plus its rank in the group. Slots of a row are thus in
//    ascending r. Integer counts do not depend on order, so the sort is
//    exact. hist lives in shared memory when n * kWarps ints fit, else in
//    scratch that the wrapper allocates.
// 2. A segmented sum: a group of `lanes` lanes (a whole warp for C > 64)
//    owns one output row, walks its slots in ascending order and adds the
//    payload rows from 0.0, the lanes over channels (float4 loads where C
//    and the pointer allow, 4-byte coalesced loads else). The payload reads
//    of kAhead slots are issued before their adds, which still run in
//    order; the next slots' indices are loaded while these are added. Every
//    output row is written once, zeros for a row without hits.
//
// The payload is read once and out written once; the sort adds a read of
// the indices per pass and the order (B, R) and start (B, n + 1) arrays,
// under 2% of the bytes at the canonical train step's shapes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;  // warps of a sort block, each owning a range of r
constexpr int kAhead = 8;   // slots whose payload reads are in flight together
constexpr int kLoads = 8;   // rounds of 32 indices a sort warp loads ahead

// index r of a frame's indices ix, hi its range's end: -1 (dropped) past
// hi, an index in [-n, 0) wrapped to idx + n with `wrap`
__device__ __forceinline__ int sort_index(const int* ix, int r, int hi, int n, bool wrap) {
  if (r >= hi) return -1;
  const int i = __ldg(ix + r);
  return wrap && i < 0 ? i + n : i;
}

// per-frame stable counting sort of idx (B, R) by value into order (B, R),
// start (B, n + 1); hist: n * kWarps ints, shared (null) or scratch
__global__ void __launch_bounds__(kWarps * 32)
scatter_sort_kernel(const int* __restrict__ idx, int R, int n, bool wrap,
                    int* __restrict__ hist_scratch, int* __restrict__ order,
                    int* __restrict__ start) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int L = n * kWarps;
  int* hist = hist_scratch ? hist_scratch + (size_t)b * L : smem;
  for (int e = tid; e < L; e += kWarps * 32) hist[e] = 0;
  __syncthreads();

  const int* ix = idx + (size_t)b * R;
  const int span = (R + kWarps * 32 - 1) / (kWarps * 32) * 32;  // r per warp
  const int lo = warp * span, hi = min(R, lo + span);
  const unsigned below = (1u << lane) - 1;
  // pass 1: per (row, warp) counts, kLoads rounds of 32 indices loaded
  // before they are counted
  for (int r0 = lo; r0 < hi; r0 += 32 * kLoads) {  // warp-uniform
    int iv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) iv[u] = sort_index(ix, r0 + u * 32 + lane, hi, n, wrap);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = iv[u];
      const bool ok = (unsigned)i < (unsigned)n;
      const unsigned peers = __match_any_sync(0xffffffffu, ok ? i : -1);
      if (ok && (peers & below) == 0) hist[i * kWarps + warp] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // exclusive scan of hist: each thread a contiguous run (an odd length,
  // so that the runs start on different banks), then the runs' sums
  constexpr int kT = kWarps * 32;
  const int run = ((L + kT - 1) / kT) | 1;
  const int e0 = min(L, tid * run), e1 = min(L, e0 + run);
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += hist[e];
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int acc = (warp > 0 ? warp_sums[warp - 1] : 0) + x - sum;
  for (int e = e0; e < e1; ++e) {
    const int v = hist[e];
    hist[e] = acc;
    acc += v;
  }
  const int carry = warp_sums[kWarps - 1];
  __syncthreads();
  int* st = start + (size_t)b * (n + 1);
  for (int i = tid; i < n; i += kWarps * 32) st[i] = hist[i * kWarps];
  if (tid == 0) st[n] = carry;
  __syncthreads();

  // pass 2: place each r at its (row, warp) cursor plus its rank
  int* ord = order + (size_t)b * R;
  for (int r0 = lo; r0 < hi; r0 += 32 * kLoads) {
    int iv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) iv[u] = sort_index(ix, r0 + u * 32 + lane, hi, n, wrap);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = iv[u];
      const bool ok = (unsigned)i < (unsigned)n;
      const unsigned peers = __match_any_sync(0xffffffffu, ok ? i : -1);
      const int leader = __ffs(peers) - 1;
      int slot = 0;
      if (ok && lane == leader) {
        slot = hist[i * kWarps + warp];
        hist[i * kWarps + warp] = slot + __popc(peers);
      }
      slot = __shfl_sync(0xffffffffu, slot, leader);
      if (ok) ord[slot + __popc(peers & below)] = r0 + u * 32 + lane;
      __syncwarp();
    }
  }
}

// out rows summed from the sorted slots; V floats per load (1 or 4), J
// loads per lane per chunk of lanes * J * V channels
template <int V, int J>
__global__ void __launch_bounds__(256)
segment_sum_kernel(const float* __restrict__ g, const int* __restrict__ order,
                   const int* __restrict__ start, int B, int R, int C, int n,
                   int lanes, float* __restrict__ out) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int lane = threadIdx.x % lanes;
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  if (row >= (long long)B * n) return;  // whole groups leave together
  const int b = (int)(row / n);
  const int i = (int)(row - (long long)b * n);
  const int* st = start + (size_t)b * (n + 1);
  const int p0 = __ldg(st + i), p1 = __ldg(st + i + 1);
  const int* ord = order + (size_t)b * R;
  const Vec* gb = reinterpret_cast<const Vec*>(g + (size_t)b * R * C);
  Vec* dst = reinterpret_cast<Vec*>(out + ((size_t)b * n + i) * C);
  const int CV = C / V;  // vectors per row
  for (int v0 = 0; v0 < CV; v0 += lanes * J) {
    float acc[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
    int nxt[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) nxt[u] = p0 + u < p1 ? __ldg(ord + p0 + u) : 0;
    for (int p = p0; p < p1; p += kAhead) {
      int rr[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) rr[u] = nxt[u];
      Vec x[kAhead][J];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int v = v0 + lane + j * lanes;
          if (p + u < p1 && v < CV) x[u][j] = __ldg(gb + (size_t)rr[u] * CV + v);
        }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        nxt[u] = p + kAhead + u < p1 ? __ldg(ord + p + kAhead + u) : 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (p + u < p1) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float* xs = reinterpret_cast<const float*>(&x[u][j]);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[j][k] = acc[j][k] + xs[k];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int v = v0 + lane + j * lanes;
      if (v < CV) {
        Vec o;
        float* os = reinterpret_cast<float*>(&o);
#pragma unroll
        for (int k = 0; k < V; ++k) os[k] = acc[j][k];
        dst[v] = o;
      }
    }
  }
}

template <int V, int J>
cudaError_t launch_sum(const float* g, const int* order, const int* start, int B,
                       int R, int C, int n, int lanes, float* out,
                       cudaStream_t stream) {
  const long long threads = (long long)B * n * lanes;
  segment_sum_kernel<V, J><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      g, order, start, B, R, C, n, lanes, out);
  return cudaGetLastError();
}

}  // namespace

// g (B, R, C) f32, idx (B, R) i32 -> out (B, n, C) f32; `wrap` != 0: an
// index in [-n, 0) counts as idx + n. Scratch: order
// (B, R) i32, start (B, n + 1) i32, and hist (B, n * 16) i32 or null to
// keep the counts in shared memory (n * 64 bytes, at most the card's 227
// KB less 1 KB). The sum: V = 4 (C % 4 == 0, g and out 16-byte aligned) or 1, J in
// {1, 2} (V = 4) or {1, 2, 4, 8} (V = 1), `lanes` in {1, 2, ..., 32} per
// output row. The wrapper's `_scatter_plan` picks them.
extern "C" int g4d_scatter_add(const float* g, const int* idx, int B, int R,
                               int C, int n, int wrap, int V, int J, int lanes,
                               int* order, int* start, int* hist, float* out,
                               cudaStream_t stream) {
  if (B < 0 || R < 0 || C < 0 || C > 1024 || n < 0 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || (V != 1 && V != 4) || C % V ||
      (hist == nullptr && (size_t)n * kWarps * 4 > 232448 - 1024))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const size_t smem = hist ? 0 : (size_t)n * kWarps * 4;
  cudaError_t err = cudaFuncSetAttribute(
      scatter_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scatter_sort_kernel<<<B, kWarps * 32, smem, stream>>>(idx, R, n, wrap != 0, hist, order,
                                                        start);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 0) return (int)err;
  if (V == 4) {
    if (J == 1) return (int)launch_sum<4, 1>(g, order, start, B, R, C, n, lanes, out, stream);
    if (J == 2) return (int)launch_sum<4, 2>(g, order, start, B, R, C, n, lanes, out, stream);
  } else {
    if (J == 1) return (int)launch_sum<1, 1>(g, order, start, B, R, C, n, lanes, out, stream);
    if (J == 2) return (int)launch_sum<1, 2>(g, order, start, B, R, C, n, lanes, out, stream);
    if (J == 4) return (int)launch_sum<1, 4>(g, order, start, B, R, C, n, lanes, out, stream);
    if (J == 8) return (int)launch_sum<1, 8>(g, order, start, B, R, C, n, lanes, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
