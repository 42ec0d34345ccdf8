// Multi-radius ball query: for each center and radius, the first nsample
// in-radius point indices in index order.
//
// Replaces garment4d_tpu/ops/pallas/ball_query.py:ball_query_multi_pallas on
// its flat path (pallas_call at :528, body _bq_kernel at :126),
// ball_query_pallas (:547), and _ball_query_multi_grouped (pallas_call at
// :456, body _bq_grouped_kernel at :184), the query over a compacted table
// padded with far sentinels whose per-frame valid count bounds the scan.
// Semantics (reference CUDA ball_query_gpu.cu): membership is d^2 < r^2 in
// diff form; slots past the hit count copy the first hit; a center with no
// hit keeps index 0 in every slot.
//
// What bounds it on the H100: the distance scan, up to N distance tests per
// center, which is FP32-issue bound for sparse centers and ends early for
// dense ones. The TPU kernels scanned all points (the grouped one skipped
// 512-point groups that could hold no needed hit) and extracted slots with
// prefix sums, because the vector unit cannot stop per center.
//
// Flat query: one thread owns one center, scans points in index order from
// a shared-memory tile that its block stages once (one float4 per point:
// one shared load per distance), writes a hit the moment it finds it, and
// stops when every radius has its quota; a block stops loading tiles when
// all of its centers are done. The scan loop only breaks and `done` is set
// after it: setting a flag on the way out gave the loop two exit branches
// per point. One distance pass serves up to two radii.
//
// Grouped query: one warp owns one center, so a center that scans far (a
// sparse one, near the garment's hem) holds up no other. Each step tests
// 128 consecutive rows, four per lane; per radius still short of its quota
// one vote says whether any of them hits, and only then do a ballot per 32
// rows and the popcount of the lower lanes place each hit at its slot in
// index order (most steps of a sparse center hit nothing). The warp leaves
// when every radius is full: a scan is its own center's length, rounded up
// to 128 rows. A block stages its frame's valid prefix (rows [0,
// n_valid[b]), read on the device) in shared memory once, as float4s padded
// to whole steps with far rows, and its warps take the frame's centers from
// a block counter; rows past the staged capacity are read through L1. One
// distance pass serves up to three radii.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kMaxRadii = 3;
constexpr int kRows = 4;            // grouped query: rows a lane tests per step
constexpr int kStep = 32 * kRows;   // rows a warp tests per step
constexpr int kGroupedThreads = 512;  // 16 warps, two blocks resident per SM

struct Queries {
  float r2[kMaxRadii];   // f32 r^2 per radius
  int nsample[kMaxRadii];
  int* out[kMaxRadii];   // (B, M, nsample) each
  int n;                 // radii in use
};

// R = q.n radii, a compile-time count so the per-point radius loop unrolls
// with no run-time test
template <int R>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ centers, int N, int M, Queries q) {
  __shared__ float4 tp[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = m < M;
  const float* p = xyz + (size_t)b * N * 3;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  int* o[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    o[r] = live ? q.out[r] + ((size_t)b * M + m) * q.nsample[r] : nullptr;
    cnt[r] = 0;
  }
  if (live) {
    const float* c = centers + ((size_t)b * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  bool done = !live;
  for (int base = 0; base < N; base += kTile) {
    // barrier: every thread is done with the previous tile before reload
    if (__syncthreads_and(done)) break;
    const int n = min(kTile, N - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      tp[i] = make_float4(p[3 * (base + i)], p[3 * (base + i) + 1],
                          p[3 * (base + i) + 2], 0.f);
    __syncthreads();
    if (!done) {
      for (int i = 0; i < n; ++i) {
        const float4 t = tp[i];
        const float d = g4d_sqdist(cx - t.x, cy - t.y, cz - t.z);
        bool full = true;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (d < q.r2[r] && cnt[r] < q.nsample[r]) o[r][cnt[r]++] = base + i;
          full = full && cnt[r] >= q.nsample[r];
        }
        if (full) break;
      }
      done = true;
#pragma unroll
      for (int r = 0; r < R; ++r) done = done && cnt[r] >= q.nsample[r];
    }
  }
  if (!live) return;
  // tail slots copy the first hit; no hit leaves every slot at 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int first = cnt[r] > 0 ? o[r][0] : 0;
    for (int s = cnt[r]; s < q.nsample[r]; ++s) o[r][s] = first;
  }
}

template <int R>
__global__ void __launch_bounds__(kGroupedThreads, 2)
ball_query_grouped_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                          const int* __restrict__ n_valid, int N, int M, int rows,
                          Queries q) {
  extern __shared__ float4 tp[];  // rows [0, n_pad): the frame's rows, far past n_scan
  __shared__ int next;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int n_scan = max(0, min(n_valid[b], N));
  const int n_pad = min(rows, (n_scan + kStep - 1) / kStep * kStep);
  const float* p = xyz + (size_t)b * N * 3;
  const float far = __int_as_float(0x7f800000);  // +inf: never within a radius
  if (threadIdx.x == 0) next = 0;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x)
    tp[i] = i < n_scan ? make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f)
                       : make_float4(far, far, far, 0.f);
  __syncthreads();

  // the block's centers are blockIdx.x + gridDim.x * j, j from the counter
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&next, 1);
    const int m = blockIdx.x + gridDim.x * __shfl_sync(kFull, j, 0);
    if (m >= M) break;
    const float* c = centers + ((size_t)b * M + m) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    int* o[R];
    int cnt[R], first[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o[r] = q.out[r] + ((size_t)b * M + m) * q.nsample[r];
      cnt[r] = 0;
      first[r] = 0;
    }
    // steps of kStep rows, kRows a lane (row base + 32 i + lane); a radius
    // still short of its quota votes whether any of them hits, and only
    // then places its hits, 32 rows at a time in index order
    for (int base = 0; base < n_scan; base += kStep) {
      float d[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int n = base + 32 * i + lane;
        float4 t;
        if (base + kStep <= n_pad) {
          t = tp[n];
        } else if (n < n_scan) {  // past the staged rows (a table larger than the plan's)
          t = make_float4(__ldg(p + 3 * n), __ldg(p + 3 * n + 1), __ldg(p + 3 * n + 2), 0.f);
        } else {
          t = make_float4(far, far, far, 0.f);
        }
        d[i] = g4d_sqdist(cx - t.x, cy - t.y, cz - t.z);
      }
      bool changed = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cnt[r] >= q.nsample[r]) continue;  // warp-uniform
        bool any = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i) any = any || d[i] < q.r2[r];
        if (!__any_sync(kFull, any)) continue;
        changed = true;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const bool hit = d[i] < q.r2[r];
          const unsigned hits = __ballot_sync(kFull, hit);
          if (cnt[r] == 0 && hits) first[r] = base + 32 * i + __ffs(hits) - 1;
          const int slot = cnt[r] + __popc(hits & lower);
          if (hit && slot < q.nsample[r]) o[r][slot] = base + 32 * i + lane;
          cnt[r] += __popc(hits);
        }
      }
      if (changed) {
        bool full = true;
#pragma unroll
        for (int r = 0; r < R; ++r) full = full && cnt[r] >= q.nsample[r];
        if (full) break;
      }
    }
    // tail slots copy the first hit; no hit leaves every slot at 0
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int s = cnt[r] + lane; s < q.nsample[r]; s += 32) o[r][s] = first[r];
  }
}

}  // namespace

// Flat query. xyz (B, N, 3), centers (B, M, 3) f32 -> outa (B, M, sa),
// outb (B, M, sb) i32. sb == 0 (outb unused) runs a single radius.
// r2a/r2b are f32 r^2.
extern "C" int g4d_ball_query(const float* xyz, const float* centers, int B,
                              int N, int M, float r2a, int sa, int* outa,
                              float r2b, int sb, int* outb,
                              cudaStream_t stream) {
  if (B == 0 || M == 0) return (int)cudaSuccess;
  Queries q = {{r2a, r2b, 0.f}, {sa, sb, 0}, {outa, outb, nullptr}, sb > 0 ? 2 : 1};
  dim3 grid(g4d_blocks(M, kThreads), B);
  if (q.n == 2)
    ball_query_kernel<2><<<grid, kThreads, 0, stream>>>(xyz, centers, N, M, q);
  else
    ball_query_kernel<1><<<grid, kThreads, 0, stream>>>(xyz, centers, N, M, q);
  return (int)cudaGetLastError();
}

// Grouped query over a compacted table. xyz (B, N, 3), centers (B, M, 3)
// f32, n_valid (B,) i32 on the device: frame b scans rows [0, n_valid[b]).
// R in 1..3 radii; out_i (B, M, s_i) i32 for i < R (the rest unused). The
// launch plan (ops/pointcloud.py:_grouped_plan): `blocks` per frame of
// `warps` warps, `rows` staged rows (a multiple of 128), 16 * rows bytes of
// shared memory.
extern "C" int g4d_ball_query_grouped(const float* xyz, const float* centers,
                                      const int* n_valid, int B, int N, int M,
                                      int R, float r2_0, int s_0, int* out_0,
                                      float r2_1, int s_1, int* out_1,
                                      float r2_2, int s_2, int* out_2,
                                      int blocks, int warps, int rows,
                                      cudaStream_t stream) {
  if (R < 1 || R > kMaxRadii || blocks < 1 || warps < 1 || warps * 32 > kGroupedThreads ||
      rows < 0 ||
      rows % kStep)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  Queries q = {{r2_0, r2_1, r2_2}, {s_0, s_1, s_2}, {out_0, out_1, out_2}, R};
  void (*kernel)(const float*, const float*, const int*, int, int, int, Queries) =
      R == 1 ? ball_query_grouped_kernel<1>
             : R == 2 ? ball_query_grouped_kernel<2> : ball_query_grouped_kernel<3>;
  const int smem = rows * (int)sizeof(float4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, B), warps * 32, smem, stream>>>(xyz, centers, n_valid, N, M, rows, q);
  return (int)cudaGetLastError();
}
