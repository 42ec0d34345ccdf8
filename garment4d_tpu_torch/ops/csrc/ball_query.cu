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
// prefix sums, because the vector unit cannot stop per center. Here one
// thread owns one center, scans points in index order from a shared-memory
// tile that its block stages once (one float4 per point: one shared load per
// distance), writes a hit the moment it finds it, and stops when every
// radius has its quota; a block stops loading tiles when all of its centers
// are done. The scan loop only breaks and `done` is set after it: setting a
// flag on the way out gave the loop two exit branches per point.
// One distance pass serves up to three radii. The grouped entry reads frame
// b's valid count from device memory and scans only that prefix: rows past
// it are never hits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr int kMaxRadii = 3;

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
                  const float* __restrict__ centers,
                  const int* __restrict__ n_valid, int N, int M, Queries q) {
  __shared__ float4 tp[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = m < M;
  const int n_scan = n_valid ? max(0, min(n_valid[b], N)) : N;
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
  for (int base = 0; base < n_scan; base += kTile) {
    // barrier: every thread is done with the previous tile before reload
    if (__syncthreads_and(done)) break;
    const int n = min(kTile, n_scan - base);
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

int launch(const float* xyz, const float* centers, const int* n_valid, int B,
           int N, int M, const Queries& q, cudaStream_t stream) {
  if (B == 0 || M == 0) return (int)cudaSuccess;
  dim3 grid(g4d_blocks(M, kThreads), B);
  switch (q.n) {
    case 1:
      ball_query_kernel<1><<<grid, kThreads, 0, stream>>>(xyz, centers, n_valid, N, M, q);
      break;
    case 2:
      ball_query_kernel<2><<<grid, kThreads, 0, stream>>>(xyz, centers, n_valid, N, M, q);
      break;
    case 3:
      ball_query_kernel<3><<<grid, kThreads, 0, stream>>>(xyz, centers, n_valid, N, M, q);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Flat query. xyz (B, N, 3), centers (B, M, 3) f32 -> outa (B, M, sa),
// outb (B, M, sb) i32. sb == 0 (outb unused) runs a single radius.
// r2a/r2b are f32 r^2.
extern "C" int g4d_ball_query(const float* xyz, const float* centers, int B,
                              int N, int M, float r2a, int sa, int* outa,
                              float r2b, int sb, int* outb,
                              cudaStream_t stream) {
  Queries q = {{r2a, r2b, 0.f}, {sa, sb, 0}, {outa, outb, nullptr}, sb > 0 ? 2 : 1};
  return launch(xyz, centers, nullptr, B, N, M, q, stream);
}

// Grouped query over a compacted table. xyz (B, N, 3), centers (B, M, 3)
// f32, n_valid (B,) i32 on the device: frame b scans rows [0, n_valid[b]).
// R in 1..3 radii; out_i (B, M, s_i) i32 for i < R (the rest unused).
extern "C" int g4d_ball_query_grouped(const float* xyz, const float* centers,
                                      const int* n_valid, int B, int N, int M,
                                      int R, float r2_0, int s_0, int* out_0,
                                      float r2_1, int s_1, int* out_1,
                                      float r2_2, int s_2, int* out_2,
                                      cudaStream_t stream) {
  if (R < 1 || R > kMaxRadii) return (int)cudaErrorInvalidValue;
  Queries q = {{r2_0, r2_1, r2_2}, {s_0, s_1, s_2}, {out_0, out_1, out_2}, R};
  return launch(xyz, centers, n_valid, B, N, M, q, stream);
}
