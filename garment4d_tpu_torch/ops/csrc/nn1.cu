// Nearest neighbour of each query point in a point set:
//   d2[b, m] = min_n |q[b, m] - p[b, n]|^2,  idx[b, m] = the lowest such n
// with distances in diff form through g4d_sqdist (no FMA contraction), so d2
// and idx are bitwise the plain version's (`ops/pointcloud.py:_nn1_plain`)
// and, in d2 and idx, the JAX package's.
//
// Replaces garment4d_tpu/ops/pallas/nn1.py:nn1_pallas (_nn1_impl, pallas_call
// at :78, body _kernel at :36). It serves the interpenetration loss
// (garment vertices against the 6890 body vertices).
//
// What bounds it on the H100: the operations, 9 per (query, point) pair
// (3 subtractions, 3 products, 2 sums, 1 compare). The TPU kernel held a
// (128, N) distance block in VMEM, which bounded N at 8192; here one thread
// owns one query and keeps its running minimum in registers while the point
// set streams through shared memory in tiles of kTile float4 (x, y, z, 0),
// read by the whole block as broadcasts, so any N works. A strict `<` over
// ascending n keeps the lower index on ties.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ points,
           int M, int N, float* __restrict__ d2, int* __restrict__ idx) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (m < M) {
    const float* q = query + ((size_t)b * M + m) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float* pb = points + (size_t)b * N * 3;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int cnt = min(kTile, N - n0);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const float* p = pb + (size_t)(n0 + e) * 3;
      tile[e] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      const float dd = g4d_sqdist(qx - p.x, qy - p.y, qz - p.z);
      if (dd < best) {
        best = dd;
        best_i = n0 + j;
      }
    }
  }
  if (m < M) {
    d2[(size_t)b * M + m] = best;
    idx[(size_t)b * M + m] = best_i;
  }
}

}  // namespace

// query (B, M, 3), points (B, N, 3) f32, N >= 1 -> d2 (B, M) f32, idx (B, M) i32
extern "C" int g4d_nn1(const float* query, const float* points, int B, int M,
                       int N, float* d2, int* idx, cudaStream_t stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  dim3 grid(g4d_blocks(M, kThreads), B);
  nn1_kernel<<<grid, kThreads, 0, stream>>>(query, points, M, N, d2, idx);
  return (int)cudaGetLastError();
}
