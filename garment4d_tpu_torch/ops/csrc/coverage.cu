// Coverage mask: which points lie within r of at least one center.
//
// Replaces garment4d_tpu/ops/pallas/coverage.py:covered_mask_pallas
// (pallas_call at :61). Semantics: covered[b, n] = 1 iff some center m has
// d^2 < r^2 in diff form; the TPU kernel's min(d^2) < r^2 is the same test.
//
// What bounds it on the H100: the distance tests (FP32 instructions), up to
// N x M per frame (80 x 6890 x 2000 at the posed forward's body queries). The TPU
// kernel formed the whole (points, centers) distance block and reduced it.
// Here one thread owns one point and scans the centers in shared-memory
// tiles that its block stages once; it stops at its first center within r,
// and the block stops loading tiles when all of its points are covered. On
// garment-on-body geometry most covered points stop within the first few
// hundred centers; uncovered points scan them all.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
coverage_kernel(const float* __restrict__ xyz,
                const float* __restrict__ centers, int N, int M, float r2,
                int* __restrict__ out) {
  __shared__ float cx[kTile], cy[kTile], cz[kTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < N;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    const float* p = xyz + ((size_t)b * N + n) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const float* c = centers + (size_t)b * M * 3;
  int hit = 0;
  bool done = !live;
  for (int base = 0; base < M; base += kTile) {
    // barrier: every thread is done with the previous tile before reload
    if (__syncthreads_and(done)) break;
    const int t = min(kTile, M - base);
    for (int i = threadIdx.x; i < t; i += blockDim.x) {
      cx[i] = c[3 * (base + i)];
      cy[i] = c[3 * (base + i) + 1];
      cz[i] = c[3 * (base + i) + 2];
    }
    __syncthreads();
    if (!done) {
      for (int i = 0; i < t; ++i) {
        if (g4d_sqdist(cx[i] - px, cy[i] - py, cz[i] - pz) < r2) {
          hit = 1;
          break;
        }
      }
      done = hit != 0;
    }
  }
  if (live) out[(size_t)b * N + n] = hit;
}

}  // namespace

// xyz (B, N, 3), centers (B, M, 3) f32 -> out (B, N) i32 in {0, 1}; r2 is
// the f32 r^2.
extern "C" int g4d_coverage(const float* xyz, const float* centers, int B,
                            int N, int M, float r2, int* out,
                            cudaStream_t stream) {
  dim3 grid(g4d_blocks(N, kThreads), B);
  coverage_kernel<<<grid, kThreads, 0, stream>>>(xyz, centers, N, M, r2, out);
  return (int)cudaGetLastError();
}
