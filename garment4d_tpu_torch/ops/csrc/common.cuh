// Shared helpers for the point-cloud kernels.
#pragma once

#include <cuda_runtime.h>

// Squared distance in diff form, dx*dx + dy*dy + dz*dz, summed left to right
// with every product and sum rounded on its own. The explicit _rn intrinsics
// keep nvcc from contracting to FMA, so radius membership, FPS argmaxes and
// 3-NN orderings are bitwise equal to the plain torch version and to the JAX
// reference.
__device__ __forceinline__ float g4d_sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Grid-size helper for 1-D launches.
static inline unsigned int g4d_blocks(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

namespace g4d {

// Register tile of the CUDA-core matmuls (fused_chain.cu, gcn_stack.cu):
// each thread computes kTileRows x kTileCols outputs.
constexpr int kTileRows = 8;
constexpr int kTileCols = 4;

// acc[r][j] = bias[c0 + j] + sum_k h[(r0 + r) * P + k] * w[k * F + c0 + j]
__device__ __forceinline__ void tile_dot(const float* __restrict__ h, int P,
                                         const float* __restrict__ w,
                                         const float* __restrict__ bias,
                                         int K, int F, int r0, int c0,
                                         float (&acc)[kTileRows][kTileCols]) {
  const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + c0));
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    acc[r][0] = b4.x;
    acc[r][1] = b4.y;
    acc[r][2] = b4.z;
    acc[r][3] = b4.w;
  }
  const float* hr = h + r0 * P;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float4 w4[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      w4[kk] = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k + kk) * F + c0));
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float4 h4 = *reinterpret_cast<const float4*>(hr + r * P + k);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] = fmaf(hv[kk], w4[kk].x, acc[r][0]);
        acc[r][1] = fmaf(hv[kk], w4[kk].y, acc[r][1]);
        acc[r][2] = fmaf(hv[kk], w4[kk].z, acc[r][2]);
        acc[r][3] = fmaf(hv[kk], w4[kk].w, acc[r][3]);
      }
    }
  }
  for (; k < K; ++k) {
    const float4 wk = __ldg(reinterpret_cast<const float4*>(w + (size_t)k * F + c0));
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const float hv = hr[r * P + k];
      acc[r][0] = fmaf(hv, wk.x, acc[r][0]);
      acc[r][1] = fmaf(hv, wk.y, acc[r][1]);
      acc[r][2] = fmaf(hv, wk.z, acc[r][2]);
      acc[r][3] = fmaf(hv, wk.w, acc[r][3]);
    }
  }
}

}  // namespace g4d
