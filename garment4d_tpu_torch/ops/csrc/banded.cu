// Cyclic-banded matrix product:
//   out[b, i, :] = sum_d vals[d, i] * x[b, (i + o_d) mod V, :]
// summed in offset order, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), so the result is bitwise the plain
// version's roll loop (`ops/graph.py:_banded_plain`) on the card.
//
// Replaces garment4d_tpu/ops/pallas/banded.py:banded_matmul_pallas
// (pallas_call at :77, body _banded_kernel at :31). It serves the GCN
// stack's backward recompute and its transpose (C = 128) and the posed
// uniform-Laplacian loss, forward and backward (C = 3).
//
// What bounds it on the H100: the bytes, one read of x and one write of the
// output (2 * 4 * B * V * C; D <= 64 diagonals do 2 * D flops per element).
// The TPU kernel rolled a VMEM-resident (V, C) block; here one thread owns
// one (b, i, 4-channel group): the D neighbour rows it reads are other
// threads' rows too and come from L1/L2, so device memory sees x about
// once. The offsets travel as a kernel parameter (constant bank, read once
// per block); a diagonal value vals[d, i] is one load that the threads of a
// row share (a warp-wide broadcast at C = 128, coalesced at C = 3). Rows
// are float4 loads and stores when C is a multiple of 4 and the pointers
// are 16-byte aligned, scalar otherwise. The wrap at V is one compare.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiags = 64;

struct Band {
  int off[kMaxDiags];  // cyclic offsets in [0, V)
  int D;
};

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
banded_kernel(const float* __restrict__ vals, Band band,
              const float* __restrict__ x, int B, int V, int C,
              float* __restrict__ out) {
  const int CG = (C + 3) / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * V * CG) return;
  const int cg = (int)(e % CG);
  const long long bv = e / CG;
  const int i = (int)(bv % V);
  const int b = (int)(bv / V);
  const int c0 = cg * 4;
  const int nc = min(4, C - c0);
  const float* xb = x + (size_t)b * V * C + c0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < band.D; ++d) {
    int u = i + band.off[d];
    if (u >= V) u -= V;
    const float w = __ldg(vals + (size_t)d * V + i);
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (kVec4) {
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(xb + (size_t)u * C));
      xv[0] = x4.x;
      xv[1] = x4.y;
      xv[2] = x4.z;
      xv[3] = x4.w;
    } else {
      for (int k = 0; k < nc; ++k) xv[k] = __ldg(xb + (size_t)u * C + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float t = __fmul_rn(xv[k], w);
      acc[k] = d == 0 ? t : __fadd_rn(acc[k], t);
    }
  }
  float* o = out + ((size_t)b * V + i) * C + c0;
  if (kVec4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    for (int k = 0; k < nc; ++k) o[k] = acc[k];
  }
}

}  // namespace

// vals (D, V) f32 with vals[d, i] = adj[i, (i + offsets[d]) mod V], D in
// 1..64, offsets in [0, V); x (B, V, C) f32 -> out (B, V, C).
extern "C" int g4d_banded(const float* vals, const int* offsets, int D,
                          const float* x, int B, int V, int C, float* out,
                          cudaStream_t stream) {
  if (D < 1 || D > kMaxDiags) return (int)cudaErrorInvalidValue;
  Band band = {};
  for (int d = 0; d < D; ++d) {
    if (offsets[d] < 0 || offsets[d] >= V) return (int)cudaErrorInvalidValue;
    band.off[d] = offsets[d];
  }
  band.D = D;
  const long long n = (long long)B * V * ((C + 3) / 4);
  if (n == 0) return (int)cudaSuccess;
  const bool vec4 = C % 4 == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)out % 16) == 0;
  if (vec4)
    banded_kernel<true><<<g4d_blocks(n, kThreads), kThreads, 0, stream>>>(
        vals, band, x, B, V, C, out);
  else
    banded_kernel<false><<<g4d_blocks(n, kThreads), kThreads, 0, stream>>>(
        vals, band, x, B, V, C, out);
  return (int)cudaGetLastError();
}
