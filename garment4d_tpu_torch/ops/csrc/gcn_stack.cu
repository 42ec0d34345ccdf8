// One layer of the posed stage's GCN refinement stack over a cyclic-banded
// adjacency:
//   out[b, v, :] = act((sum_d vals[d, v] * h[b, (v + o_d) mod V, :]) @ W + bias)
// where h is the layer input, given as up to 8 channel pieces whose
// concatenation it is (layer 0: xyz, 3 body PEs, 3 garment PEs and, from the
// second iteration on, the temporal-attention mix).
//
// Replaces garment4d_tpu/ops/pallas/gcnstack.py:gcn_stack_cf_pallas
// (pallas_call at :176, body _stack_kernel at :61), launched once per layer.
// The TPU kernel computed adj @ (h @ W) per layer; this one computes
// (adj @ h) @ W, equal up to fp32 summation order.
//
// What bounds it on the H100: the fp32 FMAs of the products, 2 * V * K * F
// per frame and layer (about 24 GFLOP for one 323-wide iteration of 80
// frames), on the CUDA cores. The TPU kernel kept a whole frame's (F, V)
// activations in VMEM across the four layers; a frame's 2000 x 128
// activations (1 MB) do not fit in a block's shared memory, so here each
// layer is one launch and its output one (B, V, F) write that the next
// layer reads (the layer-2 output is also the `hidden` the next iteration's
// attention reads). A block takes 64 vertices of one frame: it forms their
// banded sums a[v, :] in shared memory, reading the D neighbour rows of
// each vertex (wrapping at V) straight from the pieces, so the concatenated
// input is never written; then a[v, :] @ W + bias on 8 x 4 register tiles
// (g4d::tile_dot), W read as float4s from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPieces = 8;
constexpr int kMaxDiags = 64;

struct Pieces {
  const float* ptr[kMaxPieces];  // (B, V, width[i]) each
  int width[kMaxPieces];
  int n;
};

struct Band {
  int off[kMaxDiags];  // cyclic offsets in [0, V)
  int D;
};

__global__ void __launch_bounds__(kThreads)
gcn_layer_kernel(Pieces pieces, int V, int K, int P,
                 const float* __restrict__ vals, Band band,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 int F, int F4, int relu, int tile_v,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);  // (tile_v, P)
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * tile_v;

  // banded aggregation of the input rows of this tile's vertices
  for (int e = threadIdx.x; e < tile_v * K; e += blockDim.x) {
    const int r = e / K;
    const int c = e - r * K;
    const int v = v0 + r;
    float acc = 0.f;
    if (v < V) {
      int piece = 0, cl = c;
      while (cl >= pieces.width[piece]) cl -= pieces.width[piece++];
      const int wp = pieces.width[piece];
      const float* src = pieces.ptr[piece] + (size_t)b * V * wp + cl;
      for (int d = 0; d < band.D; ++d) {
        int u = v + band.off[d];
        if (u >= V) u -= V;
        acc = fmaf(__ldg(vals + (size_t)d * V + v), __ldg(src + (size_t)u * wp), acc);
      }
    }
    a[r * P + c] = acc;
  }
  __syncthreads();

  // a @ W + bias (+ ReLU)
  constexpr int kRows = g4d::kTileRows;
  constexpr int kCols = g4d::kTileCols;
  const int n_col_tiles = F4 / kCols;
  float acc[kRows][kCols];
  for (int it = threadIdx.x; it < (tile_v / kRows) * n_col_tiles; it += blockDim.x) {
    const int c0 = (it % n_col_tiles) * kCols;
    const int r0 = (it / n_col_tiles) * kRows;
    g4d::tile_dot(a, P, w, bias, K, F4, r0, c0, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int v = v0 + r0 + r;
      if (v >= V) break;
      float* o = out + ((size_t)b * V + v) * F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (c0 + j < F) o[c0 + j] = relu ? fmaxf(acc[r][j], 0.f) : acc[r][j];
      }
    }
  }
}

}  // namespace

// Pieces ptrs[i] (B, V, widths[i]) f32, n_pieces in 1..8, K = sum(widths);
// vals (D, V) f32 with vals[d, v] = adj[v, (v + offsets[d]) mod V], D in
// 1..64; w (K, F4) row-major with F4 = F rounded up to 4 (zero columns past
// F), bias (F4,); tile_v vertices per block (a multiple of 8); smem_bytes =
// tile_v * P * 4 with P = K rounded up to 4 -> out (B, V, F).
extern "C" int g4d_gcn_layer(const void* const* ptrs, const int* widths,
                             int n_pieces, int B, int V, int K,
                             const float* vals, const int* offsets, int D,
                             const float* w, const float* bias, int F, int F4,
                             int relu, int tile_v, int smem_bytes, float* out,
                             cudaStream_t stream) {
  if (n_pieces < 1 || n_pieces > kMaxPieces || D < 1 || D > kMaxDiags ||
      F4 % g4d::kTileCols != 0 || F > F4 || tile_v % g4d::kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  Pieces pieces = {};
  int total = 0;
  for (int i = 0; i < n_pieces; ++i) {
    pieces.ptr[i] = static_cast<const float*>(ptrs[i]);
    pieces.width[i] = widths[i];
    total += widths[i];
  }
  pieces.n = n_pieces;
  if (total != K) return (int)cudaErrorInvalidValue;
  Band band = {};
  for (int d = 0; d < D; ++d) {
    if (offsets[d] < 0 || offsets[d] >= V) return (int)cudaErrorInvalidValue;
    band.off[d] = offsets[d];
  }
  band.D = D;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const int P = (K + 3) & ~3;
  cudaError_t err = cudaFuncSetAttribute(
      gcn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g4d_blocks(V, tile_v), B);
  gcn_layer_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      pieces, V, K, P, vals, band, w, bias, F, F4, relu, tile_v, out);
  return (int)cudaGetLastError();
}
