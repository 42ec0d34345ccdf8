// Fused neighbourhood gather + L-layer MLP chain + max over the S samples:
//   out[b, m, :] = max_s chain(table[b, idx[b, m, s], :] - pad(center[b, m]))
// where chain is x -> act(x @ W_l + b_l) per layer (BatchNorm already folded
// into W_l, b_l by the caller) and the center is subtracted on channels 0..2
// only.
//
// Replaces garment4d_tpu/ops/pallas/fusedpe.py:fused_chain_pallas
// (pallas_call at :179, body _chain_kernel at :75) and its valid-count
// variant fused_chain_pallas_nv (pallas_call at :363, body _chain_kernel_nv;
// group_pe_max_pallas_nv at :371). The TPU variant's chunk scan stopped at
// the per-frame count n_valid[b] of real rows of a sentinel-padded table,
// exact only while no index reaches max(n_valid[b], 1). This kernel gathers
// by index and never reads rows past the largest index anyway, so given
// n_valid it computes the same output and reports any index at or past
// max(n_valid[b], 1) in a device flag that the wrapper checks.
//
// What bounds it on the H100: FP32 FMAs (up to 74k per sample row at the sa3
// scale) and the loads that feed them; the weights do not fit in a block's
// shared memory beside the activations (sa3 mlp1 is 296 KB, garment_sa2
// mlp1 363 KB). The design gives each block G centers (G*S rows, up to 256,
// within ~110 KB of shared memory so two blocks share an SM); it gathers
// their rows into shared memory and runs the layers there, ping-ponging
// between two activation buffers, so no (S, width) intermediate reaches
// device memory. Each thread computes an 8-row x 4-column tile: per 4 input
// channels it loads 4 weight float4s (coalesced across the warp, served by
// L1/L2: every block reads the same few hundred KB) and 8 activation float4s
// (shared-memory broadcasts) for 128 FMAs. The last layer keeps per-8-row
// maxima and a final pass reduces them over each center's S rows; only the
// (M, C_L) maxima reach device memory. Every output sums its K products in
// ascending k order with FMAs. No tensor cores: fp32 on the CUDA cores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = g4d::kTileRows;  // S must be a multiple
constexpr int kCols = g4d::kTileCols;  // widths must be multiples
constexpr int kMaxLayers = 4;

struct ChainDims {
  int L;
  int K[kMaxLayers + 1];  // K[0] = table channels, K[l + 1] = layer l width
  int relu_mask;          // bit l: ReLU after layer l
};

__host__ __device__ inline int pitch_of(int k) { return (k + 3) & ~3; }

__global__ void __launch_bounds__(kThreads)
fused_chain_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx,
                   const float* __restrict__ centers,
                   const float* __restrict__ w_all,
                   const float* __restrict__ b_all, ChainDims dims, int N,
                   int M, int S, int G, int width_a, int width_b,
                   const int* __restrict__ n_valid, int* __restrict__ past_valid,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = G * S;
  float* buf0 = smem;
  float* buf1 = buf0 + rows * width_a;
  float* partial = buf1 + rows * width_b;  // (rows / kRows, F_last) maxima
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * G;
  const int C = dims.K[0];
  const int P0 = pitch_of(C);
  const int valid = n_valid != nullptr ? max(__ldg(n_valid + b), 1) : 0x7fffffff;

  // gather the rows of G centers and subtract each center on xyz channels
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int r = e / C;
    const int c = e - r * C;
    const int m = m0 + r / S;
    float v = 0.f;
    if (m < M) {
      const int j = __ldg(idx + ((size_t)b * M + m) * S + (r % S));
      if (j >= valid) *past_valid = 1;
      v = (unsigned)j < (unsigned)N
              ? __ldg(table + ((size_t)b * N + j) * C + c)
              : __int_as_float(0x7fc00000);
      if (c < 3) v -= __ldg(centers + ((size_t)b * M + m) * 3 + c);
    }
    buf0[r * P0 + c] = v;
  }
  __syncthreads();

  const float* w = w_all;
  const float* bias = b_all;
  float acc[kRows][kCols];
  const int n_row_tiles = rows / kRows;
  for (int l = 0; l < dims.L; ++l) {
    const int K = dims.K[l];
    const int F = dims.K[l + 1];
    const int P = pitch_of(K);
    const bool relu = (dims.relu_mask >> l) & 1;
    const bool last = l + 1 == dims.L;
    const float* hin = (l & 1) ? buf1 : buf0;
    float* hout = (l & 1) ? buf0 : buf1;
    const int n_col_tiles = F / kCols;
    for (int it = threadIdx.x; it < n_row_tiles * n_col_tiles; it += blockDim.x) {
      const int c0 = (it % n_col_tiles) * kCols;
      const int rt = it / n_col_tiles;
      g4d::tile_dot(hin, P, w, bias, K, F, rt * kRows, c0, acc);
      if (relu) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaxf(acc[r][j], 0.f);
      }
      if (!last) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          *reinterpret_cast<float4*>(hout + (rt * kRows + r) * F + c0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
        float4 mx = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
#pragma unroll
        for (int r = 1; r < kRows; ++r) {
          mx.x = fmaxf(mx.x, acc[r][0]);
          mx.y = fmaxf(mx.y, acc[r][1]);
          mx.z = fmaxf(mx.z, acc[r][2]);
          mx.w = fmaxf(mx.w, acc[r][3]);
        }
        *reinterpret_cast<float4*>(partial + rt * F + c0) = mx;
      }
    }
    __syncthreads();
    w += (size_t)K * F;
    bias += F;
  }

  // max of each center's S / kRows row tiles
  const int F = dims.K[dims.L];
  const int tiles = S / kRows;
  for (int e = threadIdx.x; e < G * F; e += blockDim.x) {
    const int g = e / F;
    const int c = e - g * F;
    const int m = m0 + g;
    if (m >= M) continue;
    float mx = partial[(g * tiles) * F + c];
    for (int t = 1; t < tiles; ++t) mx = fmaxf(mx, partial[(g * tiles + t) * F + c]);
    out[((size_t)b * M + m) * F + c] = mx;
  }
}

}  // namespace

// table (B, N, C), idx (B, M, S) i32, centers (B, M, 3); w_all holds the L
// row-major (K_l, F_l) weights back to back, b_all the L biases; widths
// f0..f3 (unused ones 0, used ones multiples of 4); relu_mask bit l = ReLU
// after layer l; G centers per block; width_a / width_b the row pitches of
// the two activation buffers; smem_bytes = (G * S * (width_a + width_b) +
// G * S / 8 * F_last) * 4; n_valid (B) i32 or null; past_valid (1) i32, set
// to 1 where an index is >= max(n_valid[b], 1) (untouched without n_valid)
// -> out (B, M, F_{L-1}).
extern "C" int g4d_fused_chain(const float* table, const int* idx,
                               const float* centers, const float* w_all,
                               const float* b_all, int B, int N, int C, int M,
                               int S, int L, int f0, int f1, int f2, int f3,
                               int relu_mask, int G, int width_a, int width_b,
                               int smem_bytes, const int* n_valid,
                               int* past_valid, float* out,
                               cudaStream_t stream) {
  if (L < 1 || L > kMaxLayers || S % kRows != 0) return (int)cudaErrorInvalidValue;
  ChainDims dims;
  dims.L = L;
  dims.K[0] = C;
  const int fs[kMaxLayers] = {f0, f1, f2, f3};
  for (int l = 0; l < kMaxLayers; ++l) {
    dims.K[l + 1] = fs[l];
    if (l < L && fs[l] % kCols != 0) return (int)cudaErrorInvalidValue;
  }
  dims.relu_mask = relu_mask;
  cudaError_t err = cudaFuncSetAttribute(
      fused_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g4d_blocks(M, G), B);
  fused_chain_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      table, idx, centers, w_all, b_all, dims, N, M, S, G, width_a, width_b,
      n_valid, past_valid, out);
  return (int)cudaGetLastError();
}
