// K-NN skinning-weight transfer: for each garment vertex, the normalised
// 1/d^2-weighted average of the body skinning weights over its k (and k64)
// nearest body points, and its nearest body point.
//
// Replaces garment4d_tpu/ops/pallas/knn_transfer.py:knn_weight_transfer_pallas
// (pallas_call at :165, body _kernel at :103). Semantics (the XLA
// formulation, garment4d_tpu/models/skinning.py:63-139): squared diff-form
// distances; the k-th smallest by bisection on the f32 bit patterns
// (non-negative floats order like their bits); every entry below it is
// selected, and of the entries equal to it the first k - #below in index
// order; w = 1/d^2 with d^2 = 0's inf zeroed, normalised by its sum, infs
// zeroed again; out = sum_n w[n] * w0[n, :]. The 1-NN index takes the lowest
// index on ties.
//
// What bounds it on the H100: the selection passes over each row's N
// distances (one count per bisection step, up to ~31 per threshold, two
// thresholds), on the CUDA cores from shared memory. The TPU kernel held a
// (64, N) distance tile in VMEM and ran its bisection and an MXU
// contraction (with a 3-term bf16 split of w0 for fp32 accuracy) over it.
// Here one warp owns one garment vertex: it writes the row's N distance bit
// patterns (27.6 KB at N = 6890) to shared memory once, finds min, max and
// the 1-NN with warp shuffles, bisects between them, and compacts the k
// selected (index, weight) pairs in index order with ballots; then lane j
// sums q * w0[n, j] over the selected rows in plain fp32 (J <= 32). Nothing
// but the (Vg, J) results reaches device memory.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// number of row entries <= x (warp-uniform)
__device__ int count_le(const unsigned* row, int N, unsigned x, int lane) {
  int c = 0;
  for (int n = lane; n < N; n += 32) c += row[n] <= x;
  return warp_sum(c);
}

// the k-th smallest row entry, known to lie in [lo, hi] (warp-uniform)
__device__ unsigned kth_smallest(const unsigned* row, int N, int k,
                                 unsigned lo, unsigned hi, int lane) {
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    if (count_le(row, N, mid, lane) >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Select the entries below t and the first k - #below entries equal to t
// (index order), store their (index, 1/d^2 with inf -> 0) in index order,
// then out[j] = sum_s q_s * w0[n_s, j] with q = w / sum(w) (inf -> 0), one
// lane per j.
__device__ void transfer(const unsigned* row, int N, unsigned t, int k,
                         int* sel_n, float* sel_w, const float* __restrict__ w0,
                         int J, int lane, float* __restrict__ out) {
  int below = 0;
  for (int n = lane; n < N; n += 32) below += row[n] < t;
  const int extra = k - warp_sum(below);
  const unsigned lower_lanes = (1u << lane) - 1u;
  int ties = 0, count = 0;
  float wsum = 0.f;
  for (int base = 0; base < N; base += 32) {
    const int n = base + lane;
    const unsigned v = n < N ? row[n] : kFull;
    const bool tie = v == t;
    const unsigned tie_mask = __ballot_sync(kFull, tie);
    const bool sel = v < t || (tie && ties + __popc(tie_mask & lower_lanes) < extra);
    const unsigned sel_mask = __ballot_sync(kFull, sel);
    if (sel) {
      float w = 1.0f / __uint_as_float(v);
      if (isinf(w)) w = 0.f;
      const int s = count + __popc(sel_mask & lower_lanes);
      sel_n[s] = n;
      sel_w[s] = w;
      wsum += w;
    }
    ties += __popc(tie_mask);
    count += __popc(sel_mask);
  }
  wsum = warp_sum(wsum);
  __syncwarp();
  if (lane < J) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < count; ++s) {
      float q = sel_w[s] / wsum;
      if (isinf(q)) q = 0.f;
      acc = fmaf(q, __ldg(w0 + (size_t)sel_n[s] * J + lane), acc);
    }
    out[lane] = acc;
  }
  __syncwarp();  // the selection buffers are reused by the next call
}

__global__ void knn_transfer_kernel(const float* __restrict__ garment,
                                    const float* __restrict__ body,
                                    const float* __restrict__ w0, int Vg,
                                    int N, int J, int k, int k64, int rows,
                                    float* __restrict__ outk,
                                    float* __restrict__ out64,
                                    int* __restrict__ nn1) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int v = blockIdx.x * rows + warp;
  if (v >= Vg) return;  // whole warp; the kernel has no block barrier
  unsigned* row = reinterpret_cast<unsigned*>(smem4) + (size_t)warp * (N + 2 * k);
  int* sel_n = reinterpret_cast<int*>(row + N);
  float* sel_w = reinterpret_cast<float*>(sel_n + k);

  const float* g = garment + ((size_t)b * Vg + v) * 3;
  const float gx = g[0], gy = g[1], gz = g[2];
  const float* p = body + (size_t)b * N * 3;
  unsigned minb = kFull, maxb = 0;
  int mini = 0x7fffffff;
  for (int n = lane; n < N; n += 32) {
    const unsigned bits =
        __float_as_uint(g4d_sqdist(gx - p[3 * n], gy - p[3 * n + 1], gz - p[3 * n + 2]));
    row[n] = bits;
    if (bits < minb) {  // strict: a lane's indices rise, so ties keep the lowest
      minb = bits;
      mini = n;
    }
    maxb = max(maxb, bits);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned ob = __shfl_xor_sync(kFull, minb, o);
    const int oi = __shfl_xor_sync(kFull, mini, o);
    if (ob < minb || (ob == minb && oi < mini)) {
      minb = ob;
      mini = oi;
    }
    maxb = max(maxb, __shfl_xor_sync(kFull, maxb, o));
  }
  __syncwarp();

  const float* w0b = w0 + (size_t)b * N * J;
  const size_t o = ((size_t)b * Vg + v) * J;
  const unsigned tk = kth_smallest(row, N, k, minb, maxb, lane);
  transfer(row, N, tk, k, sel_n, sel_w, w0b, J, lane, outk + o);
  if (k64 == k) {
    if (lane < J) out64[o + lane] = outk[o + lane];
  } else {
    const unsigned t64 = kth_smallest(row, N, k64, minb, tk, lane);  // k64 < k
    transfer(row, N, t64, k64, sel_n, sel_w, w0b, J, lane, out64 + o);
  }
  if (lane == 0) nn1[(size_t)b * Vg + v] = mini;
}

}  // namespace

// garment (B, Vg, 3), body (B, N, 3), w0 (B, N, J) f32; 1 <= k64 <= k <= N,
// J <= 32; `rows` garment vertices (one warp each) per block, smem_bytes =
// rows * (N + 2k) * 4 -> outk, out64 (B, Vg, J) f32, nn1 (B, Vg) i32.
extern "C" int g4d_knn_transfer(const float* garment, const float* body,
                                const float* w0, int B, int Vg, int N, int J,
                                int k, int k64, int rows, int smem_bytes,
                                float* outk, float* out64, int* nn1,
                                cudaStream_t stream) {
  if (k < 1 || k64 < 1 || k64 > k || k > N || J < 1 || J > 32 || rows < 1 ||
      rows > 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Vg == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      knn_transfer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g4d_blocks(Vg, rows), B);
  knn_transfer_kernel<<<grid, rows * 32, smem_bytes, stream>>>(
      garment, body, w0, Vg, N, J, k, k64, rows, outk, out64, nn1);
  return (int)cudaGetLastError();
}
