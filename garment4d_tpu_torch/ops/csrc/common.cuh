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

// ---- asynchronous copies (cp.async, sm_80+) --------------------------------

// 4 bytes global -> shared without a register round trip; any 4-byte
// aligned address, so rows of any width can be fetched in place.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// 16 bytes global -> shared, both 16-byte aligned (L1 bypassed: data read
// once per block).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The same through L1, for rows that neighbouring groups gather again (the
// L1-bypassing copy measured 30% slower on the chain's gathers).
__device__ __forceinline__ void cp_async16_l1(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max that returns NaN when either operand is NaN (torch's max and relu
// propagate NaN; fmaxf drops it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the same for min (torch.minimum)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The gap of p to [lo, hi] along one axis, each difference rounded as
// g4d_sqdist's, NaN when p is NaN: g4d_sqdist of the three gaps is the box
// culls' lower bound (coverage.cu's header says why it never exceeds a
// point's fp32 distance; a NaN bound never skips).
__device__ __forceinline__ float box_gap(float p, float lo, float hi) {
  return max_nan(max_nan(__fsub_rn(lo, p), __fsub_rn(p, hi)), 0.0f);
}

// ---- spatial order of a block's points (coverage.cu, fps.cu) -----------------
//
// A block orders its points along a Morton curve of 8 x 8 x 8 cells over
// their bounding box, by a counting sort in shared memory, so that a warp's
// points lie close together and one box bounds them tightly.
constexpr int kCellBits = 3;
constexpr int kCodes = 1 << (3 * kCellBits);

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The bounding box (lo, hi per axis; NaN values left out) of what every
// thread of the block passes, into bb[6] for all threads. part: 32 x 6
// floats of shared scratch. Two barriers; every thread must call it.
__device__ __forceinline__ void block_bbox(float (&lo)[3], float (&hi)[3], float (*part)[6],
                                           float* bb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      part[warp][a] = lo[a];
      part[warp][3 + a] = hi[a];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float v = lane < n_warps ? part[lane][a] : (a < 3 ? INFINITY : -INFINITY);
      const float r = a < 3 ? warp_min(v) : warp_max(v);
      if (lane == 0) bb[a] = r;
    }
  }
  __syncthreads();
}

// the Morton cell of a point in the box bb (NaN and out-of-box values clamp)
__device__ __forceinline__ unsigned morton_code(float x, float y, float z, const float* bb) {
  const float v[3] = {x, y, z};
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ext = bb[3 + a] - bb[a];
    const float scale = ext > 0.0f ? (float)(1 << kCellBits) / ext : 0.0f;
    const int c = min(max(__float2int_rz((v[a] - bb[a]) * scale), 0), (1 << kCellBits) - 1);
#pragma unroll
    for (int b = 0; b < kCellBits; ++b) code |= (((unsigned)c >> b) & 1u) << (3 * b + a);
  }
  return code;
}

// Exclusive scan of hist[kCodes] in place, by warp 0 (the caller's barriers
// order it against the counts and their readers).
__device__ __forceinline__ void scan_codes(int* hist) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
#pragma unroll
  for (int c0 = 0; c0 < kCodes; c0 += 32) {
    const int v = hist[c0 + lane];
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    hist[c0 + lane] = carry + s - v;
    carry += __shfl_sync(0xffffffffu, s, 31);
  }
}

// ---- the register tile of the CUDA-core products ----------------------------
//
// fused_chain.cu and gcn_stack.cu multiply an activation tile by a weight
// matrix on the CUDA cores in fp32. A thread owns kTileRows x TC outputs
// (TC = 8, or 4 for narrow layers) and accumulates
//   acc[i][j] += sum over k in [0, kn) of a[k * ap + i] * w[k * wp + j].
// The activations are stored k-major in shared memory (a[k * ap + r]: at
// each k the tile's 8 rows are contiguous, two float4 loads) and the weights
// row-major (TC contiguous columns, TC / 4 float4 loads), so per k 2 + TC / 4
// shared loads feed 8 * TC FMAs. With consecutive lanes on consecutive
// column tiles, the lanes of a warp that share a row tile read the same
// activation float4 (a broadcast) and the row tiles of a warp are adjacent,
// so the activation reads of a warp cover contiguous banks. Every output
// adds its products in ascending k with FMAs, so a product split into
// k-chunks gives the same bits as one pass.
constexpr int kTileRows = 8;

// Item `it` of a product with nct column tiles -> (row tile, column tile).
// Column tiles fastest by default; with `warp_tiled` (nct a multiple of 8,
// the row tiles of a multiple of 4) each warp takes 4 row tiles x 8 column
// tiles, so its float4 reads of a k step touch 4 activation and 8 weight
// addresses (one shared-memory wavefront each) rather than 1 and 32.
__device__ __forceinline__ void item_tile(int it, int nct, bool warp_tiled, int& rt, int& ct) {
  if (warp_tiled) {
    const int w = it >> 5, lane = it & 31, nwc = nct >> 3;
    const int wr = w / nwc;
    rt = wr * 4 + (lane >> 3);
    ct = (w - wr * nwc) * 8 + (lane & 7);
  } else {
    rt = it / nct;
    ct = it - rt * nct;
  }
}

// A float4 of the weight operand: from shared memory, or (kGlobal) through
// the read-only L1 path from device memory.
template <bool kGlobal>
__device__ __forceinline__ float4 load_w4(const float* w) {
  if constexpr (kGlobal) return __ldg(reinterpret_cast<const float4*>(w));
  return *reinterpret_cast<const float4*>(w);
}

// The k loop keeps two fragment sets in registers: the loads of step k + 1
// are issued before the FMAs of step k (the last step reloads itself rather
// than read past the operands).
template <int TC, bool kGlobalW = false>
__device__ __forceinline__ void tile_fma(const float* __restrict__ a, int ap,
                                         const float* __restrict__ w, int wp,
                                         int kn, float (&acc)[kTileRows][TC]) {
  if (kn <= 0) return;
  float4 a0 = *reinterpret_cast<const float4*>(a);
  float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  float4 wq[TC / 4];
#pragma unroll
  for (int q = 0; q < TC / 4; ++q) wq[q] = load_w4<kGlobalW>(w + 4 * q);
#pragma unroll 2
  for (int k = 0; k < kn; ++k) {
    const int kk = min(k + 1, kn - 1);
    const float4 n0 = *reinterpret_cast<const float4*>(a + kk * ap);
    const float4 n1 = *reinterpret_cast<const float4*>(a + kk * ap + 4);
    float4 nw[TC / 4];
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) nw[q] = load_w4<kGlobalW>(w + kk * wp + 4 * q);
    const float av[kTileRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float wv[4] = {wq[q].x, wq[q].y, wq[q].z, wq[q].w};
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * q + j] = fmaf(av[i], wv[j], acc[i][4 * q + j]);
    }
    a0 = n0;
    a1 = n1;
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) wq[q] = nw[q];
  }
}

// The same product with the activations quad-major, as the chain kernel
// gathers its input rows: quad q (channels 4q..4q+3) of the tile's 8 rows
// is 8 float4s at x + q * qs + 4 * i, loaded once for 4 k steps (for TC = 4
// the next quad's while this one's FMAs run). Steps k in [kb, ke); weight
// row k at w + (k - kw) * wp; the first 3 channels less ctr[k] where
// `centered` (the chain's subtraction of the center).
template <int TC, bool kGlobalW, bool kCentered>
__device__ __forceinline__ void quad_fma(const float4 (&xr)[kTileRows], int kn, const float* ctr,
                                         const float* __restrict__ w, int wp,
                                         float (&acc)[kTileRows][TC]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e >= kn) break;
    float av[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      const float v = e == 0 ? xr[i].x : e == 1 ? xr[i].y : e == 2 ? xr[i].z : xr[i].w;
      av[i] = kCentered && e < 3 ? v - ctr[e] : v;
    }
    const float* wr = w + e * wp;
#pragma unroll
    for (int qq = 0; qq < TC / 4; ++qq) {
      const float4 w4 = load_w4<kGlobalW>(wr + 4 * qq);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][4 * qq + j] = fmaf(av[i], wv[j], acc[i][4 * qq + j]);
    }
  }
}

// Steps k in [kb, ke), kb a multiple of 4; weight row k at w + (k - kw) * wp.
template <int TC, bool kGlobalW = false>
__device__ __forceinline__ void tile_fma_quads(const float* __restrict__ x, int qs,
                                               const float* __restrict__ w, int wp, int kw,
                                               int kb, int ke, bool centered,
                                               const float* ctr,
                                               float (&acc)[kTileRows][TC]) {
  const int q1 = (ke + 3) >> 2;
  int q = kb >> 2;
  if (q >= q1) return;
  float4 xr[kTileRows];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) xr[i] = *reinterpret_cast<const float4*>(x + q * qs + 4 * i);
  for (; q < q1; ++q) {
    const int kn = min(4, ke - 4 * q);
    const float* wq = w + (4 * q - kw) * wp;
    // registers for the next quad too where the tile is 4 wide (32 + 32 +
    // 32 accumulators); 8-wide tiles load it after this quad's FMAs
    float4 nx[kTileRows];
    if constexpr (TC == 4) {
      const int qn = min(q + 1, q1 - 1);
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        nx[i] = *reinterpret_cast<const float4*>(x + qn * qs + 4 * i);
    }
    if (centered && q == 0)
      quad_fma<TC, kGlobalW, true>(xr, kn, ctr, wq, wp, acc);
    else
      quad_fma<TC, kGlobalW, false>(xr, kn, ctr, wq, wp, acc);
    if constexpr (TC == 4) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i) xr[i] = nx[i];
    } else if (q + 1 < q1) {
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
        xr[i] = *reinterpret_cast<const float4*>(x + (q + 1) * qs + 4 * i);
    }
  }
}

}  // namespace g4d
