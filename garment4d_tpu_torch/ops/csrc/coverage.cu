// Coverage mask: which points lie within r of at least one center.
//
// Replaces garment4d_tpu/ops/pallas/coverage.py:covered_mask_pallas
// (pallas_call at :61). Semantics: covered[b, n] = 1 iff some center m has
// d^2 < r^2 in diff form; the TPU kernel's min(d^2) < r^2 is the same test.
//
// What bounds it on the H100: the exact distance tests (FP32 instructions,
// ~9 a test). The TPU kernel formed the whole (points, centers) distance
// block; a thread per point scanning every center would run ~N x M tests per
// frame, since a warp runs as long as its slowest lane and uncovered points
// scan everything. The answer is a yes/no per point that does not depend on
// the order in which centers are visited, and this design uses that freedom:
// - a block takes `T` points of a frame, one a thread, and orders them along
//   a Morton curve over their bounding box (a counting sort of 512 cells
//   in shared memory), so that a warp's 32 points lie close
//   together even where the cloud's index order is random;
// - the block stages the frame's centers in shared memory as float4s (one
//   broadcast LDS.128 per test), chunk by chunk, and in a prologue computes
//   an axis-aligned box for each tile of kTile consecutive centers (index
//   order is spatially coherent on mesh templates);
// - a warp visits the tiles: it skips a tile when none of its open points
//   can reach the tile's box, otherwise it tests the tile's centers exactly
//   with g4d_sqdist; it leaves the loop when all of its points are covered,
//   and the block stops staging chunks when all of its points are;
// - most tested tiles are needed by a few of the warp's points (one in a
//   quarter of them, at most four in two thirds, on the posed forward's
//   data). Those are tested a center a lane, the needing points broadcast
//   in turn (32 tests in ~16 instructions a point); a tile more than
//   `dense` points need is tested a point a lane (32 x ~10 instructions;
//   the two measured alike for `dense` from 8 to 16).
//
// Exactness of the cull. A tile is skipped only when lb >= r2, where for
// each axis the gap to the box [lo, hi] is g = max(max(fl(lo - p), fl(p -
// hi)), 0) (g4d::box_gap) and lb = g4d_sqdist(gx, gy, gz). For a center c
// of the tile, lo <= c <= hi. If p < lo, then c - p >= lo - p > 0, and
// rounding is monotone, so fl(c - p) >= fl(lo - p) = g; if p > hi, then
// |fl(c - p)| = fl(p - c) >= fl(p - hi) = g (round to nearest is
// symmetric); otherwise g = 0 <= |fl(c - p)|. Squaring and adding rounded non-negative values are
// monotone too, and lb sums in g4d_sqdist's order, so lb <= the fp32 d^2 of
// every center of the tile: lb >= r2 means no center of the tile has d^2 <
// r2. NaN centers are left out of the boxes and never hit; a NaN point's
// bound is NaN, which never skips (its tests never hit).
#include "common.cuh"

namespace {

constexpr int kTile = 32;  // centers per box: a lane each

// Shared memory (dynamic, float4 units): the chunk's centers, two box
// corners per tile, the block's points in curve order (x, y, z, index
// bits), then the cells' counts (int).
__global__ void __launch_bounds__(1024)
coverage_kernel(const float* __restrict__ xyz, const float* __restrict__ centers, int N,
                int M, float r2, int chunk, int dense, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* sc = smem4;
  float4* sbox = sc + chunk;
  float4* spts = sbox + 2 * (chunk / kTile);
  int* hist = reinterpret_cast<int*>(spts + blockDim.x);
  __shared__ float part[32][6];
  __shared__ float bb[6];

  const int b = blockIdx.y;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const float* pb = xyz + (size_t)b * N * 3;

  // the block's points and their bounding box (NaN points left out)
  int pi = blockIdx.x * T + tid;  // index in the frame, -1: none
  if (pi >= N) pi = -1;
  const int s = pi < 0 ? 0 : pi;
  float px = pb[3 * s], py = pb[3 * s + 1], pz = pb[3 * s + 2];
  {
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    if (pi >= 0) {
      lo[0] = hi[0] = px;
      lo[1] = hi[1] = py;
      lo[2] = hi[2] = pz;
    }
    for (int i = tid; i < g4d::kCodes; i += T) hist[i] = 0;
    g4d::block_bbox(lo, hi, part, bb);
  }
  // counting sort along the curve; ranks within a cell by shared atomics
  // (their order is free: the answer per point does not depend on it)
  const unsigned code = pi < 0 ? g4d::kCodes - 1 : g4d::morton_code(px, py, pz, bb);
  const int rank = atomicAdd(&hist[code], 1);
  __syncthreads();
  g4d::scan_codes(hist);
  __syncthreads();
  spts[hist[code] + rank] = make_float4(px, py, pz, __int_as_float(pi));
  __syncthreads();
  {
    const float4 q = spts[tid];
    px = q.x;
    py = q.y;
    pz = q.z;
    pi = __float_as_int(q.w);
  }

  bool open = pi >= 0;  // a real point not covered yet
  const float* cb = centers + (size_t)b * M * 3;
  for (int c0 = 0; c0 < M; c0 += chunk) {
    // every thread is done with the previous chunk; stop when the block is
    if (!__syncthreads_or(open)) break;
    const int cnt = min(chunk, M - c0);
    const int tiles = (cnt + kTile - 1) / kTile;
    for (int i = tid; i < tiles * kTile; i += T) {
      float4 c = make_float4(NAN, NAN, NAN, 0.0f);  // padding never hits
      if (i < cnt) {
        const float* q = cb + 3 * (size_t)(c0 + i);
        c = make_float4(q[0], q[1], q[2], 0.0f);
      }
      sc[i] = c;
    }
    __syncthreads();
    for (int t = warp; t < tiles; t += n_warps) {
      const float4 c = sc[t * kTile + lane];
      const float lx = g4d::warp_min(c.x), ly = g4d::warp_min(c.y), lz = g4d::warp_min(c.z);
      const float hx = g4d::warp_max(c.x), hy = g4d::warp_max(c.y), hz = g4d::warp_max(c.z);
      if (lane == 0) {
        sbox[2 * t] = make_float4(lx, ly, lz, 0.0f);
        sbox[2 * t + 1] = make_float4(hx, hy, hz, 0.0f);
      }
    }
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      if (!__any_sync(0xffffffffu, open)) break;
      const float4 lo = sbox[2 * t], hi = sbox[2 * t + 1];
      const float lb = g4d_sqdist(g4d::box_gap(px, lo.x, hi.x), g4d::box_gap(py, lo.y, hi.y),
                                  g4d::box_gap(pz, lo.z, hi.z));
      const unsigned need = __ballot_sync(0xffffffffu, open && !(lb >= r2));
      if (need == 0u) continue;
      const float4* ct = sc + t * kTile;
      if (__popc(need) > dense) {
        // many points: each lane tests its point against the tile's centers
        bool hit = false;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          const float4 c = ct[i];
          hit |= g4d_sqdist(c.x - px, c.y - py, c.z - pz) < r2;
        }
        open = open && !hit;
      } else {
        // few points: each lane holds a center, the needing points in turn
        const float4 c = ct[lane];
        unsigned hits = 0u;
        for (unsigned m = need; m != 0u; m &= m - 1u) {
          const int src = __ffs(m) - 1;
          const float qx = __shfl_sync(0xffffffffu, px, src);
          const float qy = __shfl_sync(0xffffffffu, py, src);
          const float qz = __shfl_sync(0xffffffffu, pz, src);
          if (__any_sync(0xffffffffu, g4d_sqdist(c.x - qx, c.y - qy, c.z - qz) < r2))
            hits |= 1u << src;
        }
        open = open && !((hits >> lane) & 1u);
      }
    }
  }
  if (pi >= 0) out[(size_t)b * N + pi] = open ? 0 : 1;
}

}  // namespace

// xyz (B, N, 3), centers (B, M, 3) f32 -> out (B, N) i32 in {0, 1}; r2 is
// the f32 r^2. The launch plan (pointcloud._coverage_plan): `blocks` per
// frame of `threads` threads, a point each, `chunk` centers staged at a time
// in whole tiles of `tile` (kTile) centers, `dense` (the most needing points
// a tile tested a center a lane has), `smem` dynamic shared bytes, which
// must hold the chunk, its boxes, the points and the sort's counts.
extern "C" int g4d_coverage(const float* xyz, const float* centers, int B, int N, int M,
                            float r2, int threads, int blocks, int tile, int chunk, int dense,
                            int smem, int* out, cudaStream_t stream) {
  if (threads < 32 || threads > 1024 || threads % 32 || tile != kTile || chunk < kTile ||
      chunk % kTile || dense < 0 || dense > 32 ||
      smem < 16 * chunk + 32 * (chunk / kTile) + 16 * threads + 4 * g4d::kCodes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coverage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  coverage_kernel<<<dim3(blocks, B), threads, smem, stream>>>(xyz, centers, N, M, r2, chunk,
                                                               dense, out);
  return (int)cudaGetLastError();
}
