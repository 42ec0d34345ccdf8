// Nearest neighbour of each query point in a point set:
//   d2[b, m] = min_n |q[b, m] - p[b, n]|^2,  idx[b, m] = the lowest such n
// with distances in diff form through g4d_sqdist (no FMA contraction), so d2
// and idx are bitwise the plain version's (`ops/pointcloud.py:_nn1_plain`)
// and, on finite inputs, the JAX package's. A NaN distance is never taken
// (NaN points never, a NaN query gets (+inf, 0)), nor an infinite one.
//
// Replaces garment4d_tpu/ops/pallas/nn1.py:nn1_pallas (_nn1_impl, pallas_call
// at :78, body _kernel at :36). It serves the interpenetration loss
// (garment vertices against the 6890 body vertices).
//
// What bounds it on the H100: the distance tests (FP32 issue). A scan tests
// every (query, point) pair, 40 x 2000 x 6890 in a posed train step, though
// a garment vertex's nearest body vertex lies in a few neighbourhoods of
// the body. The TPU kernel held a (128, N) distance block in VMEM and ran a
// min and a first-index reduction over it. Here, as in three_nn.cu with
// one neighbour (the shared code is in common.cuh):
// - a pre-pass (nn1_sort_kernel, one block per frame: nearest_sort) sorts
//   the frame's points along the Morton curve of their bounding box into
//   8-point tiles with a box each, and the queries along the same curve,
//   in shared memory where both fit, and records each query's own tile;
// - the main kernel (nn1_nearest_kernel: nearest_query) gives each warp 32
//   consecutive sorted queries, a lane each; a lane takes its own tile's
//   points first, then the warp walks the tiles from its first lane's own
//   tile on (nearest_walk), skipping 32 tiles at once whose boxes are
//   farther from its queries' box than every lane's distance, then each
//   tile no lane needs, and visits the rest a point at a time as
//   broadcasts; the sorted points and boxes are staged in shared memory
//   where the plan's limit allows, else read through L1;
// - the nearest point is kept in (d^2, index) order (g4d::Nearest<1>), so a
//   tie keeps the lower index whatever order the points arrive in; results
//   go to each query's own index;
// - a small point set (at most the plan's _NEAREST_UNSORTED points) is scanned
//   whole by each query in index order from shared memory, with no
//   pre-pass.
// Exactness: a box bound never exceeds the fp32 distance of a point in the
// box (common.cuh: interval_gap, box_gap); a lane skips a tile only when
// its bound is strictly above the lane's distance, and a NaN bound never
// skips.
#include "common.cuh"

namespace {

template <int KT, bool kShared>
__global__ void __launch_bounds__(g4d::kNearestSortThreads)
nn1_sort_kernel(const float* __restrict__ query, const float* __restrict__ points, int M, int N,
                int tiles, float4* __restrict__ sorted_p, float4* __restrict__ boxes,
                float4* __restrict__ sorted_q, int* __restrict__ own) {
  g4d::nearest_sort<KT, kShared>(query, points, M, N, tiles, sorted_p, boxes, sorted_q, own);
}

template <int KT, bool kStaged, bool kSorted>
__global__ void __launch_bounds__(1024)
nn1_nearest_kernel(const float* __restrict__ query, const float* __restrict__ points, int N,
                   const float4* __restrict__ sorted_p, const float4* __restrict__ boxes,
                   const float4* __restrict__ sorted_q, const int* __restrict__ own, int M,
                   int tiles, float* __restrict__ d2, int* __restrict__ idx) {
  g4d::nearest_query<KT, 1, kStaged, kSorted>(query, points, N, sorted_p, boxes, sorted_q, own,
                                              M, tiles, d2, idx);
}

constexpr int kTile = g4d::kNearestTile;

}  // namespace

// query (B, M, 3), points (B, N, 3) f32, N >= 1 -> d2 (B, M) f32, idx (B, M)
// i32. The plan (ops/pointcloud.py: _nn1_plan) and the scratch (sorted
// points, boxes, sorted queries, own tiles) as common.cuh's launch_nearest
// takes them.
extern "C" int g4d_nn1(const float* query, const float* points, int B, int M, int N, int tile,
                       int sort, int warps, int staged, int smem, float4* sorted_p,
                       float4* boxes, float4* sorted_q, int* own, float* d2, int* idx,
                       cudaStream_t stream) {
  const g4d::NearestKernels kernels = {
      nn1_sort_kernel<kTile, true>, nn1_sort_kernel<kTile, false>,
      nn1_nearest_kernel<kTile, true, true>, nn1_nearest_kernel<kTile, true, false>,
      nn1_nearest_kernel<kTile, false, true>};
  return g4d::launch_nearest(kernels, 1, query, points, B, M, N, tile, sort, warps, staged, smem,
                             sorted_p, boxes, sorted_q, own, d2, idx, stream);
}
