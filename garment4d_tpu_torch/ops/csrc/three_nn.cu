// Three nearest known points of every unknown point.
//
// Replaces garment4d_tpu/ops/pallas/three_nn.py:three_nn_pallas (pallas_call
// at :87). Semantics: squared diff-form distances, ascending, ties to the
// lower index; the caller takes the square root.
//
// What bounds it on the H100: the distance tests (FP32 issue). A scan tests
// every (query, known point) pair, 80 x 6890 x 1024 at fp1, though a
// query's three nearest lie in a few of the frame's neighbourhoods. The TPU
// kernel built a full (tile, m) distance block and ran three
// min/argmin/mask rounds over it. Here:
// - a pre-pass (three_nn_sort_kernel, one block per frame) sorts the
//   frame's known points along the Morton curve (16 cells an axis) of
//   their bounding box into tiles of 8 points with a box each, and the
//   frame's queries along the same curve, in shared memory, and writes
//   them out (common.cuh: nearest_sort); each query's own tile is the
//   known tile where its cell begins on the curve;
// - the main kernel's blocks take runs of consecutive sorted queries, a
//   lane each, so that a warp's 32 queries lie close together, and stage
//   the frame's sorted known points and boxes in shared memory (a frame too
//   large to stage is read through L1: kStaged false);
// - each lane takes its own tile's points first, so that its third
//   distance starts near its final value, then the warp walks the tiles
//   from its first lane's own tile on (common.cuh: nearest_walk): it
//   skips 32 tiles at once whose boxes are farther from the box of its
//   queries than every lane's third distance, then a tile that no lane
//   needs, and tests the tiles its lanes need a point at a time
//   (broadcast loads);
// - the best three are kept in registers in (d^2, index) order
//   (g4d::Nearest), so a tie keeps the lower index whatever order the
//   points arrive in (common.cuh: nearest_query);
// - a small known set (at most the plan's _NEAREST_UNSORTED points: fp2
//   and fp3) is not sorted: each query, a lane, scans all of it in index
//   order from shared memory (a strict < keeps the lower index), since the
//   pre-pass and the culls would cost more than they save.
// Exactness: the box bounds never exceed the fp32 distance of a point in
// the box (coverage.cu's header, common.cuh: interval_gap); a lane skips a
// tile only when the bound is strictly above its third distance (a point
// at exactly that distance with a lower index still enters), a NaN bound
// never skips, and every known point is taken once. NaN points never enter;
// a slot no point takes holds (+inf, 0).
//
// The pre-pass, the query kernels' bodies and the launch are shared with
// nn1.cu (common.cuh); the kernels here carry 3-NN's names.
#include "common.cuh"

namespace {

template <int KT, bool kShared>
__global__ void __launch_bounds__(g4d::kNearestSortThreads)
three_nn_sort_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int n,
                     int m, int tiles, float4* __restrict__ sorted_k, float4* __restrict__ boxes,
                     float4* __restrict__ sorted_q, int* __restrict__ own) {
  g4d::nearest_sort<KT, kShared>(unknown, known, n, m, tiles, sorted_k, boxes, sorted_q, own);
}

template <int KT, bool kStaged, bool kSorted>
__global__ void __launch_bounds__(1024)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int m,
                const float4* __restrict__ sorted_k, const float4* __restrict__ boxes,
                const float4* __restrict__ sorted_q, const int* __restrict__ own, int n,
                int tiles, float* __restrict__ dist2, int* __restrict__ idx) {
  g4d::nearest_query<KT, 3, kStaged, kSorted>(unknown, known, m, sorted_k, boxes, sorted_q, own,
                                              n, tiles, dist2, idx);
}

constexpr int kTile = g4d::kNearestTile;

}  // namespace

// unknown (B, n, 3), known (B, m, 3) f32 -> dist2 (B, n, 3) f32,
// idx (B, n, 3) i32; m >= 3. The plan (ops/pointcloud.py: _three_nn_plan)
// and the scratch as common.cuh's launch_nearest takes them.
extern "C" int g4d_three_nn(const float* unknown, const float* known, int B, int n, int m,
                            int tile, int sort, int warps, int staged, int smem, float4* sorted_k,
                            float4* boxes, float4* sorted_q, int* own, float* dist2, int* idx,
                            cudaStream_t stream) {
  const g4d::NearestKernels kernels = {
      three_nn_sort_kernel<kTile, true>, three_nn_sort_kernel<kTile, false>,
      three_nn_kernel<kTile, true, true>, three_nn_kernel<kTile, true, false>,
      three_nn_kernel<kTile, false, true>};
  return g4d::launch_nearest(kernels, 3, unknown, known, B, n, m, tile, sort, warps, staged, smem,
                             sorted_k, boxes, sorted_q, own, dist2, idx, stream);
}
