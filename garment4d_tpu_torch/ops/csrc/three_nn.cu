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
//   their bounding box into tiles of kTile points with a box each, and the
//   frame's queries along the same curve, in shared memory, and writes
//   them out (common.cuh: sort_frame, tile_boxes); each query's own tile
//   is the known tile where its cell begins on the curve;
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
//   points arrive in;
// - a small known set (at most the plan's _THREE_NN_UNSORTED points: fp2
//   and fp3) is not sorted: each query, a lane, scans all of it in index
//   order from shared memory (a strict < keeps the lower index), since the
//   pre-pass and the culls would cost more than they save.
// Exactness: the box bounds never exceed the fp32 distance of a point in
// the box (coverage.cu's header, common.cuh: interval_gap); a lane skips a
// tile only when the bound is strictly above its third distance (a point
// at exactly that distance with a lower index still enters), a NaN bound
// never skips, and every known point is taken once. NaN points never enter.
#include "common.cuh"

namespace {

constexpr int kTile = 8;            // known points a box (the model's best cull)
constexpr int kSortThreads = 1024;  // the pre-pass: a block a frame
constexpr int kSortBits = 4;        // its curve: 16 cells an axis
constexpr int kSortSmem = 190 * 1024;  // its dynamic shared memory at most

// The pre-pass for frame blockIdx.x: its known points into sorted_k (B,
// KT tiles) float4, NaN-padded, and their tile boxes into boxes (B, 2
// tiles); its queries in curve order into sorted_q (B, n) float4 (x, y, z,
// index bits) and each one's own tile into own (B, n). kShared: both are
// sorted in shared memory (16 (KT tiles + n) + 4 n dynamic bytes) and
// copied out coalesced (scattered stores to device memory from one SM
// would cost more than the sort); else in place.
template <int KT, bool kShared>
__global__ void __launch_bounds__(kSortThreads)
three_nn_sort_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int n,
                     int m, int tiles, float4* __restrict__ sorted_k, float4* __restrict__ boxes,
                     float4* __restrict__ sorted_q, int* __restrict__ own) {
  extern __shared__ float4 smem4[];
  __shared__ int hist_k[1 << (3 * kSortBits)];
  __shared__ int hist_q[1 << (3 * kSortBits)];
  __shared__ float part[32][6];
  __shared__ float bb[6];
  const size_t b = blockIdx.x;
  const int rows = tiles * KT;
  float4* kd = kShared ? smem4 : sorted_k + b * rows;
  float4* qd = kShared ? smem4 + rows : sorted_q + b * n;
  int* qo = kShared ? reinterpret_cast<int*>(smem4 + rows + n) : own + b * n;
  g4d::sort_frame<kSortBits>(known + b * m * 3, m, rows, kd, hist_k, part, bb, true);
  g4d::tile_boxes<KT>(kd, tiles, boxes + b * 2 * tiles);
  // the queries on the known points' curve; each one's own tile: where its
  // cell's run of known points begins
  const int* starts = hist_k;
  g4d::sort_frame<kSortBits>(unknown + b * n * 3, n, n, qd, hist_q, part, bb, false,
                             [=](int at, unsigned cell) {
                               qo[at] = min(starts[cell] / KT, tiles - 1);
                             });
  if (kShared) {
    g4d::copy_out(sorted_k + b * rows, kd, rows);
    g4d::copy_out(sorted_q + b * n, qd, n);
    g4d::copy_out(own + b * n, qo, n);
  }
}

// A lane per query. kSorted: the pre-pass's sorted queries, each walking
// the culled tiles from its own; else the frame's queries in index order,
// each scanning every known point in index order (a broadcast load a
// point). Dynamic shared memory (kStaged): the frame's known points (KT
// tiles float4: the pre-pass's, or staged from `known` in index order),
// then, sorted, their boxes (2 tiles).
template <int KT, bool kStaged, bool kSorted>
__global__ void __launch_bounds__(1024)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known, int m,
                const float4* __restrict__ sorted_k, const float4* __restrict__ boxes,
                const float4* __restrict__ sorted_q, const int* __restrict__ own, int n,
                int tiles, float* __restrict__ dist2, int* __restrict__ idx) {
  static_assert(kStaged || kSorted, "known points read through L1 are the pre-pass's");
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const float4* pts = sorted_k + (size_t)b * tiles * KT;
  const float4* box = boxes + (size_t)b * 2 * tiles;
  if constexpr (kStaged) {
    float4* spts = smem4;
    if constexpr (kSorted) {
      g4d::stage16(spts, pts, tiles * KT);
      g4d::stage16(smem4 + tiles * KT, box, 2 * tiles);
      box = smem4 + tiles * KT;
    } else {
      const float* k = known + (size_t)b * m * 3;
      for (int i = threadIdx.x; i < tiles * KT; i += blockDim.x)
        spts[i] = i < m ? make_float4(k[3 * i], k[3 * i + 1], k[3 * i + 2], __int_as_float(i))
                        : make_float4(NAN, NAN, NAN, __int_as_float(-1));
    }
    __syncthreads();
    pts = spts;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  if (!__any_sync(0xffffffffu, active)) return;  // no barrier follows
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  g4d::Nearest<3> best;
  if constexpr (kSorted) {
    int mine = 0;
    if (active) {
      q = sorted_q[(size_t)b * n + i];
      mine = own[(size_t)b * n + i];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 p = g4d::load4<!kStaged>(pts + mine * KT + j);
        best.insert(g4d_sqdist(q.x - p.x, q.y - p.y, q.z - p.z), __float_as_int(p.w));
      }
    }
    g4d::nearest_walk<KT, 3, !kStaged>(pts, box, tiles, __shfl_sync(0xffffffffu, mine, 0), mine,
                                       q.x, q.y, q.z, active, best);
  } else {
    if (active) {
      const float* u = unknown + ((size_t)b * n + i) * 3;
      q = make_float4(u[0], u[1], u[2], __int_as_float(i));
    }
    for (int t = 0; t < tiles; ++t) {
      float d[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 p = pts[t * KT + j];
        d[j] = g4d_sqdist(q.x - p.x, q.y - p.y, q.z - p.z);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) best.insert_ascending(d[j], t * KT + j);
    }
  }
  if (!active) return;
  const size_t o = ((size_t)b * n + __float_as_int(q.w)) * 3;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    dist2[o + s] = best.d[s];
    idx[o + s] = best.i[s];
  }
}

}  // namespace

// unknown (B, n, 3), known (B, m, 3) f32 -> dist2 (B, n, 3) f32,
// idx (B, n, 3) i32; m >= 3. The launch plan (ops/pointcloud.py:
// _three_nn_plan): `tile` known points a box (kTile); `sort` runs the
// pre-pass and the culled walk (else every query scans every known point in
// index order); blocks of `warps` warps over each frame's queries; `staged`
// known points in shared memory (`smem` dynamic bytes, which must hold them
// and, sorted, their boxes; else read through L1, and `sort` is
// required). Scratch for the pre-pass: sorted_k (B, tile x tiles, 4) and
// boxes (B, 2 tiles, 4) f32, sorted_q (B, n, 4) f32, own (B, n) i32.
extern "C" int g4d_three_nn(const float* unknown, const float* known, int B, int n, int m,
                            int tile, int sort, int warps, int staged, int smem, float4* sorted_k,
                            float4* boxes, float4* sorted_q, int* own, float* dist2, int* idx,
                            cudaStream_t stream) {
  const int tiles = (m + kTile - 1) / kTile;
  if (m < 3 || n < 0 || B < 0 || B > 65535 || tile != kTile || warps < 1 ||
      warps > 32 || smem < (staged ? 16 * (tile + (sort ? 2 : 0)) * tiles : 0) ||
      (!staged && !sort) ||
      (sort && (sorted_k == nullptr || boxes == nullptr || sorted_q == nullptr || own == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  if (sort) {
    // the pre-pass sorts in shared memory where both sets fit beside its
    // static counts (32 KB)
    const long long sort_smem = 16LL * (tile * tiles + n) + 4LL * n;
    const bool in_shared = sort_smem <= kSortSmem;
    void (*sorter)(const float*, const float*, int, int, int, float4*, float4*, float4*, int*) =
        in_shared ? three_nn_sort_kernel<kTile, true> : three_nn_sort_kernel<kTile, false>;
    const int bytes = in_shared ? (int)sort_smem : 0;
    cudaError_t err = cudaFuncSetAttribute(sorter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return (int)err;
    sorter<<<B, kSortThreads, bytes, stream>>>(unknown, known, n, m, tiles, sorted_k, boxes,
                                               sorted_q, own);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  void (*kernel)(const float*, const float*, int, const float4*, const float4*, const float4*,
                 const int*, int, int, float*, int*) =
      staged ? (sort ? three_nn_kernel<kTile, true, true> : three_nn_kernel<kTile, true, false>)
             : three_nn_kernel<kTile, false, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = warps * 32;
  kernel<<<dim3(g4d_blocks(n, threads), B), threads, smem, stream>>>(
      unknown, known, m, sorted_k, boxes, sorted_q, own, n, tiles, dist2, idx);
  return (int)cudaGetLastError();
}
