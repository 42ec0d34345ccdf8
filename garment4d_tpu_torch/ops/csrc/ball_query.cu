// Multi-radius ball query: for each center and radius, the first nsample
// in-radius point indices in index order.
//
// Replaces garment4d_tpu/ops/pallas/ball_query.py:ball_query_multi_pallas on
// its flat path (pallas_call at :528, body _bq_kernel at :126),
// ball_query_pallas (:547), and _ball_query_multi_grouped (pallas_call at
// :456, body _bq_grouped_kernel at :184), the query over a compacted table
// padded with far sentinels whose per-frame valid count bounds the scan.
// Semantics (reference CUDA ball_query_gpu.cu): membership is d^2 < r^2 in
// diff form; slots past the hit count copy the first hit; a center with no
// hit keeps index 0 in every slot.
//
// What bounds it on the H100: the distance tests (FP32 issue). The TPU
// kernels scanned all points (the grouped one skipped 512-point groups that
// could hold no needed hit) and extracted slots with prefix sums, because the
// vector unit cannot stop per center.
//
// Flat query. The first S hits in index order are the S smallest indices of
// the whole hit set, so the points need not be visited in index order. Most
// SA centers have fewer than S hits (a scan in index order reads the whole
// frame for them), and in index order a mesh's points are spread out, so a
// box over consecutive indices culls little. So, for frames past the plan's
// _FLAT_UNSORTED points:
// - a pre-pass (flat_sort_kernel, one block per frame) sorts each frame
//   along the Morton curve (16 cells an axis) of its bounding box into
//   tiles of 32 points as float4 (x, y, z, index bits), in shared memory,
//   then writes them out with a box per tile, holding the tile's lowest and
//   highest index in .w, and a box per 32 tiles (a super box; common.cuh:
//   sort_frame, group_boxes);
// - the query's blocks each take a contiguous range of the B x M (frame,
//   center) pairs and stage each frame of it (points and boxes) in shared
//   memory; their warps take its centers from a block counter, each loading
//   its next center while it serves this one. A frame too large to stage
//   is read from the pre-pass's output through L1 (kStaged false);
// - a warp owns one center: it tests 32 super boxes a step, then the 32
//   tile boxes of each super box it needs, then the 32 points of each tile
//   it needs, a point a lane (g4d::box_gap's bound; a box is skipped at a
//   bound >= the largest r^2; g4d_sqdist:
//   memberships bitwise the plain version's), one distance for every radius
//   of the call. A hit sets its index's bit in the warp's bitmap of the
//   radius in shared memory (a window of 32 x `words` indices: one window
//   covers the frame unless the plan makes it smaller);
// - then the warp walks each bitmap in index order, 128 words a step (four
//   a lane, popcounts and a warp scan), writes the first S hits, clears the
//   words for its next center, and applies the tail rule.
// Exactness of the cull: a box is skipped only when its bound is >= r^2,
// and the bound never exceeds the fp32 distance of a point in the box
// (coverage.cu's header); a hit needs d < r^2; a NaN bound never skips. NaN
// points never hit, and are left out of boxes. Smaller frames (the model's
// garment levels and upper SA stages: FPS samples, which no box culls in
// index order, and which the pre-pass would cost more than it saves) take
// ball_query_lane_kernel: a lane per center walks the staged frame in index
// order and leaves at its quotas.
//
// Grouped query: one warp owns one center, so a center that scans far (a
// sparse one, near the garment's hem) holds up no other. Each step tests
// 128 consecutive rows, four per lane; per radius still short of its quota
// one vote says whether any of them hits, and only then do a ballot per 32
// rows and the popcount of the lower lanes place each hit at its slot in
// index order (most steps of a sparse center hit nothing). The warp leaves
// when every radius is full: a scan is its own center's length, rounded up
// to 128 rows. A block stages its frame's valid prefix (rows [0,
// n_valid[b]), read on the device) in shared memory once, as float4s padded
// to whole steps with far rows, and its warps take the frame's centers from
// a block counter; rows past the staged capacity are read through L1. One
// distance pass serves up to three radii.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRadii = 3;
constexpr int kFlatTile = 32;       // flat query: points a box (a lane each)
constexpr int kSortThreads = 1024;  // flat query's pre-pass: a block a frame
constexpr int kSortBits = 4;        // its curve: 16 cells an axis
constexpr int kSortSmem = 200 * 1024;  // its dynamic shared memory at most
constexpr int kWalkWords = 4;       // bitmap words a lane reads a walk step
constexpr int kLaneThreads = 128;   // a lane per center: threads a block at most
constexpr int kLaneMaxN = 3072;     // a lane per center: points a frame (48 KB) at most
constexpr int kRows = 4;            // grouped query: rows a lane tests per step
constexpr int kStep = 32 * kRows;   // rows a warp tests per step
constexpr int kGroupedThreads = 512;  // 16 warps, two blocks resident per SM

struct Queries {
  float r2[kMaxRadii];   // f32 r^2 per radius
  int nsample[kMaxRadii];
  int* out[kMaxRadii];   // (B, M, nsample) each
  int n;                 // radii in use
};

// The flat query's pre-pass: frame blockIdx.x of xyz in Morton order into
// sorted (B, 32 tiles) float4, NaN-padded; its tile boxes, then the boxes
// of each 32 tiles (supers), into boxes (B, 2 (tiles + supers)). kShared:
// the frame is sorted in shared memory (16 x 32 tiles dynamic bytes) and
// copied out coalesced (scattered 16-byte stores to device memory from one
// SM would cost more than the sort); else it is sorted in place.
template <bool kShared>
__global__ void __launch_bounds__(kSortThreads)
flat_sort_kernel(const float* __restrict__ xyz, int N, int tiles, float4* __restrict__ sorted,
                 float4* __restrict__ boxes) {
  extern __shared__ float4 smem4[];
  __shared__ int hist[1 << (3 * kSortBits)];
  __shared__ float part[32][6];
  __shared__ float bb[6];
  const size_t b = blockIdx.x;
  const int supers = (tiles + 31) / 32, rows = tiles * kFlatTile;
  float4* out = sorted + b * rows;
  float4* dst = kShared ? smem4 : out;
  float4* box = boxes + b * 2 * (tiles + supers);
  g4d::sort_frame<kSortBits>(xyz + b * N * 3, N, rows, dst, hist, part, bb, true);
  g4d::tile_boxes<kFlatTile>(dst, tiles, box);
  if (kShared) g4d::copy_out(out, dst, rows);
  __syncthreads();
  g4d::group_boxes<32, false>(box, tiles, box + 2 * tiles);
}

// One radius's hits of a window (bitmap `row` of `words` words, indices from
// w0) in index order: the slots from cnt up to S get the next hits; `first`
// takes the lowest hit of the center (the window's, while cnt is 0); cnt
// adds the window's hits. The words read are cleared. Warp-uniform.
__device__ __forceinline__ void walk_hits(unsigned* row, int words, int w0, int S, int* o,
                                          int& cnt, int& first) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < words; c0 += 32 * kWalkWords) {
    const int wi = c0 + kWalkWords * lane;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (wi < words) {
      uint4* cell = reinterpret_cast<uint4*>(row + wi);
      v = *cell;
      *cell = make_uint4(0u, 0u, 0u, 0u);
    }
    const int pc = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    const unsigned any = __ballot_sync(kFull, pc != 0);
    if (any == 0u) continue;
    int incl = pc;
#pragma unroll
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o2);
      if (lane >= o2) incl += t;
    }
    const int base = w0 + 32 * wi;
    const unsigned vv[kWalkWords] = {v.x, v.y, v.z, v.w};
    if (cnt == 0) {
      int f = 0;
#pragma unroll
      for (int k = kWalkWords - 1; k >= 0; --k)
        if (vv[k] != 0u) f = base + 32 * k + __ffs(vv[k]) - 1;
      first = __shfl_sync(kFull, f, __ffs(any) - 1);
    }
    if (cnt < S) {
      int slot = cnt + incl - pc;
#pragma unroll
      for (int k = 0; k < kWalkWords; ++k)
        for (unsigned x = vv[k]; x != 0u && slot < S; x &= x - 1u)
          o[slot++] = base + 32 * k + __ffs(x) - 1;
    }
    cnt += __shfl_sync(kFull, incl, 31);
  }
}

// The box bound from c to box t of `box`, skipped (false) at or past r2max or
// when the box's index range misses [w0, w0 + win).
template <bool kGlobal>
__device__ __forceinline__ bool box_needed(const float4* box, int t, float cx, float cy, float cz,
                                           float r2max, int w0, int win) {
  const float4 lo = g4d::load4<kGlobal>(box + 2 * t), hi = g4d::load4<kGlobal>(box + 2 * t + 1);
  const float lb = g4d_sqdist(g4d::box_gap(cx, lo.x, hi.x), g4d::box_gap(cy, lo.y, hi.y),
                              g4d::box_gap(cz, lo.z, hi.z));
  return !(lb >= r2max) && __float_as_int(hi.w) >= w0 && __float_as_int(lo.w) - w0 < win;
}

// One center c (frame row `row` = b * M + m) by one warp over a sorted
// frame (shared memory, or device memory when kGlobal): box = its tile
// boxes, then its super boxes (one per 32 tiles). A lane tests a super box,
// then for each needed one a tile box, then for each needed tile a point;
// hits set bits in the warp's R bitmaps of `words` words (zero on entry and
// on return), walked in index order after each window.
template <int R, bool kGlobal>
__device__ __forceinline__ void query_sorted(const float4* pts, const float4* box, int N,
                                             int tiles, int words, float r2max, float cx,
                                             float cy, float cz, size_t row, unsigned* bits,
                                             const Queries& q) {
  const int lane = threadIdx.x & 31;
  const int win = 32 * words, supers = (tiles + 31) / 32;
  const float4* sup = box + 2 * tiles;
  int cnt[R], first[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cnt[r] = 0;
    first[r] = 0;
  }
  for (int w0 = 0; w0 < N; w0 += win) {
    for (int s0 = 0; s0 < supers; s0 += 32) {
      const bool sneed =
          s0 + lane < supers && box_needed<kGlobal>(sup, s0 + lane, cx, cy, cz, r2max, w0, win);
      for (unsigned sm = __ballot_sync(kFull, sneed); sm != 0u; sm &= sm - 1u) {
        const int t0 = 32 * (s0 + __ffs(sm) - 1);
        const bool need =
            t0 + lane < tiles && box_needed<kGlobal>(box, t0 + lane, cx, cy, cz, r2max, w0, win);
        for (unsigned mask = __ballot_sync(kFull, need); mask != 0u; mask &= mask - 1u) {
          const float4 p = g4d::load4<kGlobal>(pts + (t0 + __ffs(mask) - 1) * kFlatTile + lane);
          const float d = g4d_sqdist(cx - p.x, cy - p.y, cz - p.z);
          const unsigned rel = (unsigned)(__float_as_int(p.w) - w0);  // padding: past the window
          if (rel < (unsigned)win) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (d < q.r2[r]) atomicOr(bits + r * words + (rel >> 5), 1u << (rel & 31u));
          }
        }
      }
    }
    __syncwarp();
    bool full = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      walk_hits(bits + r * words, words, w0, q.nsample[r], q.out[r] + row * q.nsample[r], cnt[r],
                first[r]);
      full = full && cnt[r] >= q.nsample[r];
    }
    __syncwarp();
    if (full) break;
  }
  // tail slots copy the first hit; no hit leaves every slot at 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int* o = q.out[r] + row * q.nsample[r];
    for (int s = cnt[r] + lane; s < q.nsample[r]; s += 32) o[s] = first[r];
  }
}

// The warp's next center of the block's counter (lane 0 takes it).
__device__ __forceinline__ int take_center(int* next) {
  int j = 0;
  if ((threadIdx.x & 31) == 0) j = atomicAdd(next, 1);
  return __shfl_sync(kFull, j, 0);
}

__device__ __forceinline__ void load_center(const float* centers, long long row, float& x, float& y,
                                            float& z) {
  const float* c = centers + row * 3;
  x = __ldg(c);
  y = __ldg(c + 1);
  z = __ldg(c + 2);
}

// A small frame (at most _FLAT_UNSORTED points), a lane per center: block
// (x, b) stages frame b in shared memory in index order (float4) and takes
// its centers x * blockDim.x ... (x + 1) * blockDim.x - 1, one a thread; a
// thread walks the frame's points in index order (a broadcast load while
// the lanes walk together), places each hit at its next slot as it finds
// it, and leaves as soon as its quotas are full. (No box can cull here:
// these tables are FPS samples, spread over the garment in index order, and
// so are a warp's centers.)
template <int R>
__global__ void __launch_bounds__(kLaneThreads)
ball_query_lane_kernel(const float* __restrict__ xyz, const float* __restrict__ centers, int N,
                       int M, Queries q) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const float* p = xyz + (size_t)b * N * 3;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    smem4[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f);
  __syncthreads();
  if (m >= M) return;
  const size_t row = (size_t)b * M + m;
  const float* c = centers + row * 3;
  const float cx = c[0], cy = c[1], cz = c[2];
  int* o[R];
  int cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    o[r] = q.out[r] + row * q.nsample[r];
    cnt[r] = 0;
  }
#pragma unroll 4  // loads of the next points issue before this one's test
  for (int j = 0; j < N; ++j) {
    const float4 t = smem4[j];
    const float d = g4d_sqdist(cx - t.x, cy - t.y, cz - t.z);
    bool full = true;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (d < q.r2[r] && cnt[r] < q.nsample[r]) o[r][cnt[r]++] = j;
      full = full && cnt[r] >= q.nsample[r];
    }
    if (full) break;
  }
  // tail slots copy the first hit; no hit leaves every slot at 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int first = cnt[r] > 0 ? o[r][0] : 0;
    for (int k = cnt[r]; k < q.nsample[r]; ++k) o[r][k] = first;
  }
}

// A sorted frame (the pre-pass's), a warp per center, R radii in one
// distance pass. kStaged: each frame's points and boxes are staged in shared
// memory; else they are read through L1. Dynamic shared memory: the staged
// points (32 tiles float4) and boxes (2 (tiles + supers) float4), then each
// warp's R bitmaps of `words` words.
template <int R, bool kStaged>
__global__ void __launch_bounds__(1024)
ball_query_flat_kernel(const float* __restrict__ centers, const float4* __restrict__ sorted,
                       const float4* __restrict__ boxes, int B, int N, int M, int tiles, int words,
                       Queries q) {
  extern __shared__ float4 smem4[];
  __shared__ int next;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = tiles * kFlatTile, nbox = 2 * (tiles + (tiles + 31) / 32);
  float4* spts = smem4;
  float4* sbox = spts + (kStaged ? rows : 0);
  unsigned* bits =
      reinterpret_cast<unsigned*>(sbox + (kStaged ? nbox : 0)) + (size_t)warp * R * words;
  float r2max = q.r2[0];
#pragma unroll
  for (int r = 1; r < R; ++r) r2max = fmaxf(r2max, q.r2[r]);
  for (int i = lane; i < R * words; i += 32) bits[i] = 0u;  // the walks keep them so

  // the block's centers: a contiguous range of the B x M (frame, center) pairs
  const long long total = (long long)B * M;
  const long long c_end = total * (blockIdx.x + 1) / gridDim.x;
  for (long long c0 = total * blockIdx.x / gridDim.x; c0 < c_end;) {
    const int b = (int)(c0 / M);
    const long long c1 = min(c_end, (long long)(b + 1) * M);
    const float4* pts = spts;
    const float4* box = sbox;
    __syncthreads();  // every warp is done with the previous frame
    if constexpr (kStaged) {
      g4d::stage16(spts, sorted + (size_t)b * rows, rows);
      g4d::stage16(sbox, boxes + (size_t)b * nbox, nbox);
    } else {
      pts = sorted + (size_t)b * rows;
      box = boxes + (size_t)b * nbox;
    }
    if (threadIdx.x == 0) next = 0;
    __syncthreads();
    // a warp takes its next center and loads it while it serves this one
    long long row = c0 + take_center(&next);  // b * M + m
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (row < c1) load_center(centers, row, cx, cy, cz);
    while (row < c1) {
      const long long row_next = c0 + take_center(&next);
      float nx = 0.f, ny = 0.f, nz = 0.f;
      if (row_next < c1) load_center(centers, row_next, nx, ny, nz);
      query_sorted<R, !kStaged>(pts, box, N, tiles, words, r2max, cx, cy, cz, row, bits, q);
      row = row_next;
      cx = nx;
      cy = ny;
      cz = nz;
    }
    c0 = c1;
  }
}

template <int R>
__global__ void __launch_bounds__(kGroupedThreads, 2)
ball_query_grouped_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                          const int* __restrict__ n_valid, int N, int M, int rows,
                          Queries q) {
  extern __shared__ float4 tp[];  // rows [0, n_pad): the frame's rows, far past n_scan
  __shared__ int next;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int n_scan = max(0, min(n_valid[b], N));
  const int n_pad = min(rows, (n_scan + kStep - 1) / kStep * kStep);
  const float* p = xyz + (size_t)b * N * 3;
  const float far = __int_as_float(0x7f800000);  // +inf: never within a radius
  if (threadIdx.x == 0) next = 0;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x)
    tp[i] = i < n_scan ? make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f)
                       : make_float4(far, far, far, 0.f);
  __syncthreads();

  // the block's centers are blockIdx.x + gridDim.x * j, j from the counter
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&next, 1);
    const int m = blockIdx.x + gridDim.x * __shfl_sync(kFull, j, 0);
    if (m >= M) break;
    const float* c = centers + ((size_t)b * M + m) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    int* o[R];
    int cnt[R], first[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o[r] = q.out[r] + ((size_t)b * M + m) * q.nsample[r];
      cnt[r] = 0;
      first[r] = 0;
    }
    // steps of kStep rows, kRows a lane (row base + 32 i + lane); a radius
    // still short of its quota votes whether any of them hits, and only
    // then places its hits, 32 rows at a time in index order
    for (int base = 0; base < n_scan; base += kStep) {
      float d[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int n = base + 32 * i + lane;
        float4 t;
        if (base + kStep <= n_pad) {
          t = tp[n];
        } else if (n < n_scan) {  // past the staged rows (a table larger than the plan's)
          t = make_float4(__ldg(p + 3 * n), __ldg(p + 3 * n + 1), __ldg(p + 3 * n + 2), 0.f);
        } else {
          t = make_float4(far, far, far, 0.f);
        }
        d[i] = g4d_sqdist(cx - t.x, cy - t.y, cz - t.z);
      }
      bool changed = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cnt[r] >= q.nsample[r]) continue;  // warp-uniform
        bool any = false;
#pragma unroll
        for (int i = 0; i < kRows; ++i) any = any || d[i] < q.r2[r];
        if (!__any_sync(kFull, any)) continue;
        changed = true;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const bool hit = d[i] < q.r2[r];
          const unsigned hits = __ballot_sync(kFull, hit);
          if (cnt[r] == 0 && hits) first[r] = base + 32 * i + __ffs(hits) - 1;
          const int slot = cnt[r] + __popc(hits & lower);
          if (hit && slot < q.nsample[r]) o[r][slot] = base + 32 * i + lane;
          cnt[r] += __popc(hits);
        }
      }
      if (changed) {
        bool full = true;
#pragma unroll
        for (int r = 0; r < R; ++r) full = full && cnt[r] >= q.nsample[r];
        if (full) break;
      }
    }
    // tail slots copy the first hit; no hit leaves every slot at 0
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int s = cnt[r] + lane; s < q.nsample[r]; s += 32) o[r][s] = first[r];
  }
}

}  // namespace

// Flat query. xyz (B, N, 3), centers (B, M, 3) f32; R in 1..3 radii (f32
// r^2 r2_i, s_i slots, out_i (B, M, s_i) i32; the rest unused). The launch
// plan (ops/pointcloud.py:_flat_plan): `sort` runs the pre-pass into
// `sorted` (B, 32 tiles, 4) and `boxes` (B, 2 (tiles + supers), 4) f32
// scratch (supers = tiles / 32 rounded up), else frames are tiled in index
// order; `staged` stages each frame in shared memory (else the pre-pass's
// output is read through L1, and `sort` is required); `blocks` blocks of
// `warps` warps; `words` bitmap words a radius and warp where sorted (a
// multiple of 4; windows of 32 x words indices); `smem` dynamic bytes,
// which must hold the layout.
extern "C" int g4d_ball_query(const float* xyz, const float* centers, int B, int N, int M, int R,
                              float r2_0, int s_0, int* out_0, float r2_1, int s_1, int* out_1,
                              float r2_2, int s_2, int* out_2, int sort, int staged, int warps,
                              int words, int blocks, int smem, float4* sorted, float4* boxes,
                              cudaStream_t stream) {
  const int tiles = (N + kFlatTile - 1) / kFlatTile, supers = sort ? (tiles + 31) / 32 : 0;
  const long long layout =
      sort ? (staged ? 16LL * kFlatTile * tiles + 32LL * (tiles + supers) : 0LL) +
                 4LL * warps * R * words
           : 16LL * N;
  if (R < 1 || R > kMaxRadii || N < 0 || warps < 1 || warps > (sort ? 32 : kLaneThreads / 32) ||
      blocks < 1 || (!sort && (!staged || N > kLaneMaxN || B > 65535)) ||
      (sort && (words < kWalkWords || words % kWalkWords || sorted == nullptr ||
                boxes == nullptr)) ||
      smem < layout || (!staged && !sort))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  Queries q = {{r2_0, r2_1, r2_2}, {s_0, s_1, s_2}, {out_0, out_1, out_2}, R};
  if (sort) {
    // the pre-pass sorts in shared memory where the frame fits beside its
    // static counts (16 KB)
    const int sort_smem = 16 * kFlatTile * tiles;
    const bool in_shared = sort_smem <= kSortSmem;
    void (*sorter)(const float*, int, int, float4*, float4*) =
        in_shared ? flat_sort_kernel<true> : flat_sort_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(sorter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           in_shared ? sort_smem : 0);
    if (err != cudaSuccess) return (int)err;
    sorter<<<B, kSortThreads, in_shared ? sort_smem : 0, stream>>>(xyz, N, tiles, sorted, boxes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!sort) {  // `blocks` a frame
    void (*kernel)(const float*, const float*, int, int, Queries) =
        R == 1 ? ball_query_lane_kernel<1>
               : R == 2 ? ball_query_lane_kernel<2> : ball_query_lane_kernel<3>;
    kernel<<<dim3(blocks, B), warps * 32, smem, stream>>>(xyz, centers, N, M, q);
    return (int)cudaGetLastError();
  }
  using Kernel = void (*)(const float*, const float4*, const float4*, int, int, int, int, int,
                          Queries);
  static const Kernel kernels[3][2] = {
      {ball_query_flat_kernel<1, true>, ball_query_flat_kernel<1, false>},
      {ball_query_flat_kernel<2, true>, ball_query_flat_kernel<2, false>},
      {ball_query_flat_kernel<3, true>, ball_query_flat_kernel<3, false>}};
  const Kernel kernel = kernels[R - 1][staged ? 0 : 1];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * 32, smem, stream>>>(centers, sorted, boxes, B, N, M, tiles, words, q);
  return (int)cudaGetLastError();
}

// Grouped query over a compacted table. xyz (B, N, 3), centers (B, M, 3)
// f32, n_valid (B,) i32 on the device: frame b scans rows [0, n_valid[b]).
// R in 1..3 radii; out_i (B, M, s_i) i32 for i < R (the rest unused). The
// launch plan (ops/pointcloud.py:_grouped_plan): `blocks` per frame of
// `warps` warps, `rows` staged rows (a multiple of 128), 16 * rows bytes of
// shared memory.
extern "C" int g4d_ball_query_grouped(const float* xyz, const float* centers,
                                      const int* n_valid, int B, int N, int M,
                                      int R, float r2_0, int s_0, int* out_0,
                                      float r2_1, int s_1, int* out_1,
                                      float r2_2, int s_2, int* out_2,
                                      int blocks, int warps, int rows,
                                      cudaStream_t stream) {
  if (R < 1 || R > kMaxRadii || blocks < 1 || warps < 1 || warps * 32 > kGroupedThreads ||
      rows < 0 ||
      rows % kStep)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  Queries q = {{r2_0, r2_1, r2_2}, {s_0, s_1, s_2}, {out_0, out_1, out_2}, R};
  void (*kernel)(const float*, const float*, const int*, int, int, int, Queries) =
      R == 1 ? ball_query_grouped_kernel<1>
             : R == 2 ? ball_query_grouped_kernel<2> : ball_query_grouped_kernel<3>;
  const int smem = rows * (int)sizeof(float4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(blocks, B), warps * 32, smem, stream>>>(xyz, centers, n_valid, N, M, rows, q);
  return (int)cudaGetLastError();
}
