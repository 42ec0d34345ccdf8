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

// The lower corner and scales of a Morton curve of 2^kBits cells an axis
// over the box bb (lo, hi): scale[a] = 2^kBits / extent, 0 for an empty
// extent.
template <int kBits>
__device__ __forceinline__ void curve_scale(const float* bb, float (&lo)[3], float (&scale)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ext = bb[3 + a] - bb[a];
    lo[a] = bb[a];
    scale[a] = ext > 0.0f ? (float)(1 << kBits) / ext : 0.0f;
  }
}

// The Morton cell of a point on the curve of curve_scale's lo and scale
// (NaN and out-of-box values clamp); with them computed once a block, one
// division per block rather than per point.
template <int kBits>
__device__ __forceinline__ unsigned morton_cell(float x, float y, float z, const float (&lo)[3],
                                                const float (&scale)[3]) {
  const float v[3] = {x, y, z};
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int c = min(max(__float2int_rz((v[a] - lo[a]) * scale[a]), 0), (1 << kBits) - 1);
#pragma unroll
    for (int b = 0; b < kBits; ++b) code |= (((unsigned)c >> b) & 1u) << (3 * b + a);
  }
  return code;
}

// the Morton cell of a point in the box bb on the 8 x 8 x 8 curve
__device__ __forceinline__ unsigned morton_code(float x, float y, float z, const float* bb) {
  float lo[3], scale[3];
  curve_scale<kCellBits>(bb, lo, scale);
  return morton_cell<kCellBits>(x, y, z, lo, scale);
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

// Exclusive scan of hist[C] in place by the whole block (C a multiple of
// blockDim.x): each thread sums its C / blockDim.x consecutive cells, the
// warps scan those sums. Every thread calls it; it ends with a barrier.
template <int C>
__device__ __forceinline__ void scan_cells(int* hist) {
  __shared__ int wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, per = C / blockDim.x;
  int own = 0;
  for (int k = 0; k < per; ++k) own += hist[tid * per + k];
  int s = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0;
    int u = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, u, o);
      if (lane >= o) u += t;
    }
    if (lane < (int)(blockDim.x >> 5)) wsum[lane] = u - v;
  }
  __syncthreads();
  int run = wsum[warp] + s - own;
  for (int k = 0; k < per; ++k) {
    const int v = hist[tid * per + k];
    hist[tid * per + k] = run;
    run += v;
  }
  __syncthreads();
}

// ---- Morton-sorted frames in tiles with boxes (ball_query.cu, three_nn.cu) --
//
// A frame's points sorted along the Morton curve of their bounding box, as
// float4 (x, y, z, the point's index as int bits), in tiles of KT
// consecutive points, each tile with an axis-aligned box: a query skips a
// tile whose box bound (box_gap) rules out every point of it. Padding to
// whole tiles is NaN (within no distance of anything) with index -1.

// n entries from shared memory to device memory, one a thread (coalesced);
// a barrier of the caller's orders them after their writers.
template <class T>
__device__ __forceinline__ void copy_out(T* __restrict__ dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// n4 float4s from device memory into shared memory (both 16-byte aligned)
// by cp.async; a barrier of the caller's makes them visible to the block.
__device__ __forceinline__ void stage16(float4* dst, const float4* __restrict__ src, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(reinterpret_cast<float*>(dst + i), reinterpret_cast<const float*>(src + i));
  cp_async_commit();
  cp_async_wait<0>();
}

// The n points p (n, 3) in Morton order (2^kBits cells an axis) over the
// box bb into dst[0, n), padded with NaN points of index -1 to dst[n,
// padded). With `own_box`, bb (6 floats of shared memory) is first set to
// the points' bounding box (NaN values left out); else it is read as the
// caller set it. hist: 2^(3 kBits) ints of shared memory, a multiple of the
// block's threads; on return hist[c] is where cell c's run begins in dst.
// The order within a cell is free. Every thread of the block calls it; it
// ends with a barrier, after which dst (shared or device memory) is visible
// to the whole block. Up to kSortPPT points a thread stay in registers from
// the first read to the scatter (one latency of device memory); larger
// sets are read again for each pass. `placed(at, cell)` is called for each
// point as it lands at dst[at].
constexpr int kSortPPT = 8;

struct NoPlaced {
  __device__ __forceinline__ void operator()(int, unsigned) const {}
};

template <int kBits, class Placed = NoPlaced>
__device__ __forceinline__ void sort_frame(const float* __restrict__ p, int n, int padded,
                                           float4* dst, int* hist, float (*part)[6], float* bb,
                                           bool own_box, Placed placed = Placed()) {
  constexpr int C = 1 << (3 * kBits);
  const int T = blockDim.x, tid = threadIdx.x;
  for (int i = tid; i < C; i += T) hist[i] = 0;
  if (n <= kSortPPT * T) {
    float x[kSortPPT], y[kSortPPT], z[kSortPPT];
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int k = 0; k < kSortPPT; ++k) {
      const int i = tid + k * T;
      x[k] = i < n ? p[3 * i] : NAN;
      y[k] = i < n ? p[3 * i + 1] : NAN;
      z[k] = i < n ? p[3 * i + 2] : NAN;
      lo[0] = fminf(lo[0], x[k]); hi[0] = fmaxf(hi[0], x[k]);
      lo[1] = fminf(lo[1], y[k]); hi[1] = fmaxf(hi[1], y[k]);
      lo[2] = fminf(lo[2], z[k]); hi[2] = fmaxf(hi[2], z[k]);
    }
    if (own_box)
      block_bbox(lo, hi, part, bb);  // its barriers also order the zeroed counts
    else
      __syncthreads();
    float base[3], scale[3];
    curve_scale<kBits>(bb, base, scale);
    unsigned code[kSortPPT];
    int rank[kSortPPT];
#pragma unroll
    for (int k = 0; k < kSortPPT; ++k) {
      code[k] = morton_cell<kBits>(x[k], y[k], z[k], base, scale);
      if (tid + k * T < n) rank[k] = atomicAdd(&hist[code[k]], 1);
    }
    __syncthreads();
    scan_cells<C>(hist);
#pragma unroll
    for (int k = 0; k < kSortPPT; ++k) {
      const int i = tid + k * T;
      if (i < n) {
        const int at = hist[code[k]] + rank[k];
        dst[at] = make_float4(x[k], y[k], z[k], __int_as_float(i));
        placed(at, code[k]);
      }
    }
  } else {
    if (own_box) {
      float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
      for (int i = tid; i < n; i += T) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], p[3 * i + a]);
          hi[a] = fmaxf(hi[a], p[3 * i + a]);
        }
      }
      block_bbox(lo, hi, part, bb);
    } else {
      __syncthreads();
    }
    float base[3], scale[3];
    curve_scale<kBits>(bb, base, scale);
    for (int i = tid; i < n; i += T)
      atomicAdd(&hist[morton_cell<kBits>(p[3 * i], p[3 * i + 1], p[3 * i + 2], base, scale)], 1);
    __syncthreads();
    scan_cells<C>(hist);
    for (int i = tid; i < n; i += T) {
      const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      const unsigned code = morton_cell<kBits>(x, y, z, base, scale);
      const int at = atomicAdd(&hist[code], 1);
      dst[at] = make_float4(x, y, z, __int_as_float(i));
      placed(at, code);
    }
    // hist[c] now ends cell c's run: take its points off again
    __syncthreads();
    for (int i = tid; i < n; i += T)
      atomicSub(&hist[morton_cell<kBits>(p[3 * i], p[3 * i + 1], p[3 * i + 2], base, scale)], 1);
  }
  for (int i = n + tid; i < padded; i += T) dst[i] = make_float4(NAN, NAN, NAN, __int_as_float(-1));
  __syncthreads();
}

// The box of each group of KT consecutive entries of `in` (KT a power of
// two up to 32; shared or device memory) into out[2 g] = (lowest x, y, z,
// lowest index), out[2 g + 1] = (highest x, y, z, highest index). With
// kPoints the n entries are points as sort_frame writes them (NaN
// coordinates and the padding's index -1 left out); else boxes of that
// layout (in[2 j], in[2 j + 1]). A group of no point gets lo = +inf, hi =
// -inf (every bound to it is +inf) and the index range (-1, -1). A warp
// step reduces 32 / KT groups, four steps' loads issued together.
template <int KT, bool kPoints>
__device__ __forceinline__ void group_boxes(const float4* in, int n, float4* out) {
  static_assert(KT >= 1 && KT <= 32 && (KT & (KT - 1)) == 0, "KT: a power of two up to 32");
  constexpr int kPer = 32 / KT, kUnroll = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = (blockDim.x >> 5) * kPer, groups = (n + KT - 1) / KT;
  const float4 none_lo = make_float4(INFINITY, INFINITY, INFINITY, __int_as_float(-1));
  const float4 none_hi = make_float4(-INFINITY, -INFINITY, -INFINITY, __int_as_float(-1));
  for (int g0 = warp * kPer; g0 < groups; g0 += kUnroll * stride) {
    float4 lv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (g0 + u * stride + lane / KT) * KT + (lane & (KT - 1));
      lv[u] = none_lo;
      hv[u] = none_hi;
      if (j < n) {
        if constexpr (kPoints) {
          lv[u] = hv[u] = in[j];
        } else {
          lv[u] = in[2 * j];
          hv[u] = in[2 * j + 1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int g = g0 + u * stride + lane / KT;
      float lo[3] = {fminf(lv[u].x, INFINITY), fminf(lv[u].y, INFINITY), fminf(lv[u].z, INFINITY)};
      float hi[3] = {fmaxf(hv[u].x, -INFINITY), fmaxf(hv[u].y, -INFINITY),
                     fmaxf(hv[u].z, -INFINITY)};
      unsigned imin = (unsigned)__float_as_int(lv[u].w);  // -1 (none) is the largest
      int imax = __float_as_int(hv[u].w);
#pragma unroll
      for (int o = KT / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
          hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
        }
        imin = min(imin, __shfl_xor_sync(0xffffffffu, imin, o));
        imax = max(imax, __shfl_xor_sync(0xffffffffu, imax, o));
      }
      if ((lane & (KT - 1)) == 0 && g < groups) {
        out[2 * g] = make_float4(lo[0], lo[1], lo[2], __int_as_float((int)imin));
        out[2 * g + 1] = make_float4(hi[0], hi[1], hi[2], __int_as_float(imax));
      }
    }
  }
}

// The box of each tile of KT points of a sorted frame (tiles x KT float4,
// padded as sort_frame pads them) into box[2 t], box[2 t + 1].
template <int KT>
__device__ __forceinline__ void tile_boxes(const float4* pts, int tiles, float4* box) {
  group_boxes<KT, true>(pts, tiles * KT, box);
}

// The gap along one axis between the intervals [wl, wh] and [lo, hi], each
// difference rounded as g4d_sqdist's, NaN when a bound is NaN. For q in
// [wl, wh] and p in [lo, hi], |fl(q - p)| >= the gap (box_gap's argument on
// both ends), so g4d_sqdist of the three gaps bounds every pair's distance.
__device__ __forceinline__ float interval_gap(float wl, float wh, float lo, float hi) {
  return max_nan(max_nan(__fsub_rn(lo, wh), __fsub_rn(wl, hi)), 0.0f);
}

// The K nearest (squared distance, index) pairs seen so far, ascending in
// (distance, index) order: ties go to the lower index whatever the order in
// which points arrive. A NaN distance is never taken; until K points arrive
// the open slots hold (+inf, 0).
template <int K>
struct Nearest {
  float d[K];
  int i[K];

  __device__ __forceinline__ Nearest() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = INFINITY;
      i[s] = 0;
    }
  }

  // the K-th distance: a point farther than it cannot enter
  __device__ __forceinline__ float bound() const { return d[K - 1]; }

  // insert for points arriving in ascending index: a strict < keeps the
  // lower index on ties
  __device__ __forceinline__ void insert_ascending(float x, int j) {
    if (!(x < d[K - 1])) return;
    bool placed = false;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (placed) continue;
      if (x < d[s - 1]) {
        d[s] = d[s - 1];
        i[s] = i[s - 1];
      } else {
        d[s] = x;
        i[s] = j;
        placed = true;
      }
    }
    if (!placed) {
      d[0] = x;
      i[0] = j;
    }
  }

  __device__ __forceinline__ void insert(float x, int j) {
    if (!(x < d[K - 1] || (x == d[K - 1] && j < i[K - 1]))) return;
    bool placed = false;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (placed) continue;
      if (x < d[s - 1] || (x == d[s - 1] && j < i[s - 1])) {
        d[s] = d[s - 1];
        i[s] = i[s - 1];
      } else {
        d[s] = x;
        i[s] = j;
        placed = true;
      }
    }
    if (!placed) {
      d[0] = x;
      i[0] = j;
    }
  }
};

// A float4 of a sorted frame or its boxes, from shared memory or (kGlobal)
// through the read-only L1 path.
template <bool kGlobal>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kGlobal) return __ldg(p);
  return *p;
}

// One warp's walk for its lanes' K nearest over a sorted frame's tiles of KT
// points (pts, their boxes box): each lane owns the query q (when `active`)
// and has already taken the points of its tile `own` (the tile at its
// place on the curve, so its bound starts near its final value). The warp
// visits the tiles from `start` on, wrapping around. Every 32 tiles it
// tests their boxes against the box of its active queries and the largest
// K-th distance of its lanes, then each remaining tile against each lane's
// own bound: a lane needs a tile unless its bound is strictly below the
// tile's box bound (a point at exactly the bound with a lower index still
// enters; a NaN bound never skips), and the warp visits the tile, a point
// at a time as broadcasts, when a lane needs it.
template <int KT, int K, bool kGlobal>
__device__ __forceinline__ void nearest_walk(const float4* pts, const float4* box, int tiles,
                                             int start, int own, float qx, float qy, float qz,
                                             bool active, Nearest<K>& best) {
  const int lane = threadIdx.x & 31;
  const float wl[3] = {warp_min(active ? qx : INFINITY), warp_min(active ? qy : INFINITY),
                       warp_min(active ? qz : INFINITY)};
  const float wh[3] = {warp_max(active ? qx : -INFINITY), warp_max(active ? qy : -INFINITY),
                       warp_max(active ? qz : -INFINITY)};
  for (int k0 = 0; k0 < tiles; k0 += 32) {
    const float top = warp_max(active ? best.bound() : -INFINITY);
    bool cand = false;
    if (k0 + lane < tiles) {
      int t = start + k0 + lane;
      if (t >= tiles) t -= tiles;
      const float4 lo = load4<kGlobal>(box + 2 * t), hi = load4<kGlobal>(box + 2 * t + 1);
      const float g = g4d_sqdist(interval_gap(wl[0], wh[0], lo.x, hi.x),
                                 interval_gap(wl[1], wh[1], lo.y, hi.y),
                                 interval_gap(wl[2], wh[2], lo.z, hi.z));
      cand = !(g > top);
    }
    for (unsigned c = __ballot_sync(0xffffffffu, cand); c != 0u; c &= c - 1u) {
      int t = start + k0 + __ffs(c) - 1;
      if (t >= tiles) t -= tiles;
      const float4 lo = load4<kGlobal>(box + 2 * t), hi = load4<kGlobal>(box + 2 * t + 1);
      const float lb = g4d_sqdist(box_gap(qx, lo.x, hi.x), box_gap(qy, lo.y, hi.y),
                                  box_gap(qz, lo.z, hi.z));
      const bool need = active && t != own && !(lb > best.bound());
      if (!__any_sync(0xffffffffu, need)) continue;
      const float4* tp = pts + t * KT;
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 p = load4<kGlobal>(tp + j);
        const float d = g4d_sqdist(qx - p.x, qy - p.y, qz - p.z);
        if (need) best.insert(d, __float_as_int(p.w));
      }
    }
  }
}

// ---- the K nearest known points of each query (three_nn.cu, nn1.cu) --------
//
// A search for each query's K nearest known points of its frame, as squared
// g4d_sqdist distances ascending in (d^2, index) order: a NaN distance (a
// NaN query or known point) is never taken, and a slot that no point takes
// holds (+inf, 0) (Nearest). Known sets of the plan's size or less are
// scanned whole, a lane per query in index order; larger ones are sorted
// first (nearest_sort), and each lane walks the culled tiles from its own
// (nearest_walk). Each source instantiates these bodies in kernels of its
// own name and launches them through launch_nearest.
constexpr int kNearestTile = 8;            // known points a box (the model's best cull)
constexpr int kNearestSortThreads = 1024;  // the pre-pass: a block a frame
constexpr int kNearestSortBits = 4;        // its curve: 16 cells an axis
constexpr int kNearestSortSmem = 190 * 1024;  // its dynamic shared memory at most

// The pre-pass for frame blockIdx.x: its known points into sorted_k (B,
// KT tiles) float4, NaN-padded, and their tile boxes into boxes (B, 2
// tiles); its queries in curve order into sorted_q (B, n) float4 (x, y, z,
// index bits) and each one's own tile into own (B, n). kShared: both are
// sorted in shared memory (16 (KT tiles + n) + 4 n dynamic bytes) and
// copied out coalesced (scattered stores to device memory from one SM
// would cost more than the sort); else in place.
template <int KT, bool kShared>
__device__ __forceinline__ void nearest_sort(const float* __restrict__ unknown,
                                             const float* __restrict__ known, int n, int m,
                                             int tiles, float4* __restrict__ sorted_k,
                                             float4* __restrict__ boxes,
                                             float4* __restrict__ sorted_q, int* __restrict__ own) {
  extern __shared__ float4 smem4[];
  __shared__ int hist_k[1 << (3 * kNearestSortBits)];
  __shared__ int hist_q[1 << (3 * kNearestSortBits)];
  __shared__ float part[32][6];
  __shared__ float bb[6];
  const size_t b = blockIdx.x;
  const int rows = tiles * KT;
  float4* kd = kShared ? smem4 : sorted_k + b * rows;
  float4* qd = kShared ? smem4 + rows : sorted_q + b * n;
  int* qo = kShared ? reinterpret_cast<int*>(smem4 + rows + n) : own + b * n;
  sort_frame<kNearestSortBits>(known + b * m * 3, m, rows, kd, hist_k, part, bb, true);
  tile_boxes<KT>(kd, tiles, boxes + b * 2 * tiles);
  // the queries on the known points' curve; each one's own tile: where its
  // cell's run of known points begins
  const int* starts = hist_k;
  sort_frame<kNearestSortBits>(unknown + b * n * 3, n, n, qd, hist_q, part, bb, false,
                               [=](int at, unsigned cell) {
                                 qo[at] = min(starts[cell] / KT, tiles - 1);
                               });
  if (kShared) {
    copy_out(sorted_k + b * rows, kd, rows);
    copy_out(sorted_q + b * n, qd, n);
    copy_out(own + b * n, qo, n);
  }
}

// A lane per query, its K nearest into dist2 and idx (B, n, K). kSorted:
// the pre-pass's sorted queries, each walking the culled tiles from its
// own; else the frame's queries in index order, each scanning every known
// point in index order (a broadcast load a point). Dynamic shared memory
// (kStaged): the frame's known points (KT tiles float4: the pre-pass's, or
// staged from `known` in index order), then, sorted, their boxes (2
// tiles).
template <int KT, int K, bool kStaged, bool kSorted>
__device__ __forceinline__ void nearest_query(const float* __restrict__ unknown,
                                              const float* __restrict__ known, int m,
                                              const float4* __restrict__ sorted_k,
                                              const float4* __restrict__ boxes,
                                              const float4* __restrict__ sorted_q,
                                              const int* __restrict__ own, int n, int tiles,
                                              float* __restrict__ dist2, int* __restrict__ idx) {
  static_assert(kStaged || kSorted, "known points read through L1 are the pre-pass's");
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const float4* pts = sorted_k + (size_t)b * tiles * KT;
  const float4* box = boxes + (size_t)b * 2 * tiles;
  if constexpr (kStaged) {
    float4* spts = smem4;
    if constexpr (kSorted) {
      stage16(spts, pts, tiles * KT);
      stage16(smem4 + tiles * KT, box, 2 * tiles);
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
  Nearest<K> best;
  if constexpr (kSorted) {
    int mine = 0;
    if (active) {
      q = sorted_q[(size_t)b * n + i];
      mine = own[(size_t)b * n + i];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const float4 p = load4<!kStaged>(pts + mine * KT + j);
        best.insert(g4d_sqdist(q.x - p.x, q.y - p.y, q.z - p.z), __float_as_int(p.w));
      }
    }
    nearest_walk<KT, K, !kStaged>(pts, box, tiles, __shfl_sync(0xffffffffu, mine, 0), mine,
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
  const size_t o = ((size_t)b * n + __float_as_int(q.w)) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    dist2[o + s] = best.d[s];
    idx[o + s] = best.i[s];
  }
}

// The kernels of one source's search: its pre-pass (sorting in shared
// memory or in place) and its three query instances (staged and sorted,
// staged and scanned, sorted and read through L1).
using NearestSort = void (*)(const float*, const float*, int, int, int, float4*, float4*,
                             float4*, int*);
using NearestQuery = void (*)(const float*, const float*, int, const float4*, const float4*,
                              const float4*, const int*, int, int, float*, int*);
struct NearestKernels {
  NearestSort sort_shared, sort_in_place;
  NearestQuery staged_sorted, staged_scan, sorted_l1;
};

// The C entries' body: unknown (B, n, 3), known (B, m, 3) f32 -> dist2 and
// idx (B, n, K); m >= K. The launch plan (ops/pointcloud.py:
// _three_nn_plan, _nn1_plan): `tile` known points a box (kNearestTile);
// `sort` runs the pre-pass and the culled walk (else every query scans
// every known point in index order); blocks of `warps` warps over each
// frame's queries; `staged` known points in shared memory (`smem` dynamic
// bytes, which must hold them and, sorted, their boxes; else read through
// L1, and `sort` is required). Scratch for the pre-pass: sorted_k (B, tile
// x tiles, 4) and boxes (B, 2 tiles, 4) f32, sorted_q (B, n, 4) f32, own
// (B, n) i32.
static inline int launch_nearest(const NearestKernels& k, int K, const float* unknown,
                                 const float* known, int B, int n, int m, int tile, int sort,
                                 int warps, int staged, int smem, float4* sorted_k,
                                 float4* boxes, float4* sorted_q, int* own, float* dist2,
                                 int* idx, cudaStream_t stream) {
  const int tiles = (m + kNearestTile - 1) / kNearestTile;
  if (m < K || n < 0 || B < 0 || B > 65535 || tile != kNearestTile || warps < 1 ||
      warps > 32 || smem < (staged ? 16 * (tile + (sort ? 2 : 0)) * tiles : 0) ||
      (!staged && !sort) ||
      (sort && (sorted_k == nullptr || boxes == nullptr || sorted_q == nullptr || own == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  if (sort) {
    // the pre-pass sorts in shared memory where both sets fit beside its
    // static counts (32 KB)
    const long long sort_smem = 16LL * (tile * tiles + n) + 4LL * n;
    const bool in_shared = sort_smem <= kNearestSortSmem;
    const NearestSort sorter = in_shared ? k.sort_shared : k.sort_in_place;
    const int bytes = in_shared ? (int)sort_smem : 0;
    cudaError_t err = cudaFuncSetAttribute(sorter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bytes);
    if (err != cudaSuccess) return (int)err;
    sorter<<<B, kNearestSortThreads, bytes, stream>>>(unknown, known, n, m, tiles, sorted_k,
                                                      boxes, sorted_q, own);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const NearestQuery kernel = staged ? (sort ? k.staged_sorted : k.staged_scan) : k.sorted_l1;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = warps * 32;
  kernel<<<dim3(g4d_blocks(n, threads), B), threads, smem, stream>>>(
      unknown, known, m, sorted_k, boxes, sorted_q, own, n, tiles, dist2, idx);
  return (int)cudaGetLastError();
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
