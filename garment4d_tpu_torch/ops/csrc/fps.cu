// Furthest point sampling, one block, or one cluster of blocks, per point set.
//
// Replaces garment4d_tpu/ops/pallas/fps.py:fps_pallas (pallas_call at :75).
// Semantics: start at index 0, running min-distance initialised to 1e10,
// next point = argmax of the running min-distance, ties to the lowest index
// (a NaN running distance counts as the largest, as torch.argmax has it).
//
// What bounds it on the H100: the npoint-1 steps are sequential, and each
// ends in an argmax over the frame that the next one needs, so a step's
// latency sets the time, not FLOPs or bytes: a distance pass over the
// frame (~11 instructions a point on one SM's 128 lanes: 6890 points take
// ~600 issue cycles), then the reduction chain. The design keeps both short:
// - thread t owns points t, t+T, t+2T, ... (PPT of them, a template
//   parameter); their coordinates and running min-distances stay in
//   registers, so a step's distance pass touches no shared memory.
// - a running min-distance is >= 0 (or NaN), so its float bits order as
//   unsigned integers: a thread keeps (bits, index) of its best with a
//   strict > in ascending index order (ties to the lower index), a warp
//   reduces with two redux.sync (the max bits, then the lowest index among
//   lanes holding them), and writes one key into a slot array of its step's
//   parity. One __syncthreads later every warp reduces all the slots itself:
//   no second barrier, no serial pass. The two parities keep a fast warp's
//   next write off a slot that a slow warp may still read. A one-warp block
//   needs no barrier at all.
// - the frame is staged in shared memory as three planes (12 x N bytes), so
//   the winner's coordinates are three broadcast loads.
// Padding slots (indices >= N) hold point 0's coordinates: their running
// distance is point 0's, 0 after the first step, so they never win (where
// every distance is 0, point 0's lower index takes the tie).
//
// Sets of 8 points a thread (4096 < N <= 8192: sa1's 6890) take
// fps_far_kernel below, whose warps skip the steps whose new point is far
// from all of their points. Larger sets, up to 8 blocks x 16384 points,
// take fps_cluster_kernel: the frame split over a thread-block cluster,
// each block's slice on chip, one exchange through distributed shared
// memory a step. Sets past that take fps_wide_kernel: one block a frame,
// the coordinates read through L1/L2 every step and the running distances
// kept in device memory.
//
// npoint may exceed N: the loop runs on with the same rule. Once every
// running distance is 0 (every point taken) each step's argmax is index 0,
// as in the plain version and the JAX package.
#include <array>
#include <climits>
#include <mutex>
#include <set>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

// A step's argmax, as (running-distance bits, index) keys: the warp's
// largest bits and the lowest index among the lanes holding them.
__device__ __forceinline__ uint2 warp_best(unsigned bits, unsigned index) {
  const unsigned wbest = __reduce_max_sync(0xffffffffu, bits);
  return make_uint2(wbest, __reduce_min_sync(0xffffffffu, bits == wbest ? index : UINT_MAX));
}

// The block's winning index from each warp's key: lane 0 writes it into
// `slots` (the step parity's array), then after the step's one barrier
// every warp reduces all of them itself.
__device__ __forceinline__ unsigned block_best(uint2 key, uint2* slots, int n_warps) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) slots[threadIdx.x >> 5] = key;
  __syncthreads();
  const uint2 s = lane < n_warps ? slots[lane] : make_uint2(0u, UINT_MAX);
  return warp_best(s.x, s.y).y;
}

template <int PPT>
__global__ void __launch_bounds__(1024)
fps_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ uint2 slots[2][32];  // per step parity and warp: (bits, index)

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n_warps = T >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int i = tid; i < N; i += T) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  float x[PPT], y[PPT], z[PPT], mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * T < N ? tid + k * T : 0;
    x[k] = sx[i];
    y[k] = sy[i];
    z[k] = sz[i];
    mind[k] = 1e10f;
  }

  float lx = sx[0], ly = sy[0], lz = sz[0];
  for (int j = 1; j < npoint; ++j) {
    unsigned best = 0u;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float m = g4d::min_nan(mind[k], g4d_sqdist(x[k] - lx, y[k] - ly, z[k] - lz));
      mind[k] = m;
      const unsigned u = __float_as_uint(m);
      if (u > best) {  // strict: the lower index of this thread wins ties
        best = u;
        bk = k;
      }
    }
    const uint2 key = warp_best(best, (unsigned)(tid + bk * T));
    const unsigned win = n_warps > 1 ? block_best(key, slots[j & 1], n_warps) : key.y;
    if (tid == 0) o[j] = (int)win;
    lx = sx[win];
    ly = sy[win];
    lz = sz[win];
  }
}

// fps_kernel for sets of 8 points a thread (4096 < N <= 8192, the frames of
// sa1), where most of a step's points lie far from its new point: the block
// first orders the frame along a Morton curve (common.cuh) and warp w takes
// the run of 32 x PPT points from 32 x PPT x w, lane l its points l, l+32,
// ... of the run, sorted by index within the thread; a warp skips its
// distance pass when the box around its points is no closer to the new
// point than its largest running distance (then none of them can drop, and
// its lanes' keys stand). Exact as coverage.cu's cull: the bound is formed
// like the distance, so it is <= every point's fp32 distance; a NaN new
// point or a NaN running distance never skips. Padding copies the run's
// first point with index UINT_MAX (equal distances, never the lowest index).
// Shared memory: the sorted frame as float4 (x, y, z, index bits), whose
// first kCodes ints hold the sort's counts before it is written; after the
// lanes took their points, the frame in index order as three planes.
template <int PPT>
__global__ void __launch_bounds__(1024)
fps_far_kernel(const float* __restrict__ xyz, int N, int npoint, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* spts = smem4;
  int* hist = reinterpret_cast<int*>(smem4);
  float* sx = reinterpret_cast<float*>(smem4);
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ uint2 slots[2][32];  // per step parity and warp: (bits, index)
  __shared__ float4 sbox[32][2];  // per warp: the box around its points
  __shared__ float part[32][6];
  __shared__ float bb[6];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  int* o = out + (size_t)blockIdx.x * npoint;

  float x[PPT], y[PPT], z[PPT];
  unsigned idx[PPT];
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * T;
    const int s = i < N ? i : 0;
    x[k] = p[3 * s];
    y[k] = p[3 * s + 1];
    z[k] = p[3 * s + 2];
    idx[k] = (unsigned)i;
    if (i < N) {
      lo[0] = fminf(lo[0], x[k]); hi[0] = fmaxf(hi[0], x[k]);
      lo[1] = fminf(lo[1], y[k]); hi[1] = fmaxf(hi[1], y[k]);
      lo[2] = fminf(lo[2], z[k]); hi[2] = fmaxf(hi[2], z[k]);
    }
  }
  for (int i = tid; i < g4d::kCodes; i += T) hist[i] = 0;
  g4d::block_bbox(lo, hi, part, bb);
  // counting sort along the curve; the order within a cell is free
  int pos[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (idx[k] < (unsigned)N) pos[k] = atomicAdd(&hist[g4d::morton_code(x[k], y[k], z[k], bb)], 1);
  __syncthreads();
  g4d::scan_codes(hist);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (idx[k] < (unsigned)N) pos[k] += hist[g4d::morton_code(x[k], y[k], z[k], bb)];
  __syncthreads();  // every offset read before the points overwrite the counts
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (idx[k] < (unsigned)N) spts[pos[k]] = make_float4(x[k], y[k], z[k], __uint_as_float(idx[k]));
  __syncthreads();
  const int run = warp * 32 * PPT;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int q = run + 32 * k + lane;
    const float4 v = spts[q < N ? q : run];
    x[k] = v.x;
    y[k] = v.y;
    z[k] = v.z;
    idx[k] = q < N ? __float_as_uint(v.w) : UINT_MAX;
  }
  // each thread's points in ascending index (odd-even transposition), so
  // that a strict > keeps ties on the lowest index
#pragma unroll
  for (int r = 0; r < PPT; ++r) {
#pragma unroll
    for (int k = r & 1; k + 1 < PPT; k += 2) {
      const bool swap = idx[k] > idx[k + 1];
      const float tx = x[k], ty = y[k], tz = z[k];
      const unsigned ti = idx[k];
      x[k] = swap ? x[k + 1] : tx;
      y[k] = swap ? y[k + 1] : ty;
      z[k] = swap ? z[k + 1] : tz;
      idx[k] = swap ? idx[k + 1] : ti;
      x[k + 1] = swap ? tx : x[k + 1];
      y[k + 1] = swap ? ty : y[k + 1];
      z[k + 1] = swap ? tz : z[k + 1];
      idx[k + 1] = swap ? ti : idx[k + 1];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = INFINITY;
    hi[a] = -INFINITY;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    lo[0] = fminf(lo[0], x[k]); hi[0] = fmaxf(hi[0], x[k]);
    lo[1] = fminf(lo[1], y[k]); hi[1] = fmaxf(hi[1], y[k]);
    lo[2] = fminf(lo[2], z[k]); hi[2] = fmaxf(hi[2], z[k]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = g4d::warp_min(lo[a]);
    hi[a] = g4d::warp_max(hi[a]);
  }
  if (lane == 0) {
    sbox[warp][0] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    sbox[warp][1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
  __syncthreads();  // the sorted frame read: its space takes the planes
  for (int i = tid; i < N; i += T) {
    sx[i] = p[3 * i];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  if (tid == 0) o[0] = 0;
  __syncthreads();

  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) mind[k] = 1e10f;
  float lx = sx[0], ly = sy[0], lz = sz[0];
  unsigned best = 0u, bi = 0u, wbest = 0u;  // the lane's best key, the warp's best bits
  for (int j = 1; j < npoint; ++j) {
    bool skip = false;
    if (j > 1) {
      const float4 blo = sbox[warp][0], bhi = sbox[warp][1];
      const float lb = g4d_sqdist(g4d::box_gap(lx, blo.x, bhi.x), g4d::box_gap(ly, blo.y, bhi.y),
                                  g4d::box_gap(lz, blo.z, bhi.z));
      skip = __all_sync(0xffffffffu, lb >= __uint_as_float(wbest));  // false for a NaN
    }
    if (!skip) {
      best = 0u;
      bi = 0u;  // point 0: its running distance is 0 from the first step, so a
                // lane whose distances are all 0 reports the block's tie winner
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float m = g4d::min_nan(mind[k], g4d_sqdist(x[k] - lx, y[k] - ly, z[k] - lz));
        mind[k] = m;
        const unsigned u = __float_as_uint(m);
        if (u > best) {  // strict: ascending indices keep ties on the lowest
          best = u;
          bi = idx[k];
        }
      }
    }
    const uint2 key = warp_best(best, bi);
    wbest = key.x;
    const unsigned win = block_best(key, slots[j & 1], n_warps);
    if (tid == 0) o[j] = (int)win;
    lx = sx[win];
    ly = sy[win];
    lz = sz[win];
  }
}

// Sets past one block's 8192 points in registers, up to 8 x 16384 points:
// one cluster of C blocks a frame (C = 4 or 8, from _fps_plan,
// launched with cudaLaunchKernelEx and the cluster dimension). Block r owns
// the slice [r S, min((r + 1) S, N)), S = ceil(N / C), staged as three
// planes in its shared memory; thread t owns slice points t, t + T, ... in
// ascending index, their coordinates in registers (kRegs: 16 a thread,
// slices of at most 8192 points) or read from the planes each step (32 a
// thread, slices up to 16384 points), their running distances in
// registers. No device memory lies inside the step loop.
// A step: the block reduces its key as fps_kernel does (warp_best, a slot
// a warp, one __syncthreads, every warp reduces the slots); then lanes
// 0..C-1 of warp 0 send the block's key and its point's coordinates (read
// from the planes) to block `lane` of the cluster, slot [parity][rank],
// with st.async through distributed shared memory, each store counting its
// bytes on the receiver's mbarrier of that parity (expecting C slots, set
// by its thread 0 at the step's start). Every thread waits on its own
// block's mbarrier, then every warp reduces the C slots: every block picks
// the same winner and already holds its coordinates, with no load from a
// peer or from L2 on the step's critical path. So the step's one wait
// across the cluster is on data that has arrived, not a barrier.cluster:
// its arrive.release / wait.acquire pair measured slower, and a slot per
// warp rather than per block made every warp reduce C x n_warps slots
// (PERF.md). Two parities suffice: a peer sends step j + 2's key only
// after it received this block's step j + 1 key, which warp 0 sends after
// the step's __syncthreads, so after every warp here read step j's slots;
// the mbarrier's step-j phase completed before any step j + 2 byte can
// arrive. A byte may arrive before thread 0 sets the phase's expected
// count: its transaction count then runs below 0 for a while, and the
// phase cannot complete before thread 0's arrival.
// What bounds it: the step's latency, the distance pass over the slice on
// one SM plus the block reduction and one store and wait across the
// cluster. More blocks a frame shorten the pass, not the exchange, so
// _fps_plan takes the largest cluster whose blocks all fit on the SMs at
// once or keep a slice worth their exchange.
// Padding slots (slice points past the slice's length) copy the slice's
// first point with index UINT_MAX: equal distances, never the lower index.
// A thread whose distances are all 0 reports its first (lowest) index, so
// the all-equal and past-N steps take index 0.
constexpr int kMaxCluster = 8;
constexpr int kClusterThreads = 512;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int PPT, bool kRegs>
__global__ void __launch_bounds__(kClusterThreads)
fps_cluster_kernel(const float* __restrict__ xyz, int N, int npoint, int S,
                   int* __restrict__ out) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  __shared__ uint2 wkey[2][kClusterThreads / 32];  // per parity and warp: (bits, index)
  __shared__ uint2 ckey[2][kMaxCluster];           // per parity and rank: the block's key
  __shared__ float4 cxyz[2][kMaxCluster];          // its point's coordinates
  __shared__ __align__(8) unsigned long long arrived[2];  // per parity: the C slots

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int lo = rank * S;
  const int len = min(S, N - lo);  // >= 1, checked in the entry
  float* sx = smem;
  float* sy = sx + S;
  float* sz = sy + S;
  const float* p = xyz + (size_t)(blockIdx.x / C) * N * 3;
  int* o = out + (size_t)(blockIdx.x / C) * npoint;
  for (int i = tid; i < len; i += T) {
    sx[i] = p[3 * (lo + i)];
    sy[i] = p[3 * (lo + i) + 1];
    sz[i] = p[3 * (lo + i) + 2];
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&arrived[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&arrived[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the planes staged, the mbarriers set, and every block of the cluster
  // running before the first remote store
  cluster.sync();

  float x[kRegs ? PPT : 1], y[kRegs ? PPT : 1], z[kRegs ? PPT : 1];
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if constexpr (kRegs) {
      const int i = tid + k * T < len ? tid + k * T : 0;
      x[k] = sx[i];
      y[k] = sy[i];
      z[k] = sz[i];
    }
    mind[k] = 1e10f;
  }
  const unsigned slot_bytes = (unsigned)(C * (sizeof(uint2) + sizeof(float4)));

  float lx = p[0], ly = p[1], lz = p[2];
  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    const unsigned bar = smem_addr(&arrived[par]);
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(slot_bytes) : "memory");
    unsigned best = 0u;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float px, py, pz;
      if constexpr (kRegs) {
        px = x[k];
        py = y[k];
        pz = z[k];
      } else {
        const int i = tid + k * T < len ? tid + k * T : 0;
        px = sx[i];
        py = sy[i];
        pz = sz[i];
      }
      const float m = g4d::min_nan(mind[k], g4d_sqdist(px - lx, py - ly, pz - lz));
      mind[k] = m;
      const unsigned u = __float_as_uint(m);
      if (u > best) {  // strict: the lower index of this thread wins ties
        best = u;
        bk = k;
      }
    }
    const int i = tid + bk * T;
    const uint2 key = warp_best(best, i < len ? (unsigned)(lo + i) : UINT_MAX);
    if (lane == 0) wkey[par][warp] = key;
    __syncthreads();
    const uint2 wk = lane < n_warps ? wkey[par][lane] : make_uint2(0u, UINT_MAX);
    const uint2 bkey = warp_best(wk.x, wk.y);
    if (warp == 0 && lane < C) {
      // a padding key's coordinates: the slice's first point, which it copies
      const unsigned off = bkey.y - (unsigned)lo < (unsigned)len ? bkey.y - (unsigned)lo : 0u;
      unsigned rbar, rkey, rxyz;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(bar), "r"(lane));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(rkey) : "r"(smem_addr(&ckey[par][rank])), "r"(lane));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(rxyz) : "r"(smem_addr(&cxyz[par][rank])), "r"(lane));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
          ::"r"(rkey), "r"(bkey.x), "r"(bkey.y), "r"(rbar) : "memory");
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
          "[%5];" ::"r"(rxyz), "f"(sx[off]), "f"(sy[off]), "f"(sz[off]), "f"(0.0f), "r"(rbar)
          : "memory");
    }
    // this step's phase of the parity's mbarrier: its ((j - 1) / 2)-th
    const unsigned phase = (unsigned)((j - 1) >> 1) & 1u;
    unsigned done = 0u;
    do {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar), "r"(phase) : "memory");
    } while (!done);
    const uint2 ck = lane < C ? ckey[par][lane] : make_uint2(0u, UINT_MAX);
    const uint2 win = warp_best(ck.x, ck.y);
    const int src = __ffs(__ballot_sync(0xffffffffu, ck.x == win.x && ck.y == win.y)) - 1;
    const float4 c = cxyz[par][src];
    if (rank == 0 && tid == 0) o[j] = (int)win.y;
    lx = c.x;
    ly = c.y;
    lz = c.z;
  }
  cluster.sync();  // no block leaves while a peer may still store into it
}

// Sets past the cluster's on-chip size, one block per frame: thread t owns
// points t, t+T, ... (N >= T, so each owns point t), their coordinates read
// from device memory every step through the read-only path (L1, then L2)
// and their running distances kept in the frame's row of `scratch` (B, N)
// in device memory. Only the owner reads or writes an entry, so no barrier
// guards them, and it writes one back only where it dropped. What bounds
// it: each step streams the frame through one SM (16-20 bytes a point
// from L1/L2) before the same block-wide argmax as fps_kernel.
__global__ void __launch_bounds__(1024)
fps_wide_kernel(const float* __restrict__ xyz, int N, int npoint, float* __restrict__ scratch,
                int* __restrict__ out) {
  __shared__ uint2 slots[2][32];  // per step parity and warp: (bits, index)

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int n_warps = T >> 5;
  const float* p = xyz + (size_t)blockIdx.x * N * 3;
  float* __restrict__ mind = scratch + (size_t)blockIdx.x * N;
  int* o = out + (size_t)blockIdx.x * npoint;
  for (int i = tid; i < N; i += T) mind[i] = 1e10f;
  if (tid == 0) o[0] = 0;

  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);
  for (int j = 1; j < npoint; ++j) {
    // seeded with the thread's first point at bits 0: a thread whose
    // running distances are all 0 reports its lowest index
    unsigned best = 0u, bi = (unsigned)tid;
#pragma unroll 8
    for (int i = tid; i < N; i += T) {
      const float old = mind[i];
      const float m = g4d::min_nan(
          old, g4d_sqdist(__ldg(p + 3 * i) - lx, __ldg(p + 3 * i + 1) - ly,
                          __ldg(p + 3 * i + 2) - lz));
      const unsigned u = __float_as_uint(m);
      if (u != __float_as_uint(old)) mind[i] = m;
      if (u > best) {  // strict: ascending indices keep ties on the lowest
        best = u;
        bi = (unsigned)i;
      }
    }
    const unsigned win = block_best(warp_best(best, bi), slots[j & 1], n_warps);
    if (tid == 0) o[j] = (int)win;
    lx = __ldg(p + 3 * win);
    ly = __ldg(p + 3 * win + 1);
    lz = __ldg(p + 3 * win + 2);
  }
}

constexpr int kOneBlock = 32 * 32 * 8;  // fps_kernel<8>'s points: 1024 threads x 8
constexpr int kClusterPPT = 16;         // fps_cluster_kernel: in registers
constexpr int kStagedPPT = 32;          // read from the planes

template <typename K, typename... Args>
int launch(K kernel, int B, int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// fps_cluster_kernel on B clusters of C blocks. The first launch of each
// (device, C, threads, smem) checks that one such cluster can be resident
// (cudaOccupancyMaxActiveClusters), after raising the instance's dynamic
// shared memory to the most a slice takes, so later launches make no host
// call but the launch; a refusal is returned, and cleared from the
// runtime's last error (and checked again on the next launch).
template <int PPT, bool kRegs>
int launch_cluster(int B, int C, int threads, int smem, cudaStream_t stream, const float* xyz,
                   int N, int npoint, int S, int* out) {
  const auto kernel = fps_cluster_kernel<PPT, kRegs>;
  constexpr int kMaxSmem = 12 * kClusterThreads * PPT;  // the planes of the largest slice
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  static std::mutex mutex;
  static std::set<std::array<int, 4>> resident;
  const std::array<int, 4> key = {device, C, threads, smem};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  {
    const std::lock_guard<std::mutex> lock(mutex);
    if (resident.count(key) == 0) {
      int clusters = 0;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
      if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidConfiguration;
      if (err == cudaSuccess) resident.insert(key);
    }
  }
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, xyz, N, npoint, S, out);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) i32 (npoint >= 1, any N >= 1), from
// pointcloud._fps_plan: `threads` a block (a multiple of 32, at most 1024),
// `smem` dynamic bytes. N <= 8192: one block a frame, threads x ppt >= N,
// ppt 1, 2, 4 or 8 (points in registers; 8 with `far`: fps_far_kernel),
// `smem` the planes (with `far` the sorted frame and the sort's counts).
// 8192 < N: with `cluster` C (4 or 8) fps_cluster_kernel, C blocks
// a frame of at most 512 threads, each a slice of S = ceil(N / C) points,
// threads x ppt >= S, ppt 16 (registers; S <= 8192) or 32 (read from the
// planes), `smem` >= 12 S; with `wide` fps_wide_kernel (N >= threads, ppt
// the points a thread strides over, `scratch` (B, N) f32, smem 0).
// `scratch` is null but with `wide`. Returns a cudaError_t code.
extern "C" int g4d_fps(const float* xyz, int B, int N, int npoint, int threads, int ppt,
                       int far, int wide, int cluster, int smem, float* scratch, int* out,
                       cudaStream_t stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || N < 1 || npoint < 1 || ppt < 1)
    return (int)cudaErrorInvalidValue;
  if (wide) {
    if (far || cluster || (long long)threads * ppt < N || N < threads || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch(fps_wide_kernel, B, threads, smem, stream, xyz, N, npoint, scratch, out);
  }
  if (cluster || N > kOneBlock) {
    if (far || N <= kOneBlock || (cluster != 4 && cluster != kMaxCluster) ||
        (long long)B * cluster > INT_MAX)
      return (int)cudaErrorInvalidValue;
    const int S = (N + cluster - 1) / cluster;
    // every block owns a point; its slice fits the instance and the planes
    if ((long long)(cluster - 1) * S >= N || threads > kClusterThreads ||
        (long long)threads * ppt < S || smem < 12LL * S)
      return (int)cudaErrorInvalidValue;
    if (ppt == kClusterPPT && S <= kClusterThreads * kClusterPPT)
      return launch_cluster<kClusterPPT, true>(B, cluster, threads, smem, stream, xyz, N, npoint,
                                               S, out);
    if (ppt == kStagedPPT)
      return launch_cluster<kStagedPPT, false>(B, cluster, threads, smem, stream, xyz, N, npoint,
                                               S, out);
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)threads * ppt < N) return (int)cudaErrorInvalidValue;
  const long long need = far ? (16LL * N > 4 * g4d::kCodes ? 16LL * N : 4 * g4d::kCodes)
                             : 12LL * N;
  if (smem < need) return (int)cudaErrorInvalidValue;
  if (far) {
    if (ppt == 8)
      return launch(fps_far_kernel<8>, B, threads, smem, stream, xyz, N, npoint, out);
    return (int)cudaErrorInvalidValue;
  }
  switch (ppt) {
    case 1: return launch(fps_kernel<1>, B, threads, smem, stream, xyz, N, npoint, out);
    case 2: return launch(fps_kernel<2>, B, threads, smem, stream, xyz, N, npoint, out);
    case 4: return launch(fps_kernel<4>, B, threads, smem, stream, xyz, N, npoint, out);
    case 8: return launch(fps_kernel<8>, B, threads, smem, stream, xyz, N, npoint, out);
  }
  return (int)cudaErrorInvalidValue;
}
