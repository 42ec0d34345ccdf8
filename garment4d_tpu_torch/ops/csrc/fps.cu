// Furthest point sampling, one block per point set.
//
// Replaces garment4d_tpu/ops/pallas/fps.py:fps_pallas (pallas_call at :75).
// Semantics: start at index 0, running min-distance initialised to 1e10,
// next point = argmax of the running min-distance, ties to the lowest index
// (a NaN running distance counts as the largest, as torch.argmax has it).
//
// What bounds it on the H100: the npoint-1 steps are sequential, and each
// ends in a block-wide argmax that the next one needs, so a step's latency
// sets the time, not FLOPs or bytes: a distance pass over the frame (~11
// instructions a point on one SM's 128 lanes: 6890 points take ~600 issue
// cycles), then the reduction chain. With one block per frame a frame uses
// one SM. The design keeps both short:
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
// from all of their points. Sets past 32 warps x 8 points take fps_kernel
// with 16 points a thread read from the planes every step (registers would
// spill), up to 16 N bytes of shared memory (N = 14528). Larger sets (a
// denser scan, N = 20000 and up) take fps_wide_kernel: the coordinates are
// read through L1/L2 every step (20000 points are 240 KB, resident in the
// 50 MB L2) and the running distances kept in device memory.
//
// npoint may exceed N: the loop runs on with the same rule. Once every
// running distance is 0 (every point taken) each step's argmax is index 0,
// as in the plain version and the JAX package.
#include <climits>

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

template <int PPT, bool kRegs>
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

  float x[kRegs ? PPT : 1], y[kRegs ? PPT : 1], z[kRegs ? PPT : 1];
  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if constexpr (kRegs) {
      const int i = tid + k * T < N ? tid + k * T : 0;
      x[k] = sx[i];
      y[k] = sy[i];
      z[k] = sz[i];
    }
    mind[k] = 1e10f;
  }

  float lx = sx[0], ly = sy[0], lz = sz[0];
  for (int j = 1; j < npoint; ++j) {
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
        const int i = tid + k * T < N ? tid + k * T : 0;
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

// Sets past the staged size, one block per frame: thread t owns points t,
// t+T, ... (N >= T, so each owns point t), their coordinates read from
// device memory every step through the read-only path (L1, then L2, where a
// frame of 20000 points stays resident) and their running distances kept in
// the frame's row of `scratch` (B, N) in device memory. Only the owner
// reads or writes an entry, so no barrier guards them, and it writes one
// back only where it dropped. What bounds it: each step streams the
// frame through one SM (16-20 bytes a point from L1/L2) before the same
// block-wide argmax as fps_kernel; one frame a block leaves most SMs idle
// at a few frames (splitting a frame over a cluster is not done here).
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

constexpr int kStagedPPT = 16;

template <typename K, typename... Args>
int launch(K kernel, int B, int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) f32 -> out (B, npoint) i32 (npoint >= 1, any N >= 1), one
// block of `threads` threads (a multiple of 32, at most 1024, threads x ppt
// >= N) per frame, `smem` dynamic bytes (the planes; with `far` the sorted
// frame and the sort's counts; 0 with `wide`); ppt 1, 2, 4 or 8 (points in
// registers; 8 with `far`: fps_far_kernel), 16 (read from the planes) or,
// with `wide` (fps_wide_kernel, N >= threads), the points a thread strides
// over; `scratch` (B, N) f32 with `wide`, else null; from
// pointcloud._fps_plan. Returns a cudaError_t code.
extern "C" int g4d_fps(const float* xyz, int B, int N, int npoint, int threads, int ppt,
                       int far, int wide, int smem, float* scratch, int* out,
                       cudaStream_t stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || (long long)threads * ppt < N ||
      N < 1 || npoint < 1)
    return (int)cudaErrorInvalidValue;
  if (wide) {
    if (far || N < threads || scratch == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch(fps_wide_kernel, B, threads, smem, stream, xyz, N, npoint, scratch, out);
  }
  const long long need = far ? (16LL * N > 4 * g4d::kCodes ? 16LL * N : 4 * g4d::kCodes)
                             : 12LL * N;
  if (smem < need) return (int)cudaErrorInvalidValue;
  if (far) {
    if (ppt == 8)
      return launch(fps_far_kernel<8>, B, threads, smem, stream, xyz, N, npoint, out);
    return (int)cudaErrorInvalidValue;
  }
  switch (ppt) {
    case 1: return launch(fps_kernel<1, true>, B, threads, smem, stream, xyz, N, npoint, out);
    case 2: return launch(fps_kernel<2, true>, B, threads, smem, stream, xyz, N, npoint, out);
    case 4: return launch(fps_kernel<4, true>, B, threads, smem, stream, xyz, N, npoint, out);
    case 8: return launch(fps_kernel<8, true>, B, threads, smem, stream, xyz, N, npoint, out);
    case kStagedPPT:
      return launch(fps_kernel<kStagedPPT, false>, B, threads, smem, stream, xyz, N, npoint,
                    out);
  }
  return (int)cudaErrorInvalidValue;
}
