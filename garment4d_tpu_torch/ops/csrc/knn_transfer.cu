// K-NN skinning-weight transfer: for each garment vertex, the normalised
// 1/d^2-weighted average of the body skinning weights over its k (and k64)
// nearest body points, and its nearest body point.
//
// Replaces garment4d_tpu/ops/pallas/knn_transfer.py:knn_weight_transfer_pallas
// (pallas_call at :165, body _kernel at :103). Semantics (the XLA
// formulation, garment4d_tpu/models/skinning.py:63-139): squared diff-form
// distances; the k-th smallest on the f32 bit patterns (non-negative floats
// order like their bits); every entry below it is selected, and of the
// entries equal to it the first k - #below in index order; w = 1/d^2 with
// d^2 = 0's inf zeroed, normalised by its sum, infs zeroed again;
// out = sum_n w[n] * w0[n, :]. The 1-NN index takes the lowest index on
// ties.
//
// What bounds it on the H100: the passes over each vertex's N distances
// (one shared load and 8 flops each), on the CUDA cores. The TPU kernel held
// a (64, N) distance tile in VMEM and bisected over it (~31 counting passes
// per threshold) before an MXU contraction. Here a block stages one batch
// element's body (float4 per point) in shared memory once, and each of its
// warps walks garment vertices of that element (taken from a block counter),
// recomputing a distance wherever a pass needs one instead of storing the
// row:
//   1. one pass over the N points: min, max, the 1-NN, and each lane's 8
//      smallest distances; the largest over the lanes of their m-th
//      smallest (m = ceil(k / 32) <= 8) is a bound U with at least k
//      points at or below it, so only those can be selected (the
//      candidates, ~450 at k = 256 on the synthetic body);
//   2. one pass that lists the candidates' indices in index order (ballots)
//      in the warp's slice of shared memory, when they fit; later passes run
//      over that list (else over all N points);
//   3. a radix select of the k-th and the k64-th candidate on the bit
//      patterns: 8 bits per pass into a 256-bin warp histogram (shared
//      atomics, candidates of the current bin only), starting below the
//      bits that min and U share; a threshold stops once its bin is wholly
//      selected or fully resolved. Both thresholds share the passes (and the
//      histogram while they share a bin);
//   4. the weight sums over the selected candidates (per lane, then a warp
//      sum), then per threshold the contraction: the selected candidates'
//      (index, q = w / sum) are queued in index order and taken 16 at a
//      time, two lanes a candidate (16 columns each), each lane adding
//      q * w0[n, c] (float4 loads) to its own column sums, and a
//      reduce-scatter over the lanes leaves one column's total in each
//      lane. This takes far fewer instructions than broadcasting each
//      candidate to J lanes, which took 0.31 of 0.67 ms at the posed
//      forward's shape (H100 80GB HBM3 at 700 W); the fp32 sums add per
//      lane, then in a tree, not in index order.
// Nothing but the (Vg, J) results reaches device memory. A body too large
// to stage is read through L1 instead.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDigitBits = 8;           // bits resolved per histogram pass
constexpr int kBins = 1 << kDigitBits;  // bins of one warp histogram
constexpr int kTop = 8;                 // smallest distances each lane keeps in pass 1

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_max(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One threshold's radix-select state (warp-uniform). Of the candidates,
// those whose bits above bit s are below p are selected; those equal to p
// there form the bin that holds the threshold, and its first `need` in
// index order are selected too. `done` once the bin is wholly selected
// (its count is `need`) or fully resolved (s = 0: its entries are equal).
struct Select {
  unsigned p;
  int s;
  int need;
  bool done;
};

// Narrow t to the digit (the next min(8, s) bits) whose bin of the
// histogram h holds its need-th candidate in value order. Lane l holds
// bins 8l..8l+7; a warp scan finds the lane, the lane finds the bin.
__device__ void descend(Select& t, const unsigned* h, int lane) {
  constexpr int kPer = kBins / 32;
  const int d = min(kDigitBits, t.s);
  unsigned c[kPer];
  unsigned local = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    c[i] = h[lane * kPer + i];
    local += c[i];
  }
  unsigned incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned need = t.need, excl = incl - local;
  const int owner = __ffs(__ballot_sync(kFull, excl < need && need <= incl)) - 1;
  int bin = 0;
  unsigned before = excl, cnt = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (!found && before + c[i] >= need) {
      bin = lane * kPer + i;
      cnt = c[i];
      found = true;
    } else if (!found) {
      before += c[i];
    }
  }
  bin = __shfl_sync(kFull, bin, owner);
  before = __shfl_sync(kFull, before, owner);
  cnt = __shfl_sync(kFull, cnt, owner);
  t.need -= (int)before;
  t.p = (t.p << d) | (unsigned)bin;
  t.s -= d;
  t.done = cnt == (unsigned)t.need || t.s == 0;
}

// Whether the candidate `bits` (cand) is selected by t; `ties` counts the
// bin's entries of earlier steps (warp-uniform).
__device__ __forceinline__ bool selected(const Select& t, unsigned bits, bool cand, int& ties,
                                         unsigned lower) {
  const bool tie = cand && (bits >> t.s) == t.p;
  const unsigned tmask = __ballot_sync(kFull, tie);
  const bool sel = (cand && (bits >> t.s) < t.p) || (tie && ties + __popc(tmask & lower) < t.need);
  ties += __popc(tmask);
  return sel;
}

// 1/d^2 with inf -> 0
__device__ __forceinline__ float inv_weight(unsigned bits) {
  const float w = 1.0f / __uint_as_float(bits);
  return isinf(w) ? 0.f : w;
}

// The contraction's layout: kLanes lanes share a queued candidate, each
// summing kC of its J <= 32 columns (those past J stay 0), so that a lane
// holds 16 sums in registers.
constexpr int kLanes = 2;
constexpr int kC = 32 / kLanes;

// acc[c] += q * row[c0 + c] for the lane's columns c0 + c < J: float4 loads
// where the rows are 16-byte aligned (vec4), else one float at a time.
__device__ __forceinline__ void add_row(float (&acc)[kC], float q, const float* row, int c0,
                                        int J, bool vec4) {
  if (vec4) {
#pragma unroll
    for (int c = 0; c < kC; c += 4) {
      if (c0 + c < J) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(row + c0 + c));
        acc[c] = fmaf(q, r.x, acc[c]);
        acc[c + 1] = fmaf(q, r.y, acc[c + 1]);
        acc[c + 2] = fmaf(q, r.z, acc[c + 2]);
        acc[c + 3] = fmaf(q, r.w, acc[c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c0 + c < J) acc[c] = fmaf(q, __ldg(row + c0 + c), acc[c]);
  }
}

// Sum each column over the lanes that hold it, leaving one column's total
// in each lane: halving steps over the lane bits from 16 down to kLanes,
// each lane keeping the half of its columns that its lane bit selects and
// adding its partner's. The total left in lane l is column
// kC * (l % kLanes) + l / kLanes.
__device__ __forceinline__ float reduce_scatter(float (&acc)[kC], int lane) {
#pragma unroll
  for (int o = 16, half = kC / 2; o >= kLanes; o >>= 1, half >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? acc[j] : acc[j + half];
      const float keep = upper ? acc[j + half] : acc[j];
      acc[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  return acc[0];
}

template <bool kStaged>
__global__ void __launch_bounds__(1024, 1)
knn_transfer_kernel(const float* __restrict__ garment, const float* __restrict__ body,
                    const float* __restrict__ w0, int Vg, int N, int J, int k, int k64,
                    int chunk, int cap, float* __restrict__ outk,
                    float* __restrict__ out64, int* __restrict__ nn1) {
  extern __shared__ float4 smem4[];
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int b = blockIdx.y;
  const int v1 = min(Vg, ((int)blockIdx.x + 1) * chunk);
  // layout: the vertex counter (one float4), the body, the histograms,
  // the candidate lists
  int* next_v = reinterpret_cast<int*>(smem4);
  const float4* pts = smem4 + 1;
  unsigned* hists = reinterpret_cast<unsigned*>(smem4 + 1 + (kStaged ? N : 0));
  unsigned* hist = hists + warp * 2 * kBins;
  unsigned short* cand =
      reinterpret_cast<unsigned short*>(hists + nwarps * 2 * kBins) + (size_t)warp * cap;
  const float* p = body + (size_t)b * N * 3;
  if (threadIdx.x == 0) *next_v = (int)blockIdx.x * chunk;
  if constexpr (kStaged)
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      smem4[1 + i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f);
  __syncthreads();
  const float* w0b = w0 + (size_t)b * N * J;
  const bool vec4 = J % 4 == 0 && reinterpret_cast<size_t>(w0) % 16 == 0;
  const int m = (k + 31) >> 5;  // the lane rank whose maximum over lanes bounds the k-th

  for (;;) {
    int v = 0;
    if (lane == 0) v = atomicAdd(next_v, 1);
    v = __shfl_sync(kFull, v, 0);
    if (v >= v1) break;
    const float* g = garment + ((size_t)b * Vg + v) * 3;
    const float gx = g[0], gy = g[1], gz = g[2];
    auto dist = [&](int n) {
      float x, y, z;
      if constexpr (kStaged) {
        const float4 t = pts[n];
        x = t.x;
        y = t.y;
        z = t.z;
      } else {
        x = __ldg(p + 3 * n);
        y = __ldg(p + 3 * n + 1);
        z = __ldg(p + 3 * n + 2);
      }
      return __float_as_uint(g4d_sqdist(gx - x, gy - y, gz - z));
    };

    // 1. min (and the 1-NN), max, each lane's kTop smallest
    unsigned minb = kFull, maxb = 0;
    int mini = 0x7fffffff;
    unsigned top[kTop];
#pragma unroll
    for (int i = 0; i < kTop; ++i) top[i] = kFull;
#pragma unroll 4
    for (int n = lane; n < N; n += 32) {
      const unsigned bits = dist(n);
      if (bits < minb) {  // strict: a lane's indices rise, so ties keep the lowest
        minb = bits;
        mini = n;
      }
      maxb = max(maxb, bits);
      if (bits < top[kTop - 1]) {  // insert into the sorted kTop, dropping the largest
        unsigned x = bits;
#pragma unroll
        for (int i = 0; i < kTop; ++i) {
          const unsigned lo = min(top[i], x);
          x = max(top[i], x);
          top[i] = lo;
        }
      }
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
    // U: 32 lanes x m distances (>= k) lie at or below it. A lane with
    // fewer than m points, or k > 32 kTop, leaves U = max.
    unsigned mine = m > kTop ? kFull : 0u;  // top is sorted: its m-th is the max of its first m
#pragma unroll
    for (int i = 0; i < kTop; ++i)
      if (i < m) mine = max(mine, top[i]);
    const unsigned U = min(warp_max(mine), maxb);

    // 2. the candidates (bits <= U) in index order, when they fit the list
    int count = N;
    if (U < maxb) {
      count = 0;
#pragma unroll 4
      for (int base = 0; base < N; base += 32) {
        const int n = base + lane;
        const bool c = n < N && dist(n) <= U;
        const unsigned mask = __ballot_sync(kFull, c);
        const int slot = count + __popc(mask & lower);
        if (c && slot < cap) cand[slot] = (unsigned short)n;
        count += __popc(mask);
      }
      __syncwarp();
    }
    const bool listed = count <= cap && U < maxb;
    const int M = listed ? count : N;  // entries of the later passes
    auto point = [&](int i) { return listed ? (int)cand[i] : i; };

    // 3. radix select: the bits at and above s are common to min and U
    Select t[2];
    {
      const unsigned diff = minb ^ U;
      const int s = diff ? 32 - __clz(diff) : 0;
      const unsigned p0 = s ? U >> s : U;
      t[0] = Select{p0, s, k, s == 0};
      t[1] = Select{p0, s, k64, s == 0};
    }
    while (!t[0].done || !t[1].done) {
      const bool share = !t[0].done && !t[1].done && t[0].p == t[1].p && t[0].s == t[1].s;
      for (int i = lane; i < 2 * kBins; i += 32) hist[i] = 0;
      __syncwarp();
      const int s0 = t[0].s - min(kDigitBits, t[0].s), s1 = t[1].s - min(kDigitBits, t[1].s);
      for (int i = lane; i < M; i += 32) {
        const unsigned bits = dist(point(i));
        if (bits > U) continue;
        if (!t[0].done && (bits >> t[0].s) == t[0].p)
          atomicAdd(hist + ((bits >> s0) & (kBins - 1)), 1u);
        if (!t[1].done && !share && (bits >> t[1].s) == t[1].p)
          atomicAdd(hist + kBins + ((bits >> s1) & (kBins - 1)), 1u);
      }
      __syncwarp();
      if (!t[0].done) descend(t[0], hist, lane);
      if (!t[1].done) descend(t[1], share ? hist : hist + kBins, lane);
      __syncwarp();  // the histograms are cleared by the next pass
    }

    // 4. weight sums, then the contraction, over the selected in index order
    float wsum[2] = {0.f, 0.f};
    {
      int ties[2] = {0, 0};
      for (int base = 0; base < M; base += 32) {
        const int i = base + lane;
        const unsigned bits = i < M ? dist(point(i)) : kFull;
        const bool c = bits <= U;
        const bool s0 = selected(t[0], bits, c, ties[0], lower);
        const bool s1 = selected(t[1], bits, c, ties[1], lower);
        if (s0 || s1) {
          const float w = inv_weight(bits);
          if (s0) wsum[0] += w;
          if (s1) wsum[1] += w;
        }
      }
      wsum[0] = warp_sum(wsum[0]);
      wsum[1] = warp_sum(wsum[1]);
    }
    // the contractions: a threshold's selected candidates are queued in
    // index order (index, q) in the warp's histogram memory; each full
    // batch of 32 / kLanes is taken kLanes lanes a candidate, each adding
    // q * w0[n, c] to its own column sums; a reduce-scatter then leaves
    // one column's total in each lane
    constexpr int kTake = 32 / kLanes;
    const size_t o = ((size_t)b * Vg + v) * J;
    const int mine_q = lane / kLanes, c0 = kC * (lane % kLanes);
    const int col = kC * (lane % kLanes) + lane / kLanes;  // the column lane ends with
    int* qn = reinterpret_cast<int*>(hist);
    float* qq = reinterpret_cast<float*>(hist) + 2 * 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* out = h ? out64 : outk;
      if (h && k64 == k) {  // the same selection: the same sums
        if (lane < J) out[o + lane] = outk[o + lane];
        continue;
      }
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
      int ties = 0, fill = 0;
      for (int base = 0; base < M; base += 32) {
        const int i = base + lane;
        const int n = i < M ? point(i) : 0;
        const unsigned bits = i < M ? dist(n) : kFull;
        const bool sel = selected(t[h], bits, bits <= U, ties, lower);
        const unsigned mask = __ballot_sync(kFull, sel);
        if (!mask) continue;
        if (sel) {
          const int slot = fill + __popc(mask & lower);
          float q = inv_weight(bits) / wsum[h];
          if (isinf(q)) q = 0.f;
          qn[slot] = n;
          qq[slot] = q;
        }
        fill += __popc(mask);
        __syncwarp();
        while (fill >= kTake) {  // the queue's first kTake
          add_row(acc, qq[mine_q], w0b + (size_t)qn[mine_q] * J, c0, J, vec4);
          const bool move = lane < fill - kTake;  // the rest to the front
          const int mn = move ? qn[kTake + lane] : 0;
          const float mq = move ? qq[kTake + lane] : 0.f;
          __syncwarp();
          if (move) {
            qn[lane] = mn;
            qq[lane] = mq;
          }
          fill -= kTake;
          __syncwarp();
        }
      }
      if (mine_q < fill) add_row(acc, qq[mine_q], w0b + (size_t)qn[mine_q] * J, c0, J, vec4);
      const float total = reduce_scatter(acc, lane);
      if (col < J) out[o + col] = total;
      __syncwarp();  // the queue is refilled by the next contraction
    }
    if (lane == 0) nn1[(size_t)b * Vg + v] = mini;
    __syncwarp();  // the list is rewritten for the next vertex
  }
}

}  // namespace

// garment (B, Vg, 3), body (B, N, 3), w0 (B, N, J) f32; 1 <= k64 <= k <= N
// < 65536, J <= 32. The launch plan (models/skinning.py:_knn_plan): the body
// staged in shared memory or not, `warps` per block, `cap` list entries per
// warp, `chunk` garment vertices per block (grid (ceil(Vg / chunk), B)),
// smem_bytes = 16 + (staged ? 16 N : 0) + warps * (2048 + 2 cap)
// -> outk, out64 (B, Vg, J) f32, nn1 (B, Vg) i32.
extern "C" int g4d_knn_transfer(const float* garment, const float* body,
                                const float* w0, int B, int Vg, int N, int J,
                                int k, int k64, int staged, int warps, int cap,
                                int chunk, int smem_bytes, float* outk,
                                float* out64, int* nn1, cudaStream_t stream) {
  if (k < 1 || k64 < 1 || k64 > k || k > N || N > 65535 || J < 1 || J > 32 ||
      warps < 1 || warps > 32 || cap < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Vg == 0) return (int)cudaSuccess;
  void (*kernel)(const float*, const float*, const float*, int, int, int, int, int, int, int,
                 float*, float*, int*) =
      staged ? knn_transfer_kernel<true> : knn_transfer_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(g4d_blocks(Vg, chunk), B);
  kernel<<<grid, warps * 32, smem_bytes, stream>>>(garment, body, w0, Vg, N, J, k, k64, chunk,
                                                   cap, outk, out64, nn1);
  return (int)cudaGetLastError();
}
