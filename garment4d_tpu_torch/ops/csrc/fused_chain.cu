// Fused neighbourhood gather + L-layer MLP chain + max over the S samples:
//   out[b, m, :] = max_s chain(table[b, idx[b, m, s], :] - pad(center[b, m]))
// where chain is x -> act(x @ W_l + b_l) per layer (BatchNorm already folded
// into W_l, b_l by the caller) and the center is subtracted on channels 0..2
// only.
//
// Replaces garment4d_tpu/ops/pallas/fusedpe.py:fused_chain_pallas
// (pallas_call at :179, body _chain_kernel at :75) and its valid-count
// variant fused_chain_pallas_nv (pallas_call at :363, body _chain_kernel_nv;
// group_pe_max_pallas_nv at :371). The TPU variant's chunk scan stopped at
// the per-frame count n_valid[b] of real rows of a sentinel-padded table,
// exact only while no index reaches max(n_valid[b], 1). This kernel gathers
// by index and never reads rows past the largest index anyway, so given
// n_valid it computes the same output and reports any index at or past
// max(n_valid[b], 1) in a device flag that the wrapper checks.
//
// What bounds it on the H100: the fp32 FMAs of the layers (2 * sum K_l F_l
// per sample row; 5.7 ms at 67 TFLOP/s over the 28 launches of a posed
// forward) on the CUDA cores, and in front of them the gather of rows 3 to
// 195 floats wide (12 to 780 bytes, not 16-byte aligned), which took up to
// two thirds of the earlier design's time. The design:
// - Persistent blocks: the wrapper launches a few blocks per SM and each
//   walks over groups of G centers (R = G * S rows) of one frame.
// - The gather is asynchronous and runs ahead: a group's indices and
//   centers are copied to shared memory two groups early, so the row
//   copies never wait on an index load; each row is 16-byte cp.async copies
//   of its channel quads (the wrapper pads the table's rows to a multiple
//   of 4 floats), lanes of a warp on the quads of one or more rows. The
//   rows land quad-major (g4d::tile_fma_quads reads 8 rows x 4 channels as
//   8 float4s). Layer 0 only reads them, so once it is done the next
//   group's rows are issued into the same buffer and land while the later
//   layers run; where shared memory is short (sa3 at S=64) the plan lets
//   the odd hidden layers reuse X's memory and the rows come after the last
//   layer instead, so that two blocks fit an SM. Out-of-range indices give
//   NaN rows. The center is subtracted on channels 0..2 as layer 0 reads
//   them.
// - Weights are staged in shared memory once per block where all layers fit
//   beside the activations; otherwise (sa3 and garment_sa2 at S=64, 296
//   and 363 KB) each layer either streams them in chunks of kc rows through
//   three cp.async buffers, one item per thread, or reads them through the
//   read-only L1 path; the wrapper's plan chooses.
// - Products on g4d::tile_fma (common.cuh): 8 x 8 outputs per thread (8 x 4
//   where 8-wide tiles would leave threads without work), activations read
//   as float4 broadcasts, weights as float4s from shared memory, the next k
//   step's loads in flight; warps of 4 x 8 tiles for layers of 16 column
//   tiles and more. Hidden layers write their output k-major into the
//   other activation buffer.
// - The last layer's max over S: each thread's 8 rows in registers, then
//   warp shuffles over the lanes that hold the other row tiles of the same
//   center, and one lane writes the (C_L) maxima; where a center's tiles
//   span warps, per-tile maxima go through shared memory.
// Every output sums its K products in ascending k with FMAs, then adds the
// bias, whatever the plan, so results are bitwise repeatable and equal
// between the resident and the streamed weights. ReLU and max propagate
// NaN as torch's do. No atomics, no tensor cores.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = g4d::kTileRows;
constexpr int kMaxLayers = 4;
// where the layers read their weights: staged in shared memory once per
// block, streamed through it in chunks per group, or from device memory
// through the read-only L1 path
constexpr int kResident = 0, kStreamed = 1, kThroughL1 = 2;

// The host's plan (ops/pemax.py:_chain_plan); offsets in floats.
struct ChainPlan {
  int L;
  int K[kMaxLayers + 1];  // K[0] = table channels, K[l + 1] = layer l width
  int tc[kMaxLayers];     // columns of a thread's tile in layer l: 4 or 8
  int wt[kMaxLayers];     // 1: layer l maps items warp-tiled (g4d::item_tile)
  int relu_mask;          // bit l: ReLU after layer l
  int G, S, R, Rp;        // centers and slots per group, rows R = G * S, pitch
  int nq, Rq;             // channel quads of a table row (its pitch / 4); X's
                          // float4s per quad plane (R + R / 8)
  int x_off, h_off[2], w_off, part_off;  // shared-memory regions
  int ib_off, cb_off;     // two groups' indices (R ints) and centers (G x 3)
  int wmode;              // the weights: kResident, kStreamed or kThroughL1
  int kc;                 // weight rows per streamed chunk
  int wbuf;               // floats per chunk buffer: kc rows of the widest layer
  int direct;             // 1: the last layer's max ends in warp shuffles
  int late;               // 1: the odd hidden buffer shares X's memory, so
                          // the next group's rows are fetched after the
                          // last layer (not after layer 0)
};

// Group g's indices (its R = G * S slots are contiguous in idx) and
// centers into index buffer q; slots of centers past M are not copied.
__device__ __forceinline__ void issue_meta(const ChainPlan& p, float* smem,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ centers, int M,
                                           int gpf, int g, int q) {
  const int b = g / gpf;
  const int m0 = (g - b * gpf) * p.G;
  const int nc = min(p.G, M - m0);  // centers of this group
  const size_t first = (size_t)b * M + m0;
  float* ib = smem + p.ib_off + q * p.R;
  for (int r = threadIdx.x; r < nc * p.S; r += kThreads)
    g4d::cp_async4(ib + r, reinterpret_cast<const float*>(idx + first * p.S + r));
  float* cb = smem + p.cb_off + q * p.G * 3;
  for (int e = threadIdx.x; e < nc * 3; e += kThreads)
    g4d::cp_async4(cb + e, centers + first * 3 + e);
}

// Copy the rows of group g into X, their indices read from index buffer q.
// X is quad-major: quad plane c (channels 4c..4c+3) holds a float4 per row,
// row r at float4 r + r / 8 (a gap after every 8 rows puts the 8 row tiles
// a warp reads on distinct banks). A row is nq 16-byte copies from the
// 16-byte-aligned table, lanes of a warp on its quads (several rows per
// warp for narrow tables). Rows of centers past M are left as they are
// (their outputs are never written).
__device__ __forceinline__ void issue_rows(const ChainPlan& p, float* smem,
                                           const float* __restrict__ table, int N, int M,
                                           int gpf, int g, int q,
                                           const int* __restrict__ n_valid,
                                           int* __restrict__ past_valid) {
  const int b = g / gpf;
  const int m0 = (g - b * gpf) * p.G;
  const int rows = min(p.G, M - m0) * p.S;
  const int lpr = min(p.nq, 32);  // lanes per row
  const int rpw = 32 / lpr;        // rows per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / lpr, c0 = lane - sub * lpr;
  if (sub >= rpw) return;
  const int valid = n_valid != nullptr ? max(__ldg(n_valid + b), 1) : 0x7fffffff;
  const int* ib = reinterpret_cast<const int*>(smem + p.ib_off + q * p.R);
  float* X = smem + p.x_off;
  const int qs = p.Rq * 4;
  for (int r = (threadIdx.x >> 5) * rpw + sub; r < rows; r += (kThreads / 32) * rpw) {
    const int j = ib[r];
    if (j >= valid && c0 == 0) *past_valid = 1;
    float* dst = X + (r + (r >> 3)) * 4;
    if ((unsigned)j < (unsigned)N) {
      const float* src = table + ((size_t)b * N + j) * (p.nq * 4);
      for (int c = c0; c < p.nq; c += lpr) g4d::cp_async16_l1(dst + c * qs, src + 4 * c);
    } else {
      const float nan = __int_as_float(0x7fc00000);
      for (int c = c0; c < p.nq; c += lpr)
        *reinterpret_cast<float4*>(dst + c * qs) = make_float4(nan, nan, nan, nan);
    }
  }
}

// Rows [k0, k0 + kn) of W_l (row-major, F wide) into a chunk buffer.
__device__ __forceinline__ void issue_weights(float* dst, const float* __restrict__ w,
                                              int n) {
  for (int e = threadIdx.x * 4; e < n; e += kThreads * 4) g4d::cp_async16(dst + e, w + e);
}

// Streamed weights run as one ring of chunks through the block's groups:
// the chunks of layers 0..L-1 (ring_len in all), then those of the next
// group, which are the same. Ring chunk c goes to buffer c % 3, two chunks
// ahead of its use, so the next layer's (and the next group's) first
// chunks arrive while this one ends.
__device__ __forceinline__ void issue_chunk(const ChainPlan& p, float* smem,
                                            const float* __restrict__ w_all, int ring_len,
                                            int c) {
  int pos = c % ring_len;
  const float* w = w_all;
  int l = 0;
  for (; l + 1 < p.L; ++l) {
    const int n = (p.K[l] + p.kc - 1) / p.kc;
    if (pos < n) break;
    pos -= n;
    w += p.K[l] * p.K[l + 1];
  }
  const int F = p.K[l + 1];
  issue_weights(smem + p.w_off + (c % 3) * p.wbuf, w + (size_t)pos * p.kc * F,
                min(p.K[l] - pos * p.kc, p.kc) * F);
  g4d::cp_async_commit();
}

// The epilogue of one item (row tile rt, column tile ct) of layer l.
template <int TC>
__device__ __forceinline__ void finish_item(const ChainPlan& p, int l, bool has,
                                            int rt, int ct, int F,
                                            float (&acc)[kRows][TC],
                                            const float* __restrict__ bias, float* smem,
                                            int b, int M, int m0,
                                            float* __restrict__ out) {
  const bool last = l + 1 == p.L;
  // the bias after the products (the plain version's order), then the ReLU
#pragma unroll
  for (int q = 0; q < TC / 4; ++q) {
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + ct * TC) + q);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][4 * q + j] += bv[j];
  }
  if ((p.relu_mask >> l) & 1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = g4d::max_nan(acc[i][j], 0.f);
  }
  if (!last) {
    if (!has) return;
    float* H = smem + p.h_off[l & 1] + rt * kRows;
    // lanes of odd column tiles store their upper 4 rows first: the two
    // halves of a warp's store land on distinct banks (8-way -> 4-way)
    const int sw = (ct & 1) * 4;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float* h = H + (ct * TC + j) * p.Rp;
      const float4 lo = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      const float4 hi = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
      *reinterpret_cast<float4*>(h + sw) = sw ? hi : lo;
      *reinterpret_cast<float4*>(h + 4 - sw) = sw ? lo : hi;
    }
    return;
  }
  float mx[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    mx[j] = acc[0][j];
#pragma unroll
    for (int i = 1; i < kRows; ++i) mx[j] = g4d::max_nan(mx[j], acc[i][j]);
  }
  const int T = p.S / kRows;  // row tiles per center
  if (p.direct) {
    // the center's T row tiles sit on lanes ls apart: 8 warp-tiled, else
    // nct = F / TC
    const int ls = p.wt[l] ? 8 : F / TC;
    for (int o = ls; o < T * ls; o <<= 1) {
#pragma unroll
      for (int j = 0; j < TC; ++j)
        mx[j] = g4d::max_nan(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    }
    const int m = m0 + rt / T;
    if (!has || rt % T != 0 || m >= M) return;
    float* o = out + ((size_t)b * M + m) * F + ct * TC;
#pragma unroll
    for (int q = 0; q < TC / 4; ++q)
      *reinterpret_cast<float4*>(o + 4 * q) =
          make_float4(mx[4 * q], mx[4 * q + 1], mx[4 * q + 2], mx[4 * q + 3]);
    return;
  }
  if (!has) return;
  float* part = smem + p.part_off + rt * F + ct * TC;
#pragma unroll
  for (int q = 0; q < TC / 4; ++q)
    *reinterpret_cast<float4*>(part + 4 * q) =
        make_float4(mx[4 * q], mx[4 * q + 1], mx[4 * q + 2], mx[4 * q + 3]);
}

// One layer of one group with its weights in shared memory (resident) or
// read through L1 (kGlobalW: w_l, the layer's weights in device memory):
// each thread loops over its items; whole warps iterate together (the
// max's shuffles need every lane).
template <int TC, bool kGlobalW>
__device__ __forceinline__ void layer_resident(const ChainPlan& p, int l, float* smem,
                                               const float* __restrict__ w_l,
                                               const float* __restrict__ bias,
                                               const float* cb, int b, int M, int m0,
                                               float* __restrict__ out) {
  const int K = p.K[l], F = p.K[l + 1];
  const int nct = F / TC;
  const int items = (p.R / kRows) * nct;
  const float* A = l == 0 ? smem + p.x_off : smem + p.h_off[(l - 1) & 1];
  const float* W = w_l;
  if (!kGlobalW) {
    int off = 0;
    for (int q = 0; q < l; ++q) off += p.K[q] * p.K[q + 1];
    W = smem + p.w_off + off;
  }
  const int lane = threadIdx.x & 31;
  for (int it0 = (threadIdx.x >> 5) * 32; it0 < items; it0 += kThreads) {
    const bool has = it0 + lane < items;
    const int it = has ? it0 + lane : items - 1;
    int rt, ct;
    g4d::item_tile(it, nct, p.wt[l], rt, ct);
    float acc[kRows][TC] = {};
    const float* w = W + ct * TC;
    if (l == 0)  // the gathered rows, less the center on channels 0..2
      g4d::tile_fma_quads<TC, kGlobalW>(A + rt * 9 * 4, p.Rq * 4, w, F, 0, 0, K, true,
                                        cb + rt * kRows / p.S * 3, acc);
    else
      g4d::tile_fma<TC, kGlobalW>(A + rt * kRows, p.Rp, w, F, K, acc);
    finish_item<TC>(p, l, has, rt, ct, F, acc, bias, smem, b, M, m0, out);
  }
}

// One layer of one group with streamed weights: at most one item per
// thread (the plan guarantees it); chunks of kc weight rows through three
// buffers, the next two chunks of the ring in flight while this one is
// used.
template <int TC>
__device__ __forceinline__ void layer_streamed(const ChainPlan& p, int l, float* smem,
                                               const float* __restrict__ w_all, int ring_len,
                                               int& c, const float* __restrict__ bias,
                                               const float* cb, int b, int M, int m0,
                                               float* __restrict__ out) {
  const int K = p.K[l], F = p.K[l + 1];
  const int nct = F / TC;
  const int items = (p.R / kRows) * nct;
  const float* A = l == 0 ? smem + p.x_off : smem + p.h_off[(l - 1) & 1];
  const bool has = (int)threadIdx.x < items;
  const int it = has ? threadIdx.x : 0;
  int rt, ct;
  g4d::item_tile(it, nct, p.wt[l], rt, ct);
  float acc[kRows][TC] = {};
  const float* ctr = cb + rt * kRows / p.S * 3;
  // three chunk buffers: ring chunk c + 2 is issued once every thread is
  // past chunk c - 1, so one barrier per chunk suffices
  const int n_chunks = (K + p.kc - 1) / p.kc;
  for (int ch = 0; ch < n_chunks; ++ch, ++c) {
    const int k0 = ch * p.kc;
    g4d::cp_async_wait<1>();  // chunk c is in; chunk c + 1 may still be in flight
    __syncthreads();
    issue_chunk(p, smem, w_all, ring_len, c + 2);
    if (has) {
      const float* w = smem + p.w_off + (c % 3) * p.wbuf + ct * TC;
      const int kn = min(K - k0, p.kc);
      if (l == 0)
        g4d::tile_fma_quads<TC>(A + rt * 9 * 4, p.Rq * 4, w, F, k0, k0, k0 + kn, true, ctr,
                                acc);
      else
        g4d::tile_fma<TC>(A + rt * kRows + k0 * p.Rp, p.Rp, w, F, kn, acc);
    }
  }
  finish_item<TC>(p, l, has, rt, ct, F, acc, bias, smem, b, M, m0, out);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMode == kStreamed ? 1 : 2)
fused_chain_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   const float* __restrict__ centers, const float* __restrict__ w_all,
                   const float* __restrict__ b_all, const __grid_constant__ ChainPlan p,
                   int B, int N, int M,
                   const int* __restrict__ n_valid, int* __restrict__ past_valid,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int gpf = (M + p.G - 1) / p.G;  // groups per frame
  const int n_groups = B * gpf;
  const int grid = gridDim.x;
  int g = blockIdx.x;
  if (kMode == kResident) {  // every layer's weights, once per block
    int total = 0;
    for (int l = 0; l < p.L; ++l) total += p.K[l] * p.K[l + 1];
    issue_weights(smem + p.w_off, w_all, total);
  }
  // the pipeline: while group g runs, its successor's rows and the next
  // one's indices are in flight
  if (g < n_groups) issue_meta(p, smem, idx, centers, M, gpf, g, 0);
  g4d::cp_async_commit();
  g4d::cp_async_wait<0>();
  __syncthreads();
  if (g < n_groups) issue_rows(p, smem, table, N, M, gpf, g, 0, n_valid, past_valid);
  if (g + grid < n_groups) issue_meta(p, smem, idx, centers, M, gpf, g + grid, 1);
  g4d::cp_async_commit();
  int ring_len = 0, c = 0;  // the streamed weights' chunk ring
  if (kMode == kStreamed) {
    for (int l = 0; l < p.L; ++l) ring_len += (p.K[l] + p.kc - 1) / p.kc;
    issue_chunk(p, smem, w_all, ring_len, 0);
    issue_chunk(p, smem, w_all, ring_len, 1);
  }
  for (int q = 0; g < n_groups; g += grid, q ^= 1) {
    const int b = g / gpf;
    const int m0 = (g - b * gpf) * p.G;
    const float* cb = smem + p.cb_off + q * p.G * 3;
    g4d::cp_async_wait<0>();
    __syncthreads();
    const float* w_l = w_all;
    const float* bias = b_all;
    for (int l = 0; l < p.L; ++l) {
      constexpr bool kL1 = kMode == kThroughL1;
      if (kMode == kStreamed) {
        if (p.tc[l] == 8)
          layer_streamed<8>(p, l, smem, w_all, ring_len, c, bias, cb, b, M, m0, out);
        else
          layer_streamed<4>(p, l, smem, w_all, ring_len, c, bias, cb, b, M, m0, out);
      } else {
        if (p.tc[l] == 8)
          layer_resident<8, kL1>(p, l, smem, w_l, bias, cb, b, M, m0, out);
        else
          layer_resident<4, kL1>(p, l, smem, w_l, bias, cb, b, M, m0, out);
      }
      __syncthreads();
      if (l == (p.late ? p.L - 1 : 0)) {  // X and this group's indices are free
        if (g + grid < n_groups)
          issue_rows(p, smem, table, N, M, gpf, g + grid, q ^ 1, n_valid, past_valid);
        if (g + 2 * grid < n_groups) issue_meta(p, smem, idx, centers, M, gpf, g + 2 * grid, q);
        g4d::cp_async_commit();
      }
      w_l += (size_t)p.K[l] * p.K[l + 1];
      bias += p.K[l + 1];
    }
    if (!p.direct) {  // max of each center's S / 8 row-tile maxima
      const int F = p.K[p.L];
      const int T = p.S / kRows;
      for (int e = threadIdx.x; e < p.G * F; e += kThreads) {
        const int gc = e / F;
        const int c = e - gc * F;
        const int m = m0 + gc;
        if (m >= M) continue;
        const float* part = smem + p.part_off + gc * T * F + c;
        float mx = part[0];
        for (int t = 1; t < T; ++t) mx = g4d::max_nan(mx, part[t * F]);
        out[((size_t)b * M + m) * F + c] = mx;
      }
    }
  }
  g4d::cp_async_wait<0>();
}

}  // namespace

// table (B, N, 4 * nq) with the C channels first (rows 16-byte aligned), idx
// (B, M, S) i32 with S a multiple of 8, centers (B, M, 3); w_all the L row-major (K_l, F_l) weights back to back, b_all the L
// biases, both 16-byte aligned; plan: the ints of ChainPlan in order (see
// ops/pemax.py:_chain_plan), n_plan of them; blocks: the persistent grid;
// smem_bytes the shared memory of the plan; n_valid (B) i32 or null;
// past_valid (1) i32, set to 1 where an index is >= max(n_valid[b], 1)
// (untouched without n_valid) -> out (B, M, F_{L-1}).
extern "C" int g4d_fused_chain(const float* table, const int* idx,
                               const float* centers, const float* w_all,
                               const float* b_all, int B, int N, int M,
                               const int* plan, int n_plan, int blocks,
                               int smem_bytes, const int* n_valid,
                               int* past_valid, float* out, cudaStream_t stream) {
  ChainPlan p;
  if (n_plan != (int)(sizeof(ChainPlan) / sizeof(int))) return (int)cudaErrorInvalidValue;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < n_plan; ++i) dst[i] = plan[i];
  // the kernel's assumptions; the plan keeps them
  if (p.L < 1 || p.L > kMaxLayers || p.S % kRows != 0 || p.R != p.G * p.S ||
      p.Rp % 4 != 0 || p.Rp < p.R || p.K[0] < 3 || 4 * p.nq < p.K[0] ||
      p.Rq != p.R + p.R / kRows)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.L; ++l) {
    const int F = p.K[l + 1];
    if (F % 4 != 0 || (p.tc[l] != 4 && p.tc[l] != 8) || F % p.tc[l] != 0)
      return (int)cudaErrorInvalidValue;
    if (p.wt[l] && ((F / p.tc[l]) % 8 != 0 || (p.R / kRows) % 4 != 0))
      return (int)cudaErrorInvalidValue;
    if (p.wmode == kStreamed && (p.R / kRows) * (F / p.tc[l]) > kThreads)
      return (int)cudaErrorInvalidValue;
  }
  if (p.wmode < kResident || p.wmode > kThroughL1 ||
      (p.wmode == kStreamed && (p.kc < 4 || p.kc % 4 != 0 || p.wbuf % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaSuccess;
  auto kernel = p.wmode == kStreamed    ? fused_chain_kernel<kStreamed>
                : p.wmode == kThroughL1 ? fused_chain_kernel<kThroughL1>
                                        : fused_chain_kernel<kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(table, idx, centers, w_all, b_all, p, B, N,
                                                   M, n_valid, past_valid, out);
  return (int)cudaGetLastError();
}
