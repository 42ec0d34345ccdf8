// One layer of the posed stage's GCN refinement stack over a cyclic-banded
// adjacency:
//   out[b, v, :] = act((sum_d vals[d, v] * h[b, (v + o_d) mod V, :]) @ W + bias)
// where h is the layer input, given as up to 8 channel pieces whose
// concatenation it is (layer 0: xyz, 3 body PEs, 3 garment PEs and, from the
// second iteration on, the temporal-attention mix).
//
// Replaces garment4d_tpu/ops/pallas/gcnstack.py:gcn_stack_cf_pallas
// (pallas_call at :176, body _stack_kernel at :61), launched once per layer.
// The TPU kernel computed adj @ (h @ W) per layer; the wide layers here
// compute (adj @ h) @ W and the narrow last layer adj @ (h @ W), equal up to
// fp32 summation order.
//
// What bounds it on the H100: the fp32 FMAs of the products, 2 * V * K * F
// per frame and layer (13 GFLOP for the first layer of a 323-wide iteration
// of 80 frames; 1.1 ms at 67 TFLOP/s over the 12 launches of a posed
// forward), on the CUDA cores; the 128 -> 3 last layer is bound by reading
// its input (82 MB). A frame's activations (2000 x 128 floats) do not fit in
// a block's shared memory, so each layer is one launch whose output the next
// layer reads (the layer-2 output is also the `hidden` the next iteration's
// attention reads). The design:
// - A block computes 128 vertices x 128 output columns with 256 threads,
//   each an 8 x 8 tile of g4d::tile_fma (common.cuh), so every W chunk in
//   shared memory serves 128 rows (the earlier design: 64 rows, W from L2).
// - K runs in chunks of at most 32 channels within one piece. A chunk's A
//   operand is the banded aggregation
//   sum_d vals[d, v] * h[(v + o_d) mod V, k], formed k-major in shared
//   memory: from a staged window of rows (the tile plus the band's signed
//   span; +-16 rows on the ring template) where the span is at most 64
//   rows, else straight from the rows in L2 (wide cyclic offsets). Window
//   rows of a 16-byte-aligned piece arrive as 16-byte copies (8 lanes per
//   row), others a lane per channel; vals[d, v] is read once per (d, v)
//   into shared memory, each window row once per chunk.
// - The next chunk's window rows and W rows arrive by cp.async into a second
//   buffer while this chunk is aggregated and multiplied.
// - Bias and ReLU in the epilogue; every output sums its products in
//   ascending k with FMAs, the band in ascending d: bitwise repeatable.
// - A layer at most 4 wide (the 128 -> 3 last layer) runs gcn_narrow_kernel:
//   8 lanes per input row (32 rows in flight per block), the K products
//   split across them, then the band over the (row, 4) results; every
//   thread works.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 128;  // vertices per block
constexpr int kTileF = 128;  // output columns per block at most
constexpr int kKc = 32;      // K rows per chunk
constexpr int kPitchA = kTileV + 4;
constexpr int kPitchW = kKc + 4;  // window row pitch: a quarter warp's float4s on distinct banks
constexpr int kMaxPieces = 8;
constexpr int kMaxDiags = 64;
constexpr int kRows = g4d::kTileRows;

struct Pieces {
  const float* ptr[kMaxPieces];  // (B, V, width[i]) each
  int width[kMaxPieces];
  int n;
};

// K in chunks of at most kKc channels, each within one piece (offsets in
// floats); `vec`: the chunk's rows are 16-byte aligned quads.
constexpr int kMaxChunks = 64;
struct Chunks {
  int piece[kMaxChunks], off[kMaxChunks], kb[kMaxChunks], kn[kMaxChunks], vec[kMaxChunks];
  int n;
};

struct Band {
  int off[kMaxDiags];   // cyclic offsets in [0, V)
  int soff[kMaxDiags];  // the same, signed: off or off - V, within [lo, lo + span]
  int D;
  int lo;               // smallest signed offset
  int nw;               // window rows (kTileV + span), 0: no window
};

// u mod V in [0, V). (A division: loops that step u into range measured
// 30% slower over the whole stack.)
__device__ __forceinline__ int wrap(int u, int V) {
  u %= V;
  return u < 0 ? u + V : u;
}

// vals[d, v0 + v] for the tile's vertices (0 past V) into shared memory.
__device__ __forceinline__ void load_vals(float* vs, const float* __restrict__ vals,
                                          const Band& band, int V, int v0) {
  for (int e = threadIdx.x; e < band.D * kTileV; e += kThreads) {
    const int d = e / kTileV, v = e - d * kTileV;
    vs[e] = v0 + v < V ? __ldg(vals + (size_t)d * V + v0 + v) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gcn_tile_kernel(const __grid_constant__ Pieces pc, const __grid_constant__ Chunks chunks,
                int V, const float* __restrict__ vals, const __grid_constant__ Band band,
                const float* __restrict__ w, const float* __restrict__ bias, int F,
                int Fp, int FT, int relu, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* at = reinterpret_cast<float*>(smem4);  // (kKc, kPitchA): the chunk's A, k-major
  float* wc = at + kKc * kPitchA;               // 2 x (kKc, FT): W chunks
  float* vs = wc + 2 * kKc * FT;                // (D, kTileV)
  float* win = vs + band.D * kTileV;            // 2 x (nw, kPitchW): window rows
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTileV;
  const int f0 = blockIdx.z * FT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_chunks = chunks.n;

  // chunk ch's W rows and window rows into buffer ch & 1
  auto issue = [&](int ch) {
    const int kb = chunks.kb[ch], kn = chunks.kn[ch];
    float* wdst = wc + (ch & 1) * kKc * FT;
    for (int e = threadIdx.x * 4; e < kn * FT; e += kThreads * 4) {
      const int r = e / FT, c = e - r * FT;
      g4d::cp_async16(wdst + e, w + (size_t)(kb + r) * Fp + f0 + c);
    }
    if (band.nw == 0) return;
    const int width = pc.width[chunks.piece[ch]];
    const float* src = pc.ptr[chunks.piece[ch]] + (size_t)b * V * width + chunks.off[ch];
    float* dst = win + (ch & 1) * band.nw * kPitchW;
    if (chunks.vec[ch]) {  // 8 lanes per row, a float4 each: 4 rows per warp
      const int qq = lane & 7;
      if (4 * qq >= kn) return;
      for (int i = warp * 4 + (lane >> 3); i < band.nw; i += kThreads / 8)
        g4d::cp_async16(dst + i * kPitchW + 4 * qq,
                        src + (size_t)wrap(v0 + band.lo + i, V) * width + 4 * qq);
    } else if (lane < kn) {  // a lane per channel
      for (int i = warp; i < band.nw; i += kThreads / 32)
        g4d::cp_async4(dst + i * kPitchW + lane,
                       src + (size_t)wrap(v0 + band.lo + i, V) * width + lane);
    }
  };

  load_vals(vs, vals, band, V, v0);
  issue(0);
  g4d::cp_async_commit();

  const int nct = FT / 8;
  const bool has = (int)threadIdx.x < 16 * nct;
  int rt = 0, ct = 0;
  if (has) g4d::item_tile(threadIdx.x, nct, nct % 8 == 0, rt, ct);
  float acc[kRows][8];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int kn = chunks.kn[ch];
    if (ch + 1 < n_chunks) {
      issue(ch + 1);
      g4d::cp_async_commit();
      g4d::cp_async_wait<1>();
    } else {
      g4d::cp_async_wait<0>();
    }
    __syncthreads();
    if (band.nw > 0) {
      // banded sums from the window: thread = (vertex, 16 channels)
      const int v = threadIdx.x & (kTileV - 1);
      const int c0 = (threadIdx.x / kTileV) * 16;
      const float* src = win + (ch & 1) * band.nw * kPitchW + (v - band.lo) * kPitchW + c0;
      float s[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) s[c] = 0.f;
      for (int d = 0; d < band.D; ++d) {
        const float val = vs[d * kTileV + v];
        const float* row = src + band.soff[d] * kPitchW;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(row + 4 * q);
          s[4 * q] = fmaf(val, x.x, s[4 * q]);
          s[4 * q + 1] = fmaf(val, x.y, s[4 * q + 1]);
          s[4 * q + 2] = fmaf(val, x.z, s[4 * q + 2]);
          s[4 * q + 3] = fmaf(val, x.w, s[4 * q + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) at[(c0 + c) * kPitchA + v] = s[c];
    } else if (lane < kn) {
      // banded sums from L2: warp = vertices, lane = channel
      const int width = pc.width[chunks.piece[ch]];
      const float* src =
          pc.ptr[chunks.piece[ch]] + (size_t)b * V * width + chunks.off[ch] + lane;
      for (int v = warp; v < kTileV; v += kThreads / 32) {
        float s = 0.f;
        if (v0 + v < V) {
          for (int d = 0; d < band.D; ++d) {
            int u = v0 + v + band.off[d];
            if (u >= V) u -= V;
            s = fmaf(vs[d * kTileV + v], __ldg(src + (size_t)u * width), s);
          }
        }
        at[lane * kPitchA + v] = s;
      }
    }
    __syncthreads();
    if (has)
      g4d::tile_fma<8>(at + rt * kRows, kPitchA, wc + (ch & 1) * kKc * FT + ct * 8, FT, kn,
                       acc);
    __syncthreads();
  }

  if (!has) return;
  const int c0 = f0 + ct * 8;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bv[j] = __ldg(bias + c0 + j);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int v = v0 + rt * kRows + i;
    if (v >= V) break;
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j] = acc[i][j] + bv[j];
      if (relu) o[j] = g4d::max_nan(o[j], 0.f);
    }
    float* dst = out + ((size_t)b * V + v) * F + c0;
    if (F % 4 == 0 && c0 + 8 <= F) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < F) dst[j] = o[j];
    }
  }
}

constexpr int kRowLanes = 8;  // lanes of a warp per input row in the narrow kernel

// (h[u] . W[:, f]) for f < 4 of input row u, summed over a group of 8 lanes
// (4 rows per warp at once): each lane takes channels g, g + 8, ... of every
// piece; the lanes' partials are combined by a shuffle tree within the
// group. ws: (K, 4) in shared memory.
__device__ __forceinline__ float4 row_dot(const Pieces& pc, const float* ws, int b, int V,
                                          int u, int g) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  int kb = 0;
  for (int q = 0; q < pc.n; ++q) {
    const int width = pc.width[q];
    const float* src = pc.ptr[q] + ((size_t)b * V + u) * width;
    for (int k = g; k < width; k += kRowLanes) {
      const float x = __ldg(src + k);
      const float4 w4 = *reinterpret_cast<const float4*>(ws + (kb + k) * 4);
      p[0] = fmaf(x, w4.x, p[0]);
      p[1] = fmaf(x, w4.y, p[1]);
      p[2] = fmaf(x, w4.z, p[2]);
      p[3] = fmaf(x, w4.w, p[3]);
    }
    kb += width;
  }
#pragma unroll
  for (int o = kRowLanes / 2; o > 0; o >>= 1)
#pragma unroll
    for (int f = 0; f < 4; ++f) p[f] += __shfl_xor_sync(0xffffffffu, p[f], o);
  return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store_narrow(float* dst, const float (&s)[4], const float (&bv)[4],
                                             int F, int relu) {
  for (int f = 0; f < F; ++f) dst[f] = relu ? g4d::max_nan(s[f] + bv[f], 0.f) : s[f] + bv[f];
}

__global__ void __launch_bounds__(kThreads)
gcn_narrow_kernel(const __grid_constant__ Pieces pc, int V, int K,
                  const float* __restrict__ vals, const __grid_constant__ Band band,
                  const float* __restrict__ w, const float* __restrict__ bias, int F,
                  int relu, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // (K, 4)
  float* vs = ws + K * 4;                       // (D, kTileV)
  float* uw = vs + band.D * kTileV;             // (nw, 4): h @ W of the window rows
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTileV;
  const int g = threadIdx.x % kRowLanes;        // lane within the row group
  const int row = threadIdx.x / kRowLanes;      // the group: 32 rows in flight per block
  constexpr int kGroups = kThreads / kRowLanes;
  for (int e = threadIdx.x; e < K * 4; e += kThreads) ws[e] = __ldg(w + e);
  load_vals(vs, vals, band, V, v0);
  __syncthreads();
  float bv[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) bv[f] = __ldg(bias + f);
  if (band.nw > 0) {
    // every warp runs the same number of row_dot calls (their shuffles need
    // all lanes); groups past the window compute a row again and drop it
    for (int i0 = 0; i0 < band.nw; i0 += kGroups) {
      const int i = min(i0 + row, band.nw - 1);
      const float4 r = row_dot(pc, ws, b, V, wrap(v0 + band.lo + i, V), g);
      if (g == 0 && i0 + row < band.nw) *reinterpret_cast<float4*>(uw + i * 4) = r;
    }
    __syncthreads();
    if (threadIdx.x >= kTileV || v0 + (int)threadIdx.x >= V) return;
    const int v = threadIdx.x;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < band.D; ++d) {
      const float val = vs[d * kTileV + v];
      const float4 r = *reinterpret_cast<const float4*>(uw + (v - band.lo + band.soff[d]) * 4);
      s[0] = fmaf(val, r.x, s[0]);
      s[1] = fmaf(val, r.y, s[1]);
      s[2] = fmaf(val, r.z, s[2]);
      s[3] = fmaf(val, r.w, s[3]);
    }
    store_narrow(out + ((size_t)b * V + v0 + v) * F, s, bv, F, relu);
    return;
  }
  // wide offsets: a row group per vertex, each neighbour row's dot from L2
  for (int v1 = 0; v1 < kTileV; v1 += kGroups) {
    const int v = v1 + row;
    const bool live = v0 + v < V;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < band.D; ++d) {
      int u = (live ? v0 + v : 0) + band.off[d];
      if (u >= V) u -= V;
      const float val = vs[d * kTileV + v];
      const float4 r = row_dot(pc, ws, b, V, u, g);
      s[0] = fmaf(val, r.x, s[0]);
      s[1] = fmaf(val, r.y, s[1]);
      s[2] = fmaf(val, r.z, s[2]);
      s[3] = fmaf(val, r.w, s[3]);
    }
    if (live && g == 0) store_narrow(out + ((size_t)b * V + v0 + v) * F, s, bv, F, relu);
  }
}

}  // namespace

// Pieces ptrs[i] (B, V, widths[i]) f32, n_pieces in 1..8, K = sum(widths);
// chunk_ints: n_chunks x (piece, offset in it, first channel, channels <= 32,
// 16-byte aligned) covering K in order (ops/graph.py:_gcn_chunks);
// vals (D, V) f32 with vals[d, v] = adj[v, (v + offsets[d]) mod V], D in
// 1..64, offsets in [0, V) and soffsets the same signed (offsets[d] or
// offsets[d] - V), lo their least, nw the window rows (128 + the signed
// span; 0: no window); w (K, Fp) row-major, zero columns past F, bias (Fp,),
// both 16-byte aligned; FT the output columns of a block (Fp a multiple of
// FT, FT a multiple of 8 up to 128), or Fp = 4 for the narrow kernel (F <=
// 4); smem_bytes of the plan (ops/graph.py:_gcn_plan) -> out (B, V, F).
extern "C" int g4d_gcn_layer(const void* const* ptrs, const int* widths, int n_pieces,
                             const int* chunk_ints, int n_chunks, int B, int V, int K,
                             const float* vals, const int* offsets, const int* soffsets, int D,
                             int lo, int nw, const float* w, const float* bias, int F, int Fp,
                             int FT, int relu, int smem_bytes, float* out,
                             cudaStream_t stream) {
  if (n_pieces < 1 || n_pieces > kMaxPieces || D < 1 || D > kMaxDiags || F < 1 || F > Fp ||
      nw < 0)
    return (int)cudaErrorInvalidValue;
  const bool narrow = Fp == 4;
  if (!narrow && (FT % 8 != 0 || FT > kTileF || Fp % FT != 0)) return (int)cudaErrorInvalidValue;
  Pieces pc = {};
  int total = 0;
  for (int i = 0; i < n_pieces; ++i) {
    pc.ptr[i] = static_cast<const float*>(ptrs[i]);
    pc.width[i] = widths[i];
    total += widths[i];
  }
  pc.n = n_pieces;
  if (total != K || n_chunks < 1 || n_chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  Chunks chunks = {};
  int k_next = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const int* ci = chunk_ints + 5 * c;  // piece, offset, first channel, channels, vec
    if (ci[0] < 0 || ci[0] >= n_pieces || ci[2] != k_next || ci[3] < 1 || ci[3] > kKc ||
        ci[1] < 0 || ci[1] + ci[3] > widths[ci[0]] ||
        (ci[4] && (ci[1] % 4 != 0 || ci[3] % 4 != 0 || widths[ci[0]] % 4 != 0)))
      return (int)cudaErrorInvalidValue;
    chunks.piece[c] = ci[0];
    chunks.off[c] = ci[1];
    chunks.kb[c] = ci[2];
    chunks.kn[c] = ci[3];
    chunks.vec[c] = ci[4];
    k_next += ci[3];
  }
  chunks.n = n_chunks;
  if (k_next != K) return (int)cudaErrorInvalidValue;
  Band band = {};
  for (int d = 0; d < D; ++d) {
    if (offsets[d] < 0 || offsets[d] >= V || (soffsets[d] - offsets[d]) % V != 0 ||
        (nw > 0 && (soffsets[d] < lo || soffsets[d] - lo > nw - kTileV)))
      return (int)cudaErrorInvalidValue;
    band.off[d] = offsets[d];
    band.soff[d] = soffsets[d];
  }
  band.D = D;
  band.lo = lo;
  band.nw = nw;
  if (B == 0 || V == 0) return (int)cudaSuccess;
  const dim3 grid(g4d_blocks(V, kTileV), B, narrow ? 1 : Fp / FT);
  cudaError_t err;
  if (narrow) {
    err = cudaFuncSetAttribute(gcn_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    gcn_narrow_kernel<<<grid, kThreads, smem_bytes, stream>>>(pc, V, K, vals, band, w, bias,
                                                              F, relu, out);
  } else {
    err = cudaFuncSetAttribute(gcn_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    gcn_tile_kernel<<<grid, kThreads, smem_bytes, stream>>>(pc, chunks, V, vals, band, w, bias,
                                                            F, Fp, FT, relu, out);
  }
  return (int)cudaGetLastError();
}
