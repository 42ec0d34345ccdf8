// Backward of the posed stage's positional-encoding (PE) block. The forward
// is
//   out[b, m, :] = max_s (relu(qg[b, m, s] @ k0 + b0) @ k1 + b1),
//   qg[b, m, s] = table[b, idx[b, m, s], :] - pad(center[b, m]) (xyz only),
// and given its cotangent cot (B, M, G) this computes dcenters (B, M, 3) and
// the gradients of k0 (C, F), b0 (F), k1 (F, G) and b1 (G). With the dtable
// half on (a `dqg` output), it also writes each slot's row gradient
// dqg[b, m, s] = dh1[b, m, s] @ k0^T (B, M*S, C); the wrapper sums those into
// dtable (B, N, C) with the deterministic scatter-add (scatter_add.cu).
//
// Replaces garment4d_tpu/ops/pallas/fusedpe.py:fused_pe_bwd_pallas
// (pallas_call at :616, body _pe_bwd_kernel at :423), both halves: with
// table_grad=False and, through `dqg` plus the scatter-add, with
// table_grad=True. The TPU kernel summed dtable in VMEM with a one-hot MXU
// product; here the row gradients leave the block and the scatter-add sums
// them in ascending slot order, no atomics, so dtable too is bitwise
// repeatable. Without `dqg` (a null pointer, the posed train step's frozen
// tables) the kernel does exactly what it did before.
//
// What bounds it on the H100: the fp32 FMAs on the CUDA cores; the bytes (one
// read of the gathered rows, the cotangent and the weights, one write of
// dcenters) are far less. The function needs C*F + F*G FMAs per sample row
// for the recompute of both layers, but dh2 is sparse after the routing (G
// non-zeros per center, ties aside), so dh1 = dh2 @ k1^T and dk1 need F*G
// per center and dk0 only the rows of the slots that won a channel. This
// kernel still forms those three products densely over all S slots, about
// 2x the work the data needs at S = 32. The TPU kernel accumulated
// the weight gradients in VMEM across its sequential grid; on the card the
// blocks run in no order, so each of a FIXED number of blocks walks its
// tiles of Gc centers in a fixed order and keeps its share of the weight
// gradients in registers across them, and a second kernel sums the blocks'
// partials in block order: no atomics, the same bits on every run. Per tile
// the block gathers the Gc*S rows into shared memory, recomputes hpre, h and
// h2 = h @ k1 there (b1 is constant over S, so it drops out of the routing),
// routes cot / (count of exact ties) to every slot that attains the max over
// S (the JAX reduce_max VJP), then backprops: dh1 = (dh2 @ k1^T) * [hpre > 0]
// in place of hpre, dk1 += h^T dh2, dk0 += qg^T dh1, db0 += sum dh1,
// db1 += sum cot, and dcenters = -sum_s (dh1 @ k0[:3]^T). No (S, width)
// intermediate reaches device memory. In the row-wise products each
// thread computes 4 adjacent outputs (16 FMAs per 5 float4 loads); the
// weight gradients are 4x4 register blocks (16 FMAs per 2 float4 loads),
// with the rows split among threads when the blocks are few; a row's xyz
// rows of dqg are one warp's shuffle sum.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDk0 = 4;  // 4x4 register blocks of dk0 a thread may own: ceil(C/4)*F/4 <= 4*256
constexpr int kMaxDk1 = 1;  // of dk1: F*G/16 <= 256
constexpr int kRed = 16 * kThreads;  // floats of the partition-combine buffer

struct PeDims {
  int N, C, Pc, M, S, F, G, Gc;
};

// A weight gradient sum_r a[r, :]^T b[r, :] over the rows of every tile, in
// 4x4 register blocks: block (i, j) covers a-columns 4i..4i+3 and b-columns
// 4j..4j+3 and belongs to the units (block, part) that sum the rows
// r = part (mod parts). With few blocks (a narrow table) the rows are split
// into `parts` partitions, combined in order at the end.
struct Outer {
  int n_items;  // 4x4 blocks
  int n_b4;     // groups of 4 b-columns
  int parts;    // row partitions, a power of 2 with n_items * parts <= kThreads
};

__host__ __device__ inline Outer make_outer(int a_cols4, int b_cols) {
  Outer o = {a_cols4 * (b_cols / 4), b_cols / 4, 1};
  while (2 * o.parts * o.n_items <= kThreads) o.parts *= 2;
  return o;
}

template <int kMax, bool kRelu>
__device__ __forceinline__ void outer_acc(float (&acc)[kMax][16], const Outer& o,
                                          const float* a, int lda, const float* b,
                                          int ldb, int R, int tid) {
  int ai[kMax], bi[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    const int item = (tid + j * kThreads) / o.parts;
    ai[j] = item / o.n_b4 * 4;
    bi[j] = (item % o.n_b4) * 4;
  }
  const int n_units = o.n_items * o.parts;
#pragma unroll 2
  for (int r = tid % o.parts; r < R; r += o.parts) {
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (tid + j * kThreads < n_units) {
        float4 x = *reinterpret_cast<const float4*>(a + r * lda + ai[j]);
        if (kRelu) {
          x.x = fmaxf(x.x, 0.f);
          x.y = fmaxf(x.y, 0.f);
          x.z = fmaxf(x.z, 0.f);
          x.w = fmaxf(x.w, 0.f);
        }
        const float4 y = *reinterpret_cast<const float4*>(b + r * ldb + bi[j]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][u * 4 + v] = fmaf(xs[u], ys[v], acc[j][u * 4 + v]);
      }
    }
  }
}

// dst[i * ld + k] for i < rows: the sum over parts, in order, of the units'
// sums (every thread calls it)
template <int kMax>
__device__ __forceinline__ void outer_store(const float (&acc)[kMax][16], const Outer& o,
                                            float* red, float* dst, int rows, int tid) {
  const int n_units = o.n_items * o.parts;
  const int ld = o.n_b4 * 4;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    const int unit = tid + j * kThreads;
    if (unit >= n_units) continue;
    const int item = unit / o.parts;
    const int i0 = item / o.n_b4 * 4, k0 = (item % o.n_b4) * 4;
    if (o.parts == 1) {
      for (int u = 0; u < 4 && i0 + u < rows; ++u)
        *reinterpret_cast<float4*>(dst + (i0 + u) * ld + k0) = make_float4(
            acc[j][u * 4], acc[j][u * 4 + 1], acc[j][u * 4 + 2], acc[j][u * 4 + 3]);
    } else {
      for (int e = 0; e < 16; ++e) red[unit * 16 + e] = acc[j][e];
    }
  }
  if (o.parts == 1) return;
  __syncthreads();
  for (int e = tid; e < o.n_items * 16; e += kThreads) {
    const int item = e / 16, k = e - item * 16;
    const int i = item / o.n_b4 * 4 + k / 4;
    if (i >= rows) continue;
    float s = 0.f;
    for (int p = 0; p < o.parts; ++p) s += red[(item * o.parts + p) * 16 + k];
    dst[i * ld + (item % o.n_b4) * 4 + k % 4] = s;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

__global__ void __launch_bounds__(kThreads, 2)
pe_bwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              const float* __restrict__ centers, const float* __restrict__ k0,
              const float* __restrict__ b0, const float* __restrict__ k1,
              const float* __restrict__ cot, PeDims d, int n_tiles,
              float* __restrict__ dcenters, float* __restrict__ partials,
              const float* __restrict__ k0t, float* __restrict__ dqg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = d.C, Pc = d.Pc, F = d.F, G = d.G, S = d.S, M = d.M, Gc = d.Gc;
  const int F4 = F / 4, G4 = G / 4;
  const int R = Gc * S;
  float* qg = smem;              // (R, Pc) gathered, centred rows, zero pads
  float* hp = qg + R * Pc;       // (R, F) hpre, then dh1
  float* h2 = hp + R * F;        // (R, G) h @ k1, then dh2
  float* k1s = h2 + R * G;       // (F, G) k1
  float* k1t = k1s + F * G;      // (G, F) k1^T
  float* k0x = k1t + G * F;      // (3, F) the xyz rows of k0
  float* dq = k0x + 3 * F;       // (R, 4) dh1 @ k0[:3]^T
  float* red = dq + R * 4;       // kRed floats
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int lpr = Pc <= 4 ? 4 : Pc <= 8 ? 8 : Pc <= 16 ? 16 : 32;  // gather lanes per row

  for (int e = tid; e < F * G; e += kThreads) {
    const float w = __ldg(k1 + e);
    k1s[e] = w;
    k1t[(e % G) * F + e / G] = w;
  }
  for (int e = tid; e < 3 * F; e += kThreads) k0x[e] = __ldg(k0 + e);
  const Outer o0 = make_outer(Pc / 4, F), o1 = make_outer(F4, G);
  float acc0[kMaxDk0][16] = {}, acc1[kMaxDk1][16] = {};
  // db0: thread (f, part) sums the rows r = part (mod db_parts) of column f
  const int db_parts = kThreads / F;
  const int db_f = tid % F, db_part = tid / F;
  float acc_db0 = 0.f, acc_db1 = 0.f;
  const int tiles_per_b = (M + Gc - 1) / Gc;
  __syncthreads();

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_b;
    const int m0 = (t - b * tiles_per_b) * Gc;

    // gather the rows, `lpr` lanes per row; subtract each center on xyz
    for (int r = warp * (32 / lpr) + lane / lpr; r < R; r += kWarps * (32 / lpr)) {
      const int m = m0 + r / S;
      float* q = qg + r * Pc;
      if (m >= M) {
        for (int c = lane % lpr; c < Pc; c += lpr) q[c] = 0.f;
        continue;
      }
      const int j = __ldg(idx + ((size_t)b * M + m) * S + (r % S));
      const bool ok = (unsigned)j < (unsigned)d.N;
      const float* row = table + ((size_t)b * d.N + (ok ? j : 0)) * C;
      for (int c = lane % lpr; c < Pc; c += lpr) {
        float v = 0.f;
        if (c < C) {
          v = ok ? __ldg(row + c) : __int_as_float(0x7fc00000);
          if (c < 3) v -= __ldg(centers + ((size_t)b * M + m) * 3 + c);
        }
        q[c] = v;
      }
    }
    __syncthreads();

    // hpre = qg @ k0 + b0: the products in ascending c (k0 arrives padded
    // with zero rows to Pc), then the bias, in the plain version's order
    // (matmul, then + b0), so that the max over S routes as it does there:
    // in another order fp32 rounding moves the max of nearly tied slots
    // to the other slot
    for (int e = tid; e < R * F4; e += kThreads) {
      const int r = e / F4;
      const int f0 = (e - r * F4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* q = qg + r * Pc;
      for (int c = 0; c < Pc; c += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q + c);
        fma4(a, q4.x, __ldg(reinterpret_cast<const float4*>(k0 + (size_t)c * F + f0)));
        fma4(a, q4.y, __ldg(reinterpret_cast<const float4*>(k0 + (size_t)(c + 1) * F + f0)));
        fma4(a, q4.z, __ldg(reinterpret_cast<const float4*>(k0 + (size_t)(c + 2) * F + f0)));
        fma4(a, q4.w, __ldg(reinterpret_cast<const float4*>(k0 + (size_t)(c + 3) * F + f0)));
      }
      const float4 bias = __ldg(reinterpret_cast<const float4*>(b0 + f0));
      *reinterpret_cast<float4*>(hp + r * F + f0) =
          make_float4(a.x + bias.x, a.y + bias.y, a.z + bias.z, a.w + bias.w);
    }
    __syncthreads();

    // h2 = relu(hpre) @ k1
    for (int e = tid; e < R * G4; e += kThreads) {
      const int r = e / G4;
      const int g0 = (e - r * G4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* h = hp + r * F;
      for (int f = 0; f < F; f += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(h + f);
        fma4(a, fmaxf(h4.x, 0.f), *reinterpret_cast<const float4*>(k1s + f * G + g0));
        fma4(a, fmaxf(h4.y, 0.f), *reinterpret_cast<const float4*>(k1s + (f + 1) * G + g0));
        fma4(a, fmaxf(h4.z, 0.f), *reinterpret_cast<const float4*>(k1s + (f + 2) * G + g0));
        fma4(a, fmaxf(h4.w, 0.f), *reinterpret_cast<const float4*>(k1s + (f + 3) * G + g0));
      }
      *reinterpret_cast<float4*>(h2 + r * G + g0) = a;
    }
    __syncthreads();

    // route the cotangent: cot / count to every slot tied at the max
    for (int e = tid; e < Gc * G; e += kThreads) {
      const int gi = e / G;
      const int g = e - gi * G;
      const int m = m0 + gi;
      float* col = h2 + gi * S * G + g;
      const float ct = m < M ? __ldg(cot + ((size_t)b * M + m) * G + g) : 0.f;
      float mx = col[0];
      for (int s = 1; s < S; ++s) mx = fmaxf(mx, col[s * G]);
      int cnt = 0;
      for (int s = 0; s < S; ++s) cnt += col[s * G] == mx;
      const float share = ct / (float)cnt;
      for (int s = 0; s < S; ++s) col[s * G] = col[s * G] == mx ? share : 0.f;
    }
    if (tid < G) {
      for (int gi = 0; gi < Gc && m0 + gi < M; ++gi)
        acc_db1 += __ldg(cot + ((size_t)b * M + m0 + gi) * G + tid);
    }
    __syncthreads();

    // dk1 += relu(hpre)^T dh2
    outer_acc<kMaxDk1, true>(acc1, o1, hp, F, h2, G, R, tid);
    __syncthreads();

    // dh1 = (dh2 @ k1^T) * [hpre > 0], in place of hpre
    for (int e = tid; e < R * F4; e += kThreads) {
      const int r = e / F4;
      const int f0 = (e - r * F4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* dh = h2 + r * G;
      for (int g = 0; g < G; g += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dh + g);
        fma4(a, d4.x, *reinterpret_cast<const float4*>(k1t + g * F + f0));
        fma4(a, d4.y, *reinterpret_cast<const float4*>(k1t + (g + 1) * F + f0));
        fma4(a, d4.z, *reinterpret_cast<const float4*>(k1t + (g + 2) * F + f0));
        fma4(a, d4.w, *reinterpret_cast<const float4*>(k1t + (g + 3) * F + f0));
      }
      float4* out = reinterpret_cast<float4*>(hp + r * F + f0);
      const float4 pre = *out;
      *out = make_float4(pre.x > 0.f ? a.x : 0.f, pre.y > 0.f ? a.y : 0.f,
                         pre.z > 0.f ? a.z : 0.f, pre.w > 0.f ? a.w : 0.f);
    }
    __syncthreads();

    // dk0 += qg^T dh1; db0 += dh1; dq = dh1 @ k0[:3]^T per row, one warp
    // per row, a shuffle sum over the lanes' columns
    outer_acc<kMaxDk0, false>(acc0, o0, qg, Pc, hp, F, R, tid);
    if (db_part < db_parts) {
      for (int r = db_part; r < R; r += db_parts) acc_db0 += hp[r * F + db_f];
    }
    for (int r = warp; r < R; r += kWarps) {
      float p0 = 0.f, p1 = 0.f, p2 = 0.f;
      for (int f = lane; f < F; f += 32) {
        const float v = hp[r * F + f];
        p0 = fmaf(k0x[f], v, p0);
        p1 = fmaf(k0x[F + f], v, p1);
        p2 = fmaf(k0x[2 * F + f], v, p2);
      }
      for (int w = 16; w > 0; w /= 2) {
        p0 += __shfl_xor_sync(0xffffffffu, p0, w);
        p1 += __shfl_xor_sync(0xffffffffu, p1, w);
        p2 += __shfl_xor_sync(0xffffffffu, p2, w);
      }
      if (lane == 0) {
        dq[r * 4] = p0;
        dq[r * 4 + 1] = p1;
        dq[r * 4 + 2] = p2;
      }
    }
    // the dtable half: row gradients dqg = dh1 @ k0^T, summed in ascending
    // f, one thread per (row, channel) with the channels of a row on
    // neighbouring threads: the k0^T row reads (from L1/L2) and the dqg
    // writes are coalesced, dh1 is a shared-memory broadcast
    if (dqg != nullptr) {
      for (int e = tid; e < R * C; e += kThreads) {
        const int r = e / C;
        const int c = e - r * C;
        const int m = m0 + r / S;
        if (m >= M) continue;
        const float* dh = hp + r * F;
        float a = 0.f;
        for (int f = 0; f < F; ++f) a = fmaf(dh[f], __ldg(k0t + (size_t)f * d.Pc + c), a);
        dqg[(((size_t)b * M + m) * S + r % S) * C + c] = a;
      }
    }
    __syncthreads();

    // dcenters = -sum_s dq
    for (int e = tid; e < Gc * 3; e += kThreads) {
      const int gi = e / 3;
      const int j = e - gi * 3;
      const int m = m0 + gi;
      if (m >= M) continue;
      float tot = 0.f;
      for (int s = 0; s < S; ++s) tot += dq[(gi * S + s) * 4 + j];
      dcenters[((size_t)b * M + m) * 3 + j] = -tot;
    }
    // the next tile's gather writes qg only, which no thread reads now
  }

  // this block's partials: dk0 (C, F) | db0 (F) | dk1 (F, G) | db1 (G)
  float* part = partials + (size_t)blockIdx.x * (C * F + F + F * G + G);
  outer_store<kMaxDk0>(acc0, o0, red, part, C, tid);
  outer_store<kMaxDk1>(acc1, o1, red, part + C * F + F, F, tid);
  __syncthreads();
  if (db_part < db_parts) red[db_part * F + db_f] = acc_db0;
  __syncthreads();
  if (tid < F) {
    float s = 0.f;
    for (int p = 0; p < db_parts; ++p) s += red[p * F + tid];
    part[C * F + tid] = s;
  }
  if (tid < G) part[C * F + F + F * G + tid] = acc_db1;
}

// out[e] = sum over blocks p, in order, of partials[p, e]
__global__ void pe_bwd_reduce_kernel(const float* __restrict__ partials,
                                     int n_blocks, int n_acc,
                                     float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_acc) return;
  float a = 0.f;
  for (int p = 0; p < n_blocks; ++p) a += partials[(size_t)p * n_acc + e];
  out[e] = a;
}

}  // namespace

// table (B, N, C), idx (B, M, S) i32, centers (B, M, 3), k0 (Pc, F) with
// Pc = C rounded up to 4 (zero rows past C), b0 (F), k1 (F, G), cot
// (B, M, G); F and G multiples of 4, F <= 256, Pc*F/16 <= 4*256,
// F*G/16 <= 256; Gc centers per tile; n_blocks blocks of the first kernel;
// smem_bytes = (Gc*S*(Pc + F + G + 4) + 2*F*G + 3*F + 4096) * 4 ->
// dcenters (B, M, 3);
// partials (n_blocks, n_acc) scratch; sums (n_acc) = dk0 (C, F) | db0 (F) |
// dk1 (F, G) | db1 (G), n_acc = C*F + F + F*G + G; dqg (B, M*S, C) the row
// gradients and k0t (F, Pc) = k0^T, or both null to skip the dtable half.
extern "C" int g4d_pe_bwd(const float* table, const int* idx,
                          const float* centers, const float* k0,
                          const float* b0, const float* k1, const float* cot,
                          int B, int N, int C, int M, int S, int F, int G,
                          int Gc, int n_blocks, int smem_bytes, float* dcenters,
                          float* partials, float* sums, const float* k0t,
                          float* dqg, cudaStream_t stream) {
  if (C < 3 || S < 1 || F < 4 || G < 4 || F % 4 || G % 4 || F > kThreads ||
      (dqg != nullptr) != (k0t != nullptr) ||
      Gc < 1 || n_blocks < 1 || (C + 3) / 4 * (F / 4) > kMaxDk0 * kThreads ||
      F * G / 16 > kMaxDk1 * kThreads)
    return (int)cudaErrorInvalidValue;
  const int n_acc = C * F + F + F * G + G;
  const int n_tiles = B * ((M + Gc - 1) / Gc);
  PeDims d = {N, C, (C + 3) & ~3, M, S, F, G, Gc};
  cudaError_t err = cudaFuncSetAttribute(
      pe_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  pe_bwd_kernel<<<n_blocks, kThreads, smem_bytes, stream>>>(
      table, idx, centers, k0, b0, k1, cot, d, n_tiles, dcenters, partials, k0t, dqg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pe_bwd_reduce_kernel<<<g4d_blocks(n_acc, kThreads), kThreads, 0, stream>>>(
      partials, n_blocks, n_acc, sums);
  return (int)cudaGetLastError();
}
