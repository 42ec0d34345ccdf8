// Backward of the posed stage's positional-encoding (PE) block. The forward
// is
//   out[b, m, :] = max_s (relu(qg[b, m, s] @ k0 + b0) @ k1 + b1),
//   qg[b, m, s] = table[b, idx[b, m, s], :] - pad(center[b, m]) (xyz only),
// and given its cotangent cot (B, M, G) this computes dcenters (B, M, 3) and
// the gradients of k0 (C, F), b0 (F), k1 (F, G) and b1 (G). With the dtable
// half on (a `dqg` output), it also writes the row gradient
// dqg[b, m, s] = dh1[b, m, s] @ k0^T (B, M*S, C) of every slot that won a
// channel, and idx_w (B, M*S): the slot's table row, or -1 for a slot that
// won none; the wrapper sums those rows into dtable (B, N, C) with the
// deterministic scatter-add (scatter_add.cu), which drops the -1 rows.
//
// Replaces garment4d_tpu/ops/pallas/fusedpe.py:fused_pe_bwd_pallas
// (pallas_call at :616, body _pe_bwd_kernel at :423), both halves: with
// table_grad=False and, through `dqg` plus the scatter-add, with
// table_grad=True. The TPU kernel accumulated the weight gradients in VMEM
// across its sequential grid and summed dtable with a one-hot MXU product.
// On the card the blocks run in no order, so each of a FIXED number of
// blocks walks its tiles of Gc centers in a fixed order and keeps its share
// of the weight gradients in registers across them, and a second kernel
// sums the blocks' partials in block order: no atomics on floats, the same
// bits on every run.
//
// What bounds it on the H100: the fp32 FMAs of the recompute on the CUDA
// cores, C*F + F*G per sample row; the bytes (one read of the gathered rows,
// the cotangent and the weights, one write of dcenters) are far less. After
// the routing dh2 holds one non-zero per (center, channel), ties aside, so
// the backward needs F*G per center for dh1 and dk1 and C*F only per slot
// that won a channel for dk0. The design keeps the recompute dense and
// register-tiled and makes the backward sparse:
//  1. The tile's table indices first, then its rows gathered into shared
//     memory with 16 independent loads in flight per thread. Slots of a
//     center with equal indices (the ball query repeats its first hit) are
//     exact copies: equal rows, equal routing. Only the first copy of each
//     index routes; it stands for its copies (`copies`: their count), so a
//     center with few distinct neighbours costs few rows.
//  2. hpre = qg @ k0 + b0 and h2 = relu(hpre) @ k1, k1 (and k0, unless the
//     table is so wide that k0 is read through L1 to leave room for more
//     rows per tile) in shared memory, each thread a register tile of up to
//     4 rows x 4 channels (rows q, q + R/TR, ...: neighbouring lanes read
//     neighbouring rows, padded pitches put them on other banks). Each
//     output sums its products in ascending c from 0.0 and adds the bias
//     last, the plain version's order (matmul, then + b0), so that the max
//     over S routes as it does there; b1 is constant over S and drops out.
//  3. The route: one thread per (center, channel) scans S once for the max
//     and the bit mask of the slots at it (the share cot / (number of exact
//     ties) is the JAX reduce_max VJP). A slot routes only if it is a first
//     copy and some unit of its hpre is positive (a row without one adds
//     exact zeros everywhere). Each routed (slot, channel) sets the
//     channel's bit in its row's mask.
//  4. From the routed non-zeros only: dk1[:, g] += share * copies *
//     relu(hpre[s*]), one thread per (f, g) over the tile's centers (the
//     first routed slot kept per (center, channel), the tied ones in a
//     mask); dh1[s] = sum over the row's channel bits, in ascending g, of
//     share * k1[:, g]^T, masked by hpre > 0, one thread per (row, 4
//     columns).
//  5. Over the rows that won a channel (a list in ascending order, which
//     every warp builds alike with ballots): dk0 += (copies * qg)^T dh1 in
//     4x4 register blocks (the rows split among threads when the blocks
//     are few), db0 += copies * dh1, and with the dtable half dqg for every
//     slot whose first copy won. dcenters = -(sum_s copies * dh1) @ k0[:3]^T
//     from per-center column sums. A slot that won nothing has dh1 = 0, so
//     skipping it keeps every sum.
// No (S, width) intermediate reaches device memory.
#include <climits>

#include "common.cuh"


namespace {

constexpr int kThreads = 256;

struct PeDims {
  // row pitches HP = F + 4 and W2 = max(F, G) + 4 (float4 rows whose
  // neighbours start on other banks); nw = 32-bit words of a slot mask;
  // Sr <= S the real slots, the wrapper's padding past them repeats slot 0
  int N, C, Pc, M, S, F, G, Gc, HP, W2, nw, Sr;
};

// A weight gradient sum_r (copies[r] * a[r, :])^T b[r, :] over listed rows
// of every tile (copies in the low 16 bits),
// in 4x4 register blocks: block (i, j) covers a-columns 4i..4i+3 and
// b-columns 4j..4j+3 and belongs to the units (block, part) that sum the
// listed rows at positions part (mod parts). With few blocks (a narrow
// table) the rows are split into `parts` partitions, combined in order at
// the end.
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

template <int kMax>
__device__ __forceinline__ void outer_acc(float (&acc)[kMax][16], const Outer& o,
                                          const float* a, int lda, const float* b,
                                          int ldb, const int* rows, const int* copies,
                                          int n_rows, int tid) {
  int ai[kMax], bi[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    const int item = (tid + j * kThreads) / o.parts;
    ai[j] = item / o.n_b4 * 4;
    bi[j] = (item % o.n_b4) * 4;
  }
  const int n_units = o.n_items * o.parts;
#pragma unroll 2
  for (int i = tid % o.parts; i < n_rows; i += o.parts) {
    const int r = rows[i];
    const float mu = (float)(copies[r] & 0xffff);
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (tid + j * kThreads < n_units) {
        const float4 x = *reinterpret_cast<const float4*>(a + r * lda + ai[j]);
        const float4 y = *reinterpret_cast<const float4*>(b + r * ldb + bi[j]);
        const float xs[4] = {mu * x.x, mu * x.y, mu * x.z, mu * x.w};
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

// n / d for 0 <= n < 2^16 by one high multiply: m = floor(2^32 / d) + 1
// makes the error n * (m * d - 2^32) / 2^32 < 1 / d (d = 1 is a shift by
// 0). The kernel divides row and (row, column group) indices, below
// R * F/4 < 2^16 whenever a tile's rows fit shared memory.
struct SmallDiv {
  unsigned m;
  int d;
  __device__ explicit SmallDiv(int d_) : m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0u), d(d_) {}
  __device__ __forceinline__ int div(int n) const {
    return d > 1 ? (int)__umulhi((unsigned)n, m) : n;
  }
};

// out[r, :ncols] = act(a[r, :K]) @ w (+ bias, added last) for r < R, all in
// shared memory; thread tile: TR rows (q, q + R/TR, ...) x 4 columns, so
// that the lanes of a warp read neighbouring rows (no bank conflicts at an
// odd row pitch in float4s) and the same w row (a broadcast)
template <int TR, bool kRelu, bool kLdgW>
__device__ __forceinline__ void rows_dot(const float* __restrict__ a, int lda,
                                         const float* __restrict__ w, int ldw, int K,
                                         int R, int ncols, const float* __restrict__ bias,
                                         float* __restrict__ out, int ldo, int* flags,
                                         int tid) {
  const int n_cg = ncols / 4, n_rg = R / TR;
  for (int t = tid; t < n_cg * n_rg; t += kThreads) {
    const int c0 = (t % n_cg) * 4, q = t / n_cg;
    float4 acc[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < K; k += 4) {
      float4 w4[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w4[kk] = kLdgW ? __ldg(reinterpret_cast<const float4*>(w + (k + kk) * ldw + c0))
                       : *reinterpret_cast<const float4*>(w + (k + kk) * ldw + c0);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float4 x = *reinterpret_cast<const float4*>(a + (q + i * n_rg) * lda + k);
        if (kRelu) {
          x.x = fmaxf(x.x, 0.f);
          x.y = fmaxf(x.y, 0.f);
          x.z = fmaxf(x.z, 0.f);
          x.w = fmaxf(x.w, 0.f);
        }
        fma4(acc[i], x.x, w4[0]);
        fma4(acc[i], x.y, w4[1]);
        fma4(acc[i], x.z, w4[2]);
        fma4(acc[i], x.w, w4[3]);
      }
    }
    float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (bias != nullptr) b4 = *reinterpret_cast<const float4*>(bias + c0);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float4 v = acc[i];
      if (bias != nullptr) v = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, v.w + b4.w);
      *reinterpret_cast<float4*>(out + (q + i * n_rg) * ldo + c0) = v;
      if (flags != nullptr && (v.x > 0.f || v.y > 0.f || v.z > 0.f || v.w > 0.f))
        flags[q + i * n_rg] = 1;
    }
  }
}

// the largest row tile up to kMaxTR (4 or 1) that still gives every thread
// one (R % 8 == 0)
template <int kMaxTR, bool kRelu, bool kLdgW>
__device__ __forceinline__ void rows_dot_any(const float* a, int lda, const float* w,
                                             int ldw, int K, int R, int ncols,
                                             const float* bias, float* out, int ldo,
                                             int* flags, int tid) {
  const int n_cg = ncols / 4;
  if (kMaxTR >= 4 && (R / 4) * n_cg >= kThreads)
    rows_dot<kMaxTR, kRelu, kLdgW>(a, lda, w, ldw, K, R, ncols, bias, out, ldo, flags, tid);
  else if (kMaxTR >= 4 && (R / 2) * n_cg >= kThreads)
    rows_dot<(kMaxTR >= 4 ? 2 : 1), kRelu, kLdgW>(a, lda, w, ldw, K, R, ncols, bias, out,
                                                  ldo, flags, tid);
  else
    rows_dot<1, kRelu, kLdgW>(a, lda, w, ldw, K, R, ncols, bias, out, ldo, flags, tid);
}

// D0: 4x4 blocks of dk0 a thread may own, ceil(Pc/4)*F/4 <= D0*kThreads;
// D1: elements of dk1 a thread owns, F*G <= D1*kThreads. With D0 = 4 (a
// wide table) k0 stays in device memory (read through L1) and the row tiles
// stop at 1 row, which keeps the 64 dk0 accumulators in registers.
template <int D0, int D1>
__global__ void __launch_bounds__(kThreads, 2)
pe_bwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
              const float* __restrict__ centers, const float* __restrict__ k0,
              const float* __restrict__ b0, const float* __restrict__ k1,
              const float* __restrict__ cot, PeDims d, int n_tiles,
              float* __restrict__ dcenters, float* __restrict__ partials,
              const float* __restrict__ k0t, float* __restrict__ dqg,
              int* __restrict__ idx_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = d.C, Pc = d.Pc, F = d.F, G = d.G, S = d.S, M = d.M, Gc = d.Gc, Sr = d.Sr;
  const int HP = d.HP, W2 = d.W2, nw = d.nw, G32 = (G + 31) / 32;
  const int R = Gc * S, F4 = F / 4;
  // k0 in shared memory, except for a wide table (D0 = 4), whose k0 the
  // row tiles read through L1, which leaves room for more rows per tile
  constexpr bool kK0Shared = D0 == 1;
  float* k0s = smem;                               // (Pc, F) k0, zero rows past C
  float* k1s = k0s + (kK0Shared ? Pc * F : 0);     // (F, G) k1
  float* k1t = k1s + F * G;      // (G, F) k1^T
  float* qg = k1t + G * F;       // (R, Pc) gathered, centred rows, zero pads
  float* hp = qg + R * Pc;       // (R, HP) hpre
  float* h2 = hp + R * HP;       // (R, W2) h @ k1, then dh1
  float* csum = h2 + R * W2;     // (Gc, F) sum_s copies * dh1
  float* share = csum + Gc * F;  // (Gc, G) cot / ties
  // (Gc, G) the first live slot at the max: its row, -1 for none, -2 - row
  // when more live slots tie with it, and then (S <= 32) their mask
  int* first = reinterpret_cast<int*>(share + Gc * G);
  unsigned* ties = reinterpret_cast<unsigned*>(first + Gc * G);
  unsigned* live = ties + Gc * G;       // (Gc, nw) slots that may route
  unsigned* wonm = live + Gc * nw;      // (Gc, nw) slots that won a channel
  unsigned* rowch = wonm + Gc * nw;     // (R, G32) the channels each row won
  int* jrow = reinterpret_cast<int*>(rowch + R * G32);  // (R) each row's table index
  int* copies = jrow + R;        // (R) first row of the center with its index << 16 | copies
  int* list = copies + R;        // (R) the rows that won, ascending
  float* red = qg;               // 16*kThreads floats, after the last tile
  const float* k0w = kK0Shared ? k0s : k0;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const unsigned below = (1u << lane) - 1;
  const SmallDiv by_s(S), by_f4(F4);
  auto bit = [&](const unsigned* mask, int r) {  // row r's bit of a per-center mask
    const int gi = by_s.div(r), s = r - gi * S;
    return (mask[gi * nw + s / 32] >> (s % 32)) & 1u;
  };
  auto mult = [&](int r) { return copies[r] & 0xffff; };  // 0 for a later copy

  if (kK0Shared)
    for (int e = tid; e < Pc * F; e += kThreads) k0s[e] = __ldg(k0 + e);
  for (int e = tid; e < F * G; e += kThreads) {
    const float w = __ldg(k1 + e);
    k1s[e] = w;
    k1t[(e % G) * F + e / G] = w;
  }
  const Outer o0 = make_outer(Pc / 4, F);
  float acc0[D0][16] = {}, acc1[D1] = {};
  // db0: thread (f, part) sums the listed rows at positions part (mod db_parts)
  const int db_parts = kThreads / F;
  const int db_f = tid % F, db_part = tid / F;
  float acc_db0 = 0.f, acc_db1 = 0.f;
  const int tiles_per_b = (M + Gc - 1) / Gc;
  // a thread's step through the (row, channel) grid of the gather
  const int step_r = kThreads / Pc, step_c = kThreads - step_r * Pc;
  __syncthreads();

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / tiles_per_b;
    const int m0 = (t - b * tiles_per_b) * Gc;
    const int n_m = min(Gc, M - m0);  // centers of this tile

    // 1. the tile's table indices (contiguous in idx; INT_MIN past M)
    for (int r = tid; r < R; r += kThreads)
      jrow[r] = r < n_m * S ? __ldg(idx + ((size_t)b * M + m0) * S + r) : INT_MIN;
    for (int e = tid; e < Gc * nw; e += kThreads) live[e] = wonm[e] = 0u;
    for (int e = tid; e < R * G32; e += kThreads) rowch[e] = 0u;
    __syncthreads();

    // gather, kBatch independent loads in flight per thread, the center
    // subtracted on xyz (an index outside [0, N) reads NaN); the copies of
    // a slot within its center (equal indices: equal rows, equal routing)
    constexpr int kBatch = 16;
    int gr = tid / Pc, gc = tid - (tid / Pc) * Pc;
    for (int e0 = tid; e0 < R * Pc; e0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        v[k] = 0.f;
        if (gr < R) {
          const int j = jrow[gr];
          if (j != INT_MIN && gc < C) {
            v[k] = (unsigned)j < (unsigned)d.N ? __ldg(table + ((size_t)b * d.N + j) * C + gc)
                                               : __int_as_float(0x7fc00000);
            if (gc < 3) v[k] -= __ldg(centers + ((size_t)b * M + m0 + by_s.div(gr)) * 3 + gc);
          }
        }
        gr += step_r;
        gc += step_c;
        if (gc >= Pc) {
          gc -= Pc;
          ++gr;
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (e0 + k * kThreads < R * Pc) qg[e0 + k * kThreads] = v[k];
    }
    for (int r = tid; r < R; r += kThreads) {
      const int gi = by_s.div(r), s = r - gi * S, j = jrow[r];
      int s1 = s, cnt = 0;
      for (int s2 = 0; s2 < S; ++s2) {
        const bool eq = jrow[gi * S + s2] == j;
        cnt += eq && s2 < Sr;  // a pad slot is no copy of its own
        if (eq && s2 < s1) s1 = s2;
      }
      copies[r] = (gi * S + s1) << 16 | (s1 == s ? cnt : 0);
      list[r] = 0;
    }
    __syncthreads();

    // 2. hpre = qg @ k0 + b0, and per row whether a unit is positive (a
    // flag in `list`, which is free until step 5)
    rows_dot_any<(D0 == 1 ? 4 : 1), false, !kK0Shared>(qg, Pc, k0w, F, Pc, R, F, b0, hp, HP,
                                                       list, tid);
    __syncthreads();

    // h2 = relu(hpre) @ k1; the slots that may route: a center's first
    // copy of each index whose hpre has a positive unit (a row without one
    // has h = 0 and dh1 = 0: it adds exact zeros everywhere)
    rows_dot_any<(D0 == 1 ? 4 : 1), true, false>(hp, HP, k1s, G, F, R, G, nullptr, h2, W2,
                                                 nullptr, tid);
    for (int r = tid; r < R; r += kThreads) {
      if (list[r] && mult(r) > 0) {
        const int gi = by_s.div(r), s = r - gi * S;
        atomicOr(live + gi * nw + s / 32, 1u << (s % 32));
      }
    }
    __syncthreads();

    // 3. route: per (center, channel) the slots at the max and the share
    // cot / (their count); the live ones among them (a nonzero share)
    // mark the channel in their rows' masks
    for (int e = tid; e < Gc * G; e += kThreads) {
      const int gi = e / G;
      const int g = e - gi * G;
      const float* col = h2 + gi * S * W2 + g;
      const float ct = gi < n_m ? __ldg(cot + ((size_t)b * M + m0 + gi) * G + g) : 0.f;
      // the slots at the max as bit masks, one word of 32 slots at a time
      // (one pass for S <= 32; NaN never wins); over the real slots only,
      // so that a pad's copy of slot 0 takes no share of a tie
      float mx = __int_as_float(0xff800000);  // -inf
      unsigned bits0 = 0;
      if (nw == 1) {
        for (int s = 0; s < Sr; ++s) {
          const float v = col[s * W2];
          if (v > mx) {
            mx = v;
            bits0 = 1u << s;
          } else if (v == mx) {
            bits0 |= 1u << s;
          }
        }
      } else {
        for (int s = 0; s < Sr; ++s) mx = fmaxf(mx, col[s * W2]);
      }
      auto at_max = [&](int w) {
        if (nw == 1) return bits0;
        unsigned bits = 0;
        for (int s = w * 32; s < min(Sr, w * 32 + 32); ++s)
          bits |= (unsigned)(col[s * W2] == mx) << (s - w * 32);
        return bits;
      };
      int cnt = 0, n_live = 0, r1 = -1;
      for (int w = 0; w < nw; ++w) {
        const unsigned bits = at_max(w), lv = bits & live[gi * nw + w];
        cnt += __popc(bits);
        if (r1 < 0 && lv) r1 = gi * S + w * 32 + __ffs(lv) - 1;
        n_live += __popc(lv);
      }
      const float sh = ct / (float)cnt;
      share[e] = sh;
      first[e] = sh == 0.f || n_live == 0 ? -1 : n_live == 1 ? r1 : -2 - r1;
      ties[e] = nw == 1 ? bits0 & live[gi] : 0u;
      if (sh != 0.f && n_live > 0) {
        for (int w = 0; w < nw; ++w) {
          const unsigned lv = at_max(w) & live[gi * nw + w];
          if (!lv) continue;
          atomicOr(wonm + gi * nw + w, lv);
          for (unsigned bits = lv; bits; bits &= bits - 1) {
            const int r = gi * S + w * 32 + __ffs(bits) - 1;
            atomicOr(rowch + r * G32 + g / 32, 1u << (g % 32));
          }
        }
      }
    }
    if (tid < G) {
      for (int gi = 0; gi < n_m; ++gi)
        acc_db1 += __ldg(cot + ((size_t)b * M + m0 + gi) * G + tid);
    }
    __syncthreads();

    // 4. dk1 += share * copies * relu(hpre[winner]) per owned (f, g) (f on
    // neighbouring lanes: one winner row per warp), in ascending center
    // and slot
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const int e = tid + j * kThreads;
      if (e < F * G) {
        const int g = e / F, f = e - (e / F) * F;
        float a = acc1[j];
#pragma unroll 4
        for (int gi = 0; gi < Gc; ++gi) {
          const int r1 = first[gi * G + g];
          if (r1 >= 0) {
            a = fmaf(share[gi * G + g] * (float)mult(r1), fmaxf(hp[r1 * HP + f], 0.f), a);
          } else if (r1 < -1) {  // tied live slots, in ascending order
            const float sh = share[gi * G + g];
            if (nw == 1) {
              for (unsigned bits = ties[gi * G + g]; bits; bits &= bits - 1) {
                const int r = gi * S + __ffs(bits) - 1;
                a = fmaf(sh * (float)mult(r), fmaxf(hp[r * HP + f], 0.f), a);
              }
            } else {
              for (int r = -2 - r1; r < (gi + 1) * S; ++r)
                if ((rowch[r * G32 + g / 32] >> (g % 32)) & 1u)
                  a = fmaf(sh * (float)mult(r), fmaxf(hp[r * HP + f], 0.f), a);
            }
          }
        }
        acc1[j] = a;
      }
    }
    // dh1 = (dh2 @ k1^T) * [hpre > 0] in place of h2, one thread per (row,
    // 4 columns): the shares of the channels the row won, in ascending g;
    // zeros for a row that won nothing
    for (int e = tid; e < R * F4; e += kThreads) {
      const int r = by_f4.div(e);
      const int f0 = (e - r * F4) * 4;
      const float* shr = share + by_s.div(r) * G;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      bool any = false;
      for (int gw = 0; gw < G32; ++gw) {
        for (unsigned bits = rowch[r * G32 + gw]; bits; bits &= bits - 1) {
          const int g = gw * 32 + __ffs(bits) - 1;
          fma4(a, shr[g], *reinterpret_cast<const float4*>(k1t + g * F + f0));
          any = true;
        }
      }
      if (any) {
        const float4 pre = *reinterpret_cast<const float4*>(hp + r * HP + f0);
        a = make_float4(pre.x > 0.f ? a.x : 0.f, pre.y > 0.f ? a.y : 0.f,
                        pre.z > 0.f ? a.z : 0.f, pre.w > 0.f ? a.w : 0.f);
      }
      *reinterpret_cast<float4*>(h2 + r * W2 + f0) = a;
    }
    __syncthreads();

    // 5. the rows that won, ascending (every warp builds the same list)
    int nwr = 0;
    for (int base = 0; base < R; base += 32) {
      const bool w = base + lane < R && bit(wonm, base + lane);
      const unsigned ball = __ballot_sync(0xffffffffu, w);
      if (w) list[nwr + __popc(ball & below)] = base + lane;
      nwr += __popc(ball);
    }
    __syncwarp();

    // dk0 += (copies * qg)^T dh1 and db0 += copies * dh1 over the won
    // rows; per center the column sums of copies * dh1, for dcenters
    outer_acc<D0>(acc0, o0, qg, Pc, h2, W2, list, copies, nwr, tid);
    if (db_part < db_parts) {
      for (int i = db_part; i < nwr; i += db_parts) {
        const int r = list[i];
        acc_db0 = fmaf((float)mult(r), h2[r * W2 + db_f], acc_db0);
      }
    }
    for (int e = tid; e < Gc * F; e += kThreads) {
      const int gi = e / F;
      const int f = e - gi * F;
      float cs = 0.f;
      for (int s = 0; s < S; ++s) {
        const int r = gi * S + s;
        cs = fmaf((float)mult(r), h2[r * W2 + f], cs);
      }
      csum[e] = cs;
    }
    // the dtable half: each slot whose first copy won gets the row gradient
    // dqg = dh1 @ k0^T of that copy, summed in ascending f, one thread per
    // (row, channel) with the channels of a row on neighbouring threads
    // (k0^T row reads from L1/L2 and the dqg writes coalesced, dh1 a
    // shared-memory broadcast); every slot's table index, -1 where its
    // first copy won nothing
    if (dqg != nullptr) {
      for (int e = tid; e < n_m * S * C; e += kThreads) {
        const int r = e / C;
        const int c = e - r * C;
        const int rr = copies[r] >> 16;
        if (r - by_s.div(r) * S >= Sr || !bit(wonm, rr)) continue;
        const float* dh = h2 + rr * W2;
        float a = 0.f;
        for (int f = 0; f < F; ++f) a = fmaf(dh[f], __ldg(k0t + (size_t)f * Pc + c), a);
        dqg[(((size_t)b * M + m0) * S + r) * C + c] = a;
      }
      for (int r = tid; r < n_m * S; r += kThreads)
        idx_w[((size_t)b * M + m0) * S + r] =
            r - by_s.div(r) * S < Sr && bit(wonm, copies[r] >> 16) ? jrow[r] : -1;
    }
    __syncthreads();

    // 6. dcenters = -(sum_s copies * dh1) @ k0[:3]^T; the next tile writes
    // only the indices and masks, which no thread reads now, before its
    // first barrier
    for (int e = tid; e < n_m * 3; e += kThreads) {
      const int gi = e / 3;
      const int j = e - gi * 3;
      float tot = 0.f;
      for (int f = 0; f < F; ++f) tot = fmaf(k0w[j * F + f], csum[gi * F + f], tot);
      dcenters[((size_t)b * M + m0 + gi) * 3 + j] = -tot;
    }
  }

  // this block's partials: dk0 (C, F) | db0 (F) | dk1 (F, G) | db1 (G)
  float* part = partials + (size_t)blockIdx.x * (C * F + F + F * G + G);
  outer_store<D0>(acc0, o0, red, part, C, tid);
#pragma unroll
  for (int j = 0; j < D1; ++j) {
    const int e = tid + j * kThreads;
    if (e < F * G) part[C * F + F + (e % F) * G + e / F] = acc1[j];
  }
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

template <int D0, int D1>
cudaError_t launch(const float* table, const int* idx, const float* centers,
                   const float* k0, const float* b0, const float* k1, const float* cot,
                   PeDims d, int n_tiles, int n_blocks, int smem_bytes, float* dcenters,
                   float* partials, const float* k0t, float* dqg, int* idx_w,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pe_bwd_kernel<D0, D1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  pe_bwd_kernel<D0, D1><<<n_blocks, kThreads, smem_bytes, stream>>>(
      table, idx, centers, k0, b0, k1, cot, d, n_tiles, dcenters, partials, k0t, dqg,
      idx_w);
  return cudaGetLastError();
}

}  // namespace

// table (B, N, C), idx (B, M, S) i32 whose slots past S_real repeat slot 0
// (the wrapper's padding to the 8-row tile; they take no share of a tie and
// write no dtable row), centers (B, M, 3), k0 (Pc, F) with
// Pc = C rounded up to 4 (zero rows past C), b0 (F), k1 (F, G), cot
// (B, M, G); F and G multiples of 4, F <= 256, Pc*F/16 <= 4*256,
// F*G <= 16*256; Gc centers per tile; n_blocks blocks of the first kernel;
// smem_bytes as the wrapper's `_pe_bwd_smem` computes it (the layout at
// the top of pe_bwd_kernel, with at least 16*kThreads floats past the
// weights for the partition-combine buffer) ->
// dcenters (B, M, 3); partials (n_blocks, n_acc) scratch; sums (n_acc) =
// dk0 (C, F) | db0 (F) | dk1 (F, G) | db1 (G), n_acc = C*F + F + F*G + G;
// k0t (F, Pc) = k0^T, dqg (B, M*S, C) the won rows' gradients and idx_w
// (B, M*S) their table rows (-1 for a row that won nothing), or all three
// null to skip the dtable half.
extern "C" int g4d_pe_bwd(const float* table, const int* idx,
                          const float* centers, const float* k0,
                          const float* b0, const float* k1, const float* cot,
                          int B, int N, int C, int M, int S, int S_real, int F, int G,
                          int Gc, int n_blocks, int smem_bytes, float* dcenters,
                          float* partials, float* sums, const float* k0t,
                          float* dqg, int* idx_w, cudaStream_t stream) {
  const int Pc = (C + 3) & ~3;
  const int items0 = Pc / 4 * (F / 4);
  if (C < 3 || S < 1 || S_real < 1 || S_real > S || F < 4 || G < 4 || F % 4 || G % 4 || F > kThreads ||
      (dqg != nullptr) != (k0t != nullptr) || (dqg != nullptr) != (idx_w != nullptr) ||
      Gc < 1 || n_blocks < 1 || items0 > 4 * kThreads || F * G > 16 * kThreads)
    return (int)cudaErrorInvalidValue;
  const int n_acc = C * F + F + F * G + G;
  const int n_tiles = B * ((M + Gc - 1) / Gc);
  const PeDims d = {N, C, Pc, M, S, F, G, Gc, F + 4, (F > G ? F : G) + 4, (S + 31) / 32,
                    S_real};
  const bool wide0 = items0 > kThreads, wide1 = F * G > 4 * kThreads;
  cudaError_t err;
  if (!wide0 && !wide1)
    err = launch<1, 4>(table, idx, centers, k0, b0, k1, cot, d, n_tiles, n_blocks,
                       smem_bytes, dcenters, partials, k0t, dqg, idx_w, stream);
  else if (!wide1)
    err = launch<4, 4>(table, idx, centers, k0, b0, k1, cot, d, n_tiles, n_blocks,
                       smem_bytes, dcenters, partials, k0t, dqg, idx_w, stream);
  else if (!wide0)
    err = launch<1, 16>(table, idx, centers, k0, b0, k1, cot, d, n_tiles, n_blocks,
                        smem_bytes, dcenters, partials, k0t, dqg, idx_w, stream);
  else
    err = launch<4, 16>(table, idx, centers, k0, b0, k1, cot, d, n_tiles, n_blocks,
                        smem_bytes, dcenters, partials, k0t, dqg, idx_w, stream);
  if (err != cudaSuccess) return (int)err;
  pe_bwd_reduce_kernel<<<g4d_blocks(n_acc, kThreads), kThreads, 0, stream>>>(
      partials, n_blocks, n_acc, sums);
  return (int)cudaGetLastError();
}
