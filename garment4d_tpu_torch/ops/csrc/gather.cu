// Row gather out[b, r, :] = table[b, idx[b, r], :], channel-last.
//
// Replaces garment4d_tpu/ops/pallas/gather.py:gather_rows_pallas_cf
// (pallas_call at :99) and gather_rows_pallas (:118). The TPU kernel kept
// the table in VMEM and emitted channel-first output because lane shuffles
// were its only gather; on the H100 a load from any address is one
// instruction, so the port gathers in place and keeps the channel-last layout
// its torch consumers read.
//
// Out-of-range rule, the JAX package's `_gather_rows` (take_along_axis): an
// index i in [0, N) reads row i, an index in [-N, 0) reads row i + N, any
// other index gives a row of NaN (0x7fc00000), never a stray read. The wrap
// is part of the index test and costs no memory traffic. (The Pallas kernel
// promises indices in [0, N) and gives zero rows outside it.)
//
// What bounds it on the H100: device-memory bytes. Each output element is
// one 4-byte read (from a frame's table, which stays in the 50 MB L2 while
// the frame's rows are gathered) and one 4-byte write. Threads are not tied
// to rows: the flat output of a frame is cut into slots of V floats (V = 4,
// float4 loads and stores, where C % 4 == 0 and the table and the output are
// 16-byte aligned; else V = 1), and a block copies kThreads * U consecutive
// slots of one frame, each thread U slots kThreads apart (U = 4 float4s,
// or floats of rows under 32 floats wide, whose warp loads touch many rows;
// else 8: measured best, PERF.md). So a warp's store
// is 32 consecutive slots whatever the width (a 3-float row costs 3 lanes,
// not a warp), its loads read neighbouring floats of few rows, and each
// thread has U independent index-then-row loads in flight. A slot's row
// and channel, and a block's frame, come from multiply-shift divisions by
// C / V and by the blocks a frame (the host plan's magic numbers, exact for
// dividends below 2^31), independent of each other, so that no chain of
// integer work delays the first load. Blocks of one frame are consecutive,
// so a frame is gathered by the blocks resident at one time and its table
// read from L2; the output is stored with the streaming (evict-first)
// hint, as nothing reads it back here, which keeps those tables in L2.
// Offsets into the output and the table are 64-bit; the slots of one frame
// stay below 2^31.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int V>
struct Slot;
template <>
struct Slot<1> {
  using T = float;
  static __device__ __forceinline__ T nan() { return __int_as_float(0x7fc00000); }
};
template <>
struct Slot<4> {
  using T = float4;
  static __device__ __forceinline__ T nan() {
    const float x = __int_as_float(0x7fc00000);
    return make_float4(x, x, x, x);
  }
};

// x / d as (x * magic) >> shift, exact for x < 2^31 (`_gather_plan`)
__device__ __forceinline__ int divide(unsigned int x, unsigned int magic, int shift) {
  return (int)(((unsigned long long)x * magic) >> shift);
}

// block blockIdx.x = b * bpf + t copies slots [t * kThreads * U, (t + 1) *
// kThreads * U) of frame b; slot s is (row s / CV, vector s % CV)
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const typename Slot<V>::T* __restrict__ table,
                   const int* __restrict__ idx, int N, int R, int CV, int bpf,
                   unsigned int magic, int shift, unsigned int frame_magic,
                   int frame_shift, typename Slot<V>::T* __restrict__ out) {
  using T = typename Slot<V>::T;
  const int b = divide(blockIdx.x, frame_magic, frame_shift);
  const unsigned int slots = (unsigned int)R * (unsigned int)CV;
  const unsigned int s0 =
      (unsigned int)(blockIdx.x - b * bpf) * (kThreads * U) + threadIdx.x;
  const int* ix = idx + (long long)b * R;
  const T* tb = table + (long long)b * N * CV;
  T* ob = out + (long long)b * slots;
  int iv[U], col[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const unsigned int s = s0 + u * kThreads;
    const int r = divide(s, magic, shift);
    col[u] = (int)s - r * CV;
    iv[u] = s < slots ? __ldg(ix + r) : N;  // N: no read
  }
  T v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int i = iv[u];
    i += i < 0 ? N : 0;
    v[u] = (unsigned int)i < (unsigned int)N ? __ldg(tb + (long long)i * CV + col[u])
                                             : Slot<V>::nan();
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (s0 + u * kThreads < slots) __stcs(ob + s0 + u * kThreads, v[u]);
}

template <int V, int U>
cudaError_t launch(const float* table, const int* idx, int B, int N, int R, int CV,
                   int bpf, unsigned int magic, int shift, unsigned int frame_magic,
                   int frame_shift, float* out, cudaStream_t stream) {
  using T = typename Slot<V>::T;
  gather_rows_kernel<V, U><<<(unsigned int)(B * bpf), kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(table), idx, N, R, CV, bpf, magic, shift, frame_magic,
      frame_shift, reinterpret_cast<T*>(out));
  return cudaGetLastError();
}

// whether (magic, shift) is the divider by d that `_gather_plan` makes:
// shift = 31 + ceil(log2 d), magic = ceil(2^shift / d)
bool is_divider(long long d, unsigned int magic, int shift) {
  int s = 0;
  while ((1LL << s) < d) ++s;
  return shift == 31 + s && magic == (unsigned int)(((1ULL << shift) + d - 1) / d);
}

}  // namespace

// table (B, N, C) f32, idx (B, R) i32 -> out (B, R, C) f32. The plan
// (`pointcloud._gather_plan`): V floats a slot (4 needs C % 4 == 0 and
// 16-byte aligned table and out), U slots a thread (4 or 8 for V = 1, 4
// for V = 4), bpf blocks a frame (ceil(R * C / V / (256 * U)), the frame's
// slots plus a block's below 2^31, B * bpf below 2^31), and the dividers
// (magic, shift) by C / V and (frame_magic, frame_shift) by bpf. Anything
// else is refused with cudaErrorInvalidValue.
extern "C" int g4d_gather_rows(const float* table, const int* idx, int B, int N,
                               int C, int R, int V, int U, int bpf,
                               unsigned int magic, int shift, unsigned int frame_magic,
                               int frame_shift, float* out, cudaStream_t stream) {
  if (B < 0 || N < 0 || C < 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0 || C == 0) return (int)cudaSuccess;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (!(V == 1 || (V == 4 && aligned)) || C % V) return (int)cudaErrorInvalidValue;
  if (!(U == 4 || (U == 8 && V == 1))) return (int)cudaErrorInvalidValue;
  const long long CV = C / V, tile = (long long)kThreads * U;
  const long long slots = (long long)R * CV;
  if (slots + tile > (1LL << 31) || bpf != (slots + tile - 1) / tile ||
      (long long)B * bpf > 0x7fffffffLL || !is_divider(CV, magic, shift) ||
      !is_divider(bpf, frame_magic, frame_shift))
    return (int)cudaErrorInvalidValue;
  if (V == 4)
    return (int)launch<4, 4>(table, idx, B, N, R, (int)CV, bpf, magic, shift, frame_magic,
                             frame_shift, out, stream);
  if (U == 4)
    return (int)launch<1, 4>(table, idx, B, N, R, (int)CV, bpf, magic, shift, frame_magic,
                             frame_shift, out, stream);
  return (int)launch<1, 8>(table, idx, B, N, R, (int)CV, bpf, magic, shift, frame_magic,
                           frame_shift, out, stream);
}
