// Shared pieces of the mma.sync conv stages, for Hopper (sm_90a): the
// widths they are compiled for, the integer requantize, the mma.sync and
// cp.async wrappers and the persistent launch (v2-v6, v1; the int8 dense
// stage takes the widths and the requantize); the integer conv1 on tap
// planes and conv2 with its requantize (v4, v5, v6).
//
// conv2, per frame, on the (130, 512) int8 conv1 tile a1s (rows 128 and 129
// zero):
//   s[t, co] = sum_k sum_j a1s[t+k, j] * w2l[j, k*80 + co]           t < 124
//   out[t, co] = clip((s + o2) >> m2, 0, 127)                (124, 80) int8
// The JAX kernels computed z = a1 . w2l and shifted its lanes; here tap k's
// fragments read A rows t+k, so s accumulates in one int32 fragment and the
// (128, 240) int32 z is never stored (it would not fit beside the weight).
// conv2's weight lives in shared memory for the whole kernel, transposed to
// [n = k*80 + co][j] (240 x 528 bytes) so a B fragment is one 32-bit load.
// int8 mma.sync.m16n8k32; each of the 8 warps owns 32 rows x 40 channels
// (2 x 5 fragments). Rows padded to 528 bytes (132 words) put the 8 rows of
// a fragment load on distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;              // frame length
constexpr int T2 = T - 4;           // conv2 output rows
constexpr int K1 = 512;             // stacked conv1 channels, h*256 + c
constexpr int C2 = 80;              // conv2 channels
constexpr int N2 = 3 * C2;          // conv2 columns, taps on N: k*80 + co
constexpr int THREADS = 256;        // 8 warps
constexpr int STRIDE = K1 + 16;     // padded smem row, bytes (132 words)
constexpr int A1_ROWS = T + 2;      // tap k of row t reads row t+k
constexpr int W2S_BYTES = N2 * STRIDE;
constexpr int A1S_BYTES = A1_ROWS * STRIDE;
constexpr int MT = 2;               // conv2 fragments per warp: rows (x16)
constexpr int NT = 5;               //                           channels (x8)

static_assert(T == 8 * 16, "conv1: one 16-row m-tile per warp");
static_assert(4 * MT * 16 == T && 2 * NT * 8 == C2, "conv2 warp tiling");
static_assert(W2S_BYTES % 16 == 0 && A1S_BYTES % 16 == 0,
              "smem regions 16-byte aligned");

__device__ __forceinline__ int requant(int acc, int offset, int shift) {
  int v = (acc + offset) >> shift;  // arithmetic shift on signed int32
  return min(max(v, 0), 127);
}

// D += A . B, int8 in, int32 sums, 16 x 8 x 32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A . B, int8 in, int32 sums, 16 x 8 x 16.
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0), "r"(0), "r"(0), "r"(0));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Once per block: conv2's weight w2l (512, 240) transposed into w2s
// [n][j], and a1 rows 128 and 129 zeroed.
__device__ __forceinline__ void stage_conv2(const int8_t* __restrict__ w2l,
                                            int8_t* w2s, int8_t* a1s) {
  for (int i = threadIdx.x; i < K1 * N2; i += THREADS) {
    const int j = i / N2, c = i % N2;
    w2s[c * STRIDE + j] = w2l[i];
  }
  for (int i = threadIdx.x; i < 2 * STRIDE; i += THREADS) a1s[T * STRIDE + i] = 0;
}

// This thread's rq2 constants: the 2 channels of each of its 5 fragments.
struct Rq2 {
  int shift[NT][2], offset[NT][2];
};

__device__ __forceinline__ Rq2 load_rq2(const int* __restrict__ m2,
                                        const int* __restrict__ o2) {
  const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
  const int cg = (warp >> 2) * NT;
  Rq2 r;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = (cg + j) * 8 + 2 * tig + e;
      r.shift[j][e] = m2[co];
      r.offset[j][e] = o2[co];
    }
  return r;
}

// conv2 of one frame from a1s, with the shift-add in the accumulator, then
// rq2 into the compact (124, 80) map of frame f; rows 124..127 are dropped.
__device__ __forceinline__ void conv2_rq2_store(const int8_t* a1s,
                                                const int8_t* w2s,
                                                const Rq2& rq, long long f,
                                                int8_t* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int r2 = (warp & 3) * (MT * 16), cg = (warp >> 2) * NT;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const int8_t* arow = a1s + (r2 + k + g) * STRIDE + 4 * tig;
    const int8_t* brow = w2s + (k * C2 + cg * 8 + g) * STRIDE + 4 * tig;
#pragma unroll 2
    for (int kb = 0; kb < K1; kb += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = arow + i * 16 * STRIDE + kb;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * STRIDE);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * STRIDE + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = brow + j * 8 * STRIDE + kb;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = r2 + i * 16 + g + half * 8;
      if (t >= T2) continue;
      int8_t* o = out + (f * T2 + t) * C2 + cg * 8 + 2 * tig;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int v0 = requant(acc[i][j][2 * half], rq.offset[j][0], rq.shift[j][0]);
        const int v1 = requant(acc[i][j][2 * half + 1], rq.offset[j][1], rq.shift[j][1]);
        *reinterpret_cast<uint16_t*>(o + j * 8) =
            static_cast<uint16_t>(v0 | (v1 << 8));
      }
    }
  }
}

// The integer conv1 of v4, v5 and v6 reads the frame as tap planes: P is
// (8, 128) int8 in shared memory, plane 3h+k holding xq[h, t+k] for t < 126
// and zeros after, planes 6 and 7 zero (the JAX package's
// expand_tap_planes). Its weight, w1e (8, 512) int8 [3h+k, h*256+c], is
// staged once per block as two 32-bit B fragment words per column (K lanes
// 0..3 and 4..7), and rq1's shifts and offsets beside it.
constexpr int PLANES_BYTES = 8 * T;
constexpr int W1S_BYTES = K1 * 2 * 4;       // [n][2] words
constexpr int Q1S_BYTES = 2 * K1 * 4;       // shifts, then offsets

__device__ __forceinline__ void stage_conv1_int8(const int8_t* __restrict__ w1e,
                                                 const int* __restrict__ m1,
                                                 const int* __restrict__ o1,
                                                 uint32_t* w1s, int* q1s) {
  for (int i = threadIdx.x; i < 2 * K1; i += THREADS) {
    const int c = i / 2, p = i % 2;
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(w1e[(4 * p + e) * K1 + c]))
           << (8 * e);
    w1s[i] = w;
  }
  for (int i = threadIdx.x; i < K1; i += THREADS) {
    q1s[i] = m1[i];
    q1s[K1 + i] = o1[i];
  }
}

// A fragment register of conv1 for row t: K lanes 4*tig .. 4*tig+3 are
// planes 4*tig .. 4*tig+3 at t for tig < 2; lanes 8..15 are zero.
__device__ __forceinline__ uint32_t conv1_planes_a(const int8_t* P, int t, int tig) {
  if (tig >= 2) return 0u;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(P) + 4 * tig * T + t;
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[T]) << 8) |
         (static_cast<uint32_t>(p[2 * T]) << 16) |
         (static_cast<uint32_t>(p[3 * T]) << 24);
}

// conv1 of one frame from its planes: a1s[t, n] = rq1(sum_j P[j, t] *
// w1e[j, n]) for all 128 rows (rows 126 and 127 feed only the dropped
// output rows). Warp w owns rows 16w .. 16w+15 and all 512 columns; the
// product is exact (|sum| <= 6 * 127 * 127).
__device__ __forceinline__ void conv1_planes(const int8_t* P, const uint32_t* w1s,
                                             const int* q1s, int8_t* a1s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  const uint32_t a0 = conv1_planes_a(P, r0 + g, tig);
  const uint32_t a1 = conv1_planes_a(P, r0 + g + 8, tig);
  int8_t* row0 = a1s + (r0 + g) * STRIDE + 2 * tig;
  int8_t* row1 = row0 + 8 * STRIDE;
#pragma unroll 4
  for (int nt = 0; nt < K1 / 8; ++nt) {
    const uint32_t b = tig < 2 ? w1s[(nt * 8 + g) * 2 + tig] : 0u;
    int d[4];
    mma_s8_k16(d, a0, a1, b);
    const int c = nt * 8 + 2 * tig;
    const int s0 = q1s[c], s1 = q1s[c + 1];
    const int f0 = q1s[K1 + c], f1 = q1s[K1 + c + 1];
    *reinterpret_cast<uint16_t*>(row0 + nt * 8) = static_cast<uint16_t>(
        requant(d[0], f0, s0) | (requant(d[1], f1, s1) << 8));
    *reinterpret_cast<uint16_t*>(row1 + nt * 8) = static_cast<uint16_t>(
        requant(d[2], f0, s0) | (requant(d[3], f1, s1) << 8));
  }
}

// Launch one persistent block of THREADS per SM (at most n blocks) with
// `smem_bytes` of dynamic shared memory; returns the launch's
// cudaGetLastError() code.
template <typename... KArgs, typename... Args>
int launch_persistent(void (*kernel)(KArgs...), int smem_bytes, long long n,
                      void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > n) blocks = n;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
