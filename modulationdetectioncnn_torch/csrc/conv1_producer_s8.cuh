// The producer role of the int8 conv stages that build conv1 on the CUDA
// cores with the integer spec, for Hopper (sm_90a): conv_stage_int8.cu
// (row 1, v7) and conv_stage_int8_v5.cu (rows 5 and 10, v5 and v1) from f32
// frames, conv_stage_int8_v6.cu (rows 6 and 7, v6 and v4) from int8 tap
// planes. Their consumer role is conv2_wgmma.cuh's consume_ring_s8; this
// header holds the ring's geometry, the block's shared memory, the kernels'
// launch and the producer warps' conv1 + rq1:
//
//   xq  = clip(round_half_even(x * inv_sx), -127, 127)               int8
//   a1[t, h*256+c] = clip((sum_k xq[h, t+k] * w[k, c] + o1) >> m1, 0, 127)
//
// (the multiply by inv_sx rounded on its own, no FMA, then rint; the shift
// arithmetic), with the taps w[k, c] of plane h read from one of two
// layouts (TAP_SETS): row 1's w1 (3, 256), one tap set for both planes, or
// the tap-plane w1e (8, 512) of rows 5, 10, 6 and 7, w1e[3h+k, h*256+c],
// each plane's taps from its own block (quant.py::expand_conv1_weights
// writes both blocks from w1, the other plane's columns and rows 6, 7 zero;
// the producer never reads those). From tap planes xp (8, 128) int8 the
// window of row t is (xp[3h][t], xp[3h+1][t], xp[3h+2][t]) in place of
// (xq[h, t], xq[h, t+1], xq[h, t+2]): a1[t, n] = clip((sum_j xp[j, t] *
// w1e[j, n] + o1) >> m1, 0, 127), the TPU's v4/v6 conv1, where planes 6, 7
// meet w1e's zero rows and the other plane's block of w1e is zero, so they
// are not read either, nor columns 126, 127 (they feed only conv1 rows
// 126, 127, which feed no stored output).
//
// A ring stage is one 128-byte K chunk of the map, 128 channels of one I/Q
// plane (channel = h*256 + c), 130 rows x 128 bytes in the 128-byte
// swizzle wgmma reads (segment s of row r at s ^ (r & 7); 17 KB on the
// 1024-byte atom), so a frame is 4 chunks and stage c always holds chunk
// c. Rows 126..129 are never written: they feed only output rows 124..127,
// which are never stored. Each producer lane keeps conv1's constants for
// the launch in registers (its 4 channels' taps packed as (w0, w1, w2, 0)
// bytes for each plane half of each tap set, and m1/o1 for all 4 chunks)
// and holds its part of the next frame, loaded one frame ahead: from
// frames (FramesIn; x 16-byte aligned), 4 samples of each plane as a
// float4, quantized into one word, and a funnel shift of its word and its
// neighbour's makes the (x[t], x[t+1], x[t+2], .) window of every row this
// warp owns; from tap planes (PlanesIn), one 4-byte word of columns
// 4l..4l+3 of each of planes 0..5, and two byte permutes make the same
// window. Warp p writes rows t = p, p + 8, ... of a stage (t & 7 = p:
// one swizzle phase), one 128-byte row a step and 4 channels a lane: a
// shuffle of the window, a __dp4a per channel with the offset as its
// addend, the shift, then rq1's clamp on int16 pairs (a saturating pack,
// one DPX min/relu per pair, one byte permute) and a 4-byte st.shared,
// conflict-free under the swizzle: about 15 instructions per 4 outputs.
// Each writer fences its st.shared against the async proxy before it
// arrives on the stage's `full` mbarrier (256 arrivals), or wgmma could
// read stale bytes; it waits on the stage's `empty` mbarrier, released by
// the consumers once the products that read it are done.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv2_wgmma.cuh"

namespace {

constexpr int T = 128;                 // frame length
constexpr int T1 = T - 2;              // conv1 output rows
constexpr int T2 = T - 4;              // conv2 output rows
constexpr int C1 = 256;                // conv1 channels per I/Q plane
constexpr int K1 = 2 * C1;             // stacked conv1 channels, h*C1 + c
constexpr int C2 = 80;                 // conv2 channels
constexpr int NB = 3 * C2;             // resident weight columns, k*C2 + co
constexpr int CHUNKS = K1 / WG_CHUNK;  // K chunks (ring stages) per frame
constexpr int STAGES = CHUNKS;         // stage c holds chunk c
constexpr int PRODUCERS = 8;           // producer warps; warp p owns rows p + 8q
constexpr int ROWS = (T1 + PRODUCERS - 1) / PRODUCERS;   // rows per warp and stage
constexpr int THREADS = WG_CONSUMERS + 32 * PRODUCERS;
constexpr int RING_BYTES = STAGES * WG_STAGE;
constexpr int W_BYTES = CHUNKS * 2 * NB * 64;   // 8 K tiles of 64 bytes
constexpr int TILE_BYTES = 64 * C2;             // a warpgroup's 64 rows of the map
constexpr int OUT_BYTES = 2 * 2 * TILE_BYTES;   // two tiles per warpgroup, by frame parity
// 1 KB of alignment, 68 KB of ring, 120 KB of weight, 20 KB of tiles, the
// full and empty mbarriers: one block per SM.
constexpr int SMEM_BYTES = 1024 + RING_BYTES + W_BYTES + OUT_BYTES + 2 * STAGES * 8;
static_assert(C1 == WG_CHUNK * 2, "a chunk is half of one plane's channels");
static_assert(PRODUCERS == 8, "a warp's rows share their swizzle phase (t & 7) and window byte");
static_assert(SMEM_BYTES <= 232448, "ring, weight and barriers fit the 227 KB a block may have");
static_assert(2 * SMEM_BYTES > 228 * 1024, "one block per SM");

__device__ __forceinline__ uint32_t quantize4(float4 v, float inv_sx) {
  const float s[4] = {v.x, v.y, v.z, v.w};
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // The multiply is rounded on its own, then rint rounds half to even,
    // as the reference's jnp.round / np.round do.
    const float q = fminf(fmaxf(rintf(__fmul_rn(s[e], inv_sx)), -127.0f), 127.0f);
    word |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * e);
  }
  return word;
}

// Two int32 sums saturated to int16 and packed, hi in the upper half.
__device__ __forceinline__ uint32_t pack_sat_s16(int hi, int lo) {
  uint32_t d;
  asm("cvt.pack.sat.s16.s32 %0, %1, %2;\n" : "=r"(d) : "r"(hi), "r"(lo));
  return d;
}

// The producers' input policies. A lane holds its part of one frame
// (Lane), loaded one frame ahead, and makes from it the window of byte
// p % 4 of its 4-sample span of plane h: (x[t], x[t+1], x[t+2], .) of
// t = 4 * lane + p % 4 (byte 3 meets a zero tap).
struct FramesIn {   // (B, 2, T) f32 frames, quantized here
  const float* __restrict__ x;
  float inv_sx;
  struct Lane {
    float4 v[2];
  };
  __device__ __forceinline__ void load(Lane& in, long long f, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) in.v[h] = __ldg(reinterpret_cast<const float4*>(x + f * 2 * T + h * T) + lane);
  }
  __device__ __forceinline__ uint32_t window(const Lane& in, int h, int p) const {
    const uint32_t q = quantize4(in.v[h], inv_sx);
    const uint32_t next = __shfl_down_sync(0xffffffffu, q, 1);   // lane 31: its own, unused
    return __funnelshift_r(q, next, 8 * (p & 3));
  }
};

struct PlanesIn {   // (B, 8, T) int8 tap planes: plane 3h+k holds xq[h, t+k] at t
  const int8_t* __restrict__ xp;
  struct Lane {
    uint32_t v[2][3];   // columns 4l..4l+3 of planes 3h+k
  };
  __device__ __forceinline__ void load(Lane& in, long long f, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        in.v[h][k] = __ldg(reinterpret_cast<const uint32_t*>(xp + (f * 8 + 3 * h + k) * T) + lane);
  }
  __device__ __forceinline__ uint32_t window(const Lane& in, int h, int p) const {
    const uint32_t b = p & 3;   // byte b of each plane's word: column 4 * lane + b
    const uint32_t pair = __byte_perm(in.v[h][0], in.v[h][1], b | (b + 4) << 4);
    return __byte_perm(pair, in.v[h][2], 0x3010u | (b + 4) << 8);
  }
};

// Producer warp p (of PRODUCERS): conv1 + rq1 of rows t = p + 8q of every
// chunk of every frame this block walks, from the input policy `in`.
// TAP_SETS = 1: w1 is (3, C1), the taps of both planes; TAP_SETS = 2: w1
// is the tap-plane (8, K1), plane h's tap k in row 3h + k, columns h*C1 ..
// h*C1 + C1 - 1.
template <int TAP_SETS, typename In>
__device__ __forceinline__ void produce(const In in, long long n,
                                        const int8_t* __restrict__ w1,
                                        const int* __restrict__ m1, const int* __restrict__ o1,
                                        uint8_t* ring, uint32_t full,
                                        uint32_t empty, int p, int lane) {
  static_assert(TAP_SETS == 1 || TAP_SETS == 2, "one tap set, or one per plane");
  constexpr int SETS = 2 * TAP_SETS, W_ROW = TAP_SETS * C1;
  // Channel cc = (c % 2)*128 + 4*lane + e of chunk c reads plane c / 2 and
  // tap set c % SETS: with one set, chunks c and c + 2 share the taps, not
  // the requantize constants.
  uint32_t taps[SETS][4];
  int shift[CHUNKS][4], offset[CHUNKS][4];
#pragma unroll
  for (int s = 0; s < SETS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t* w = w1 + (3 * W_ROW + C1) * (s / 2) + s % 2 * WG_CHUNK + 4 * lane + e;
      taps[s][e] = static_cast<uint8_t>(w[0]) |
                   static_cast<uint32_t>(static_cast<uint8_t>(w[W_ROW])) << 8 |
                   static_cast<uint32_t>(static_cast<uint8_t>(w[2 * W_ROW])) << 16;
    }
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = c / 2 * C1 + c % 2 * WG_CHUNK + 4 * lane + e;
      shift[c][e] = __ldg(m1 + j);
      offset[c][e] = __ldg(o1 + j);
    }
  // Row t = p + 8q: its window is byte p % 4 of lane t / 4's, and its
  // segment s sits at s ^ (t & 7) = s ^ p in the swizzle.
  const int src0 = p >> 2;
  const int col = (((lane >> 2) ^ p) << 4) + 4 * (lane & 3);
  uint8_t* rows = ring + p * WG_CHUNK + col;

  const long long step = gridDim.x;
  long long f = blockIdx.x;
  typename In::Lane held;
  if (f < n) in.load(held, f, lane);
  for (int it = 0; f < n; f += step, ++it) {
    uint32_t window[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) window[h] = in.window(held, h, p);
    // The next frame's input, in flight while this one is built.
    if (f + step < n) in.load(held, f + step, lane);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_wait(empty + 8 * c, (it & 1) ^ 1);
      uint8_t* st = rows + c * WG_STAGE;
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        if (q < ROWS - 1 || p + PRODUCERS * q < T1) {   // warp-uniform
          // Byte 3 of the window meets a zero tap: only x[t..t+2] count.
          const int xw = __shfl_sync(0xffffffffu, window[c / 2], src0 + PRODUCERS / 4 * q);
          int v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = __dp4a(xw, static_cast<int>(taps[c % SETS][e]), offset[c][e]) >> shift[c][e];
          // rq1's clamp to [0, 127] on int16 pairs: saturating to int16
          // keeps every value's side of 0 and 127.
          const uint32_t v01 = __vimin_s16x2_relu(pack_sat_s16(v[1], v[0]), 0x007f007fu);
          const uint32_t v23 = __vimin_s16x2_relu(pack_sat_s16(v[3], v[2]), 0x007f007fu);
          *reinterpret_cast<uint32_t*>(st + PRODUCERS * WG_CHUNK * q) =
              __byte_perm(v01, v23, 0x6420);
        }
      }
      fence_proxy_async();   // these st.shared before wgmma's reads (async proxy)
      mbar_arrive(full + 8 * c);
    }
  }
}

// Launch a ring kernel: one persistent block per SM, fewer for a batch of
// fewer frames, `args` cast to the kernel's parameters; returns the
// launch's CUDA error code (0 for n <= 0, which launches nothing; invalid
// value for an input or output not 16-byte aligned: float4 loads, bulk
// copies).
template <typename... Params, typename... Args>
inline int launch_ring_kernel(void (*kernel)(Params...), long long n, const void* in,
                              const void* out, void* stream, Args... args) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n < sms ? n : sms;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Params>(args)...);
  return static_cast<int>(cudaGetLastError());
}

// The kernels of rows 1, 5 and 10 take (x, n, conv1 taps, m1, o1, conv2,
// m2, o2, inv_sx, out); those of rows 6 and 7 the same with tap planes xp
// for x and no inv_sx.
using RingKernel = void (*)(const float*, long long, const int8_t*, const int*, const int*,
                            const int8_t*, const int*, const int*, float, int8_t*);
using PlanesRingKernel = void (*)(const int8_t*, long long, const int8_t*, const int*,
                                  const int*, const int8_t*, const int*, const int*, int8_t*);

inline int launch_ring(RingKernel kernel, const void* x, long long n, const void* w1,
                       const void* m1, const void* o1, const void* w2, const void* m2,
                       const void* o2, float inv_sx, void* out, void* stream) {
  return launch_ring_kernel(kernel, n, x, out, stream, x, n, w1, m1, o1, w2, m2, o2, inv_sx,
                            out);
}

inline int launch_ring(PlanesRingKernel kernel, const void* xp, long long n, const void* w1e,
                       const void* m1, const void* o1, const void* w2l, const void* m2,
                       const void* o2, void* out, void* stream) {
  return launch_ring_kernel(kernel, n, xp, out, stream, xp, n, w1e, m1, o1, w2l, m2, o2, out);
}

}  // namespace
