// Fused int8 conv stage of the VT-CNN2 classifier (v7), for Hopper (sm_90a).
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v7_kernel
// (ops/infer.py:1676, reached by pl.pallas_call in make_int8_classifier_v7
// and make_conv_stage).
//
// Computes, per frame of x (B, 2, 128) f32:
//   xq  = clip(round_half_even(x * inv_sx), -127, 127)               int8
//   a1[t, h*256+c] = rq1(sum_k xq[h, t+k] * w1[k, c])        (126, 512) int8
//   a2[t, co] = rq2(sum_{k, j} a1[t+k, j] * w2t[co, k*512+j])  (124, 80) int8
// with rq(acc) = clip((acc + offset) >> shift, 0, 127) per channel (an
// arithmetic shift), the integer spec of golden/quant.py: conv1 is an exact
// integer sum (this is the path for models the v9/v10 bf16 fold refuses),
// and the multiply by inv_sx is rounded on its own (no FMA), then rint
// rounds half to even. The output is the compact (B, 124, 80) map for any
// B; the TPU kernel's 128-lane padding and garbage rows are not reproduced.
// Largest int32 sum: 1536 * 127^2 ~ 2.5e7, far from overflow.
//
// Bound on the H100 SXM at B = 4096: 2*B*(126*512*3 + 124*80*1536) ~ 126.4 G
// int8 operations, 63.9 us at 1,979 dense int8 TOP/s, against ~44.6 MB
// moved (4 MB of frames in, 40.6 MB of map out; ~13 us at 3.35 TB/s): bound
// by operations.
//
// Design. One persistent block per SM walks frames f = blockIdx.x,
// + gridDim.x, ... . conv2 is the consumer of rows 18 and 20
// (conv2_wgmma.cuh): two warpgroups own 64 of the 128 output rows each and
// run wgmma m64n80k32 s8 with both operands in shared memory, the weight
// resident for the launch (3 taps x 80 channels x 512, 122,880 bytes, a
// plain copy of w2t, which is K-major per tap already), A a ring stage
// moved down k rows for tap k, rq2 from register-held constants. The conv1
// map never leaves the chip: where row 20 reads its 305 MB from HBM, 8
// producer warps build it, chunk by chunk, into a ring of 4 stages. A stage
// is one 128-byte K chunk of the map, 128 channels of one I/Q plane
// (channel = h*256 + c), 130 rows x 128 bytes in the 128-byte swizzle
// wgmma reads (segment s of row r at s ^ (r & 7); 17 KB on the 1024-byte
// atom), so a frame is 4 chunks and stage c always holds chunk c. Rows
// 126..129 are never written: they feed only output rows 124..127, which
// are never stored. Each producer lane keeps conv1's constants for the
// launch in registers (its 4 channels' taps packed as (w0, w1, w2, 0)
// bytes for each plane half, and m1/o1 for all 4 chunks) and quantizes 4
// samples of each plane per frame, loaded as float4 one frame ahead; a
// funnel shift of its word and its neighbour's makes the (x[t], x[t+1],
// x[t+2], .) window of every row this warp owns. Warp p writes rows t = p,
// p + 8, ... of a stage (t & 7 = p: one swizzle phase), one 128-byte row a
// step and 4 channels a lane: a shuffle of the window, a __dp4a per
// channel with the offset as its addend, the shift, then rq1's clamp on
// int16 pairs (a saturating pack, one DPX min/relu per pair, one byte
// permute) and a 4-byte st.shared, conflict-free under the swizzle: about
// 15 instructions per 4 outputs. Each writer fences its st.shared against the
// async proxy before it arrives on the stage's `full` mbarrier (256
// arrivals), or wgmma could read stale bytes; the consumers release a stage
// on `empty` once the products that read it are done, one product group
// left in flight. The epilogue writes each warpgroup's rows into a tile in
// shared memory (two per warpgroup, by frame parity) and its first thread
// copies the tile out with one bulk copy (the rows are contiguous in the
// map) instead of 4-byte stores scattered over 16 rows. Shared memory:
// 1 KB of alignment, 68 KB of ring, 120 KB of weight, 20 KB of tiles; one
// block per SM.
//
// What sets the pace (PERF.md section 6, diagnostic modes of a throwaway
// copy, B=4096, H100 SXM): neither role alone. conv2's products alone (no
// producers, no epilogue) run in 0.080 ms, 1.25x the bound; conv1's
// producers alone in 0.066; the epilogue adds ~0.03 to the products; the
// whole kernel takes 0.140. With no waits between the roles the two still
// cost 0.124 without the epilogue: on the same SM, conv1's instructions
// slow the tensor cores by about 0.6 of the producers' own time, in
// proportion to their count (half the chunks cost half; dropping the
// __dp4a, the clamp or the shift alone changed little), so the producer
// is kept lean. 4 producer warps instead of 8 ran slower (0.186 against
// 0.160 then); a second accumulator set, to run the epilogue behind the
// next frame's products, needs more than the 128 registers a thread has at
// 512 threads and spilled (0.18-0.22, with the requantize constants in
// registers or in shared memory, with or without setmaxnreg). At the 700 W
// limit the whole kernel draws the limit and its clock falls ~5 %.
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

// Producer warp p (of PRODUCERS): conv1 + rq1 of rows t = p + 8q of every
// chunk of every frame this block walks.
__device__ __forceinline__ void produce(const float* __restrict__ x, long long n,
                                        const int8_t* __restrict__ w1,
                                        const int* __restrict__ m1, const int* __restrict__ o1,
                                        float inv_sx, uint8_t* ring, uint32_t full,
                                        uint32_t empty, int p, int lane) {
  // Channel cc = (c % 2)*128 + 4*lane + e of chunk c reads plane c / 2;
  // chunks c and c + 2 share the taps, not the requantize constants.
  uint32_t taps[2][4];
  int shift[CHUNKS][4], offset[CHUNKS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = half * WG_CHUNK + 4 * lane + e;
      taps[half][e] = static_cast<uint8_t>(w1[cc]) |
                      static_cast<uint32_t>(static_cast<uint8_t>(w1[C1 + cc])) << 8 |
                      static_cast<uint32_t>(static_cast<uint8_t>(w1[2 * C1 + cc])) << 16;
    }
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = c / 2 * C1 + c % 2 * WG_CHUNK + 4 * lane + e;
      shift[c][e] = __ldg(m1 + j);
      offset[c][e] = __ldg(o1 + j);
    }
  // Row t = p + 8q: its window starts at byte p % 4 of lane t / 4's word,
  // and its segment s sits at s ^ (t & 7) = s ^ p in the swizzle.
  const int src0 = p >> 2, shift_bits = 8 * (p & 3);
  const int col = (((lane >> 2) ^ p) << 4) + 4 * (lane & 3);
  uint8_t* rows = ring + p * WG_CHUNK + col;

  const long long step = gridDim.x;
  long long f = blockIdx.x;
  float4 xv[2];
  if (f < n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) xv[h] = __ldg(reinterpret_cast<const float4*>(x + f * 2 * T + h * T) + lane);
  }
  for (int it = 0; f < n; f += step, ++it) {
    uint32_t window[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t q = quantize4(xv[h], inv_sx);
      const uint32_t next = __shfl_down_sync(0xffffffffu, q, 1);   // lane 31: its own, unused
      window[h] = __funnelshift_r(q, next, shift_bits);
    }
    if (f + step < n) {   // the next frame's samples, in flight while this one is built
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[h] = __ldg(reinterpret_cast<const float4*>(x + (f + step) * 2 * T + h * T) + lane);
    }
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
            v[e] = __dp4a(xw, static_cast<int>(taps[c % 2][e]), offset[c][e]) >> shift[c][e];
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

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_v7_kernel(const float* __restrict__ x, long long n,
                          const int8_t* __restrict__ w1,
                          const int* __restrict__ m1,
                          const int* __restrict__ o1,
                          const int8_t* __restrict__ w2t,
                          const int* __restrict__ m2,
                          const int* __restrict__ o2, float inv_sx,
                          int8_t* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t ws = base + RING_BYTES, tiles = ws + W_BYTES;
  const uint32_t full = tiles + OUT_BYTES, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32 * PRODUCERS);
      mbar_init(empty + 8 * s, WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {
    produce(x, n, w1, m1, o1, inv_sx, smem_raw + (base - raw), full, empty,
            warp - WG_CONSUMERS / 32, lane);
    return;
  }

  // The consumers: the weight once, while the producers build the first
  // stages.
  stage_w2t_resident<C2, K1>(w2t, smem_raw + (ws - raw));
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");

  // Warpgroup g owns output rows 64g .. 64g + 63 (warp w of it rows
  // 16(w%4) .. +15 of those), 64 and 60 of them below T2. Its epilogue
  // writes them into a tile in shared memory, and its first thread copies
  // the tile out with one bulk copy: the map's rows are contiguous.
  const int wg = warp / 4, a_row0 = wg * 64, rows = wg ? T2 - 64 : 64;
  const int r_lo = (warp % 4) * 16 + (lane >> 2);
  const bool issuer = warp % 4 == 0 && lane == 0;
  int shift[C2 / 8][2], offset[C2 / 8][2];
  load_rq2<C2>(m2, o2, 0, C2, shift, offset);
  int it = 0;
  for (long long f = blockIdx.x; f < n; f += gridDim.x, ++it) {
    int acc[C2 / 2];
#pragma unroll
    for (int i = 0; i < C2 / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_wait(full + 8 * c, it & 1);
      __syncwarp();                  // converged again for the .aligned products
      stage_products<C2>(acc, base + c * WG_STAGE + a_row0 * WG_CHUNK,
                         ws + 2 * c * (NB * 64));
      wgmma_wait<1>();               // the previous chunk's products are done:
      __syncwarp();                  // this warp releases its stage
      if (c > 0 && lane == 0) mbar_arrive(empty + 8 * (c - 1));
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (CHUNKS - 1));
#pragma unroll
    for (int i = 0; i < C2 / 2; ++i) pin(acc[i]);
    const uint32_t tile = tiles + ((it & 1) * 2 + wg) * TILE_BYTES;
    store_rq2<C2>(acc, shift, offset, reinterpret_cast<int8_t*>(smem_raw + (tile - raw)), r_lo,
                  0, C2, rows);
    fence_proxy_async();             // the tile's st.shared before the bulk copy reads it
    // Frame f-1's copy has read its tile, so the one frame f+1 writes is free
    // once every warp of the warpgroup has passed this barrier.
    if (issuer) bulk_wait_read<0>();
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    if (issuer) {
      bulk_store(out + f * (T2 * C2) + wg * TILE_BYTES, tile, rows * C2);
      bulk_commit();
    }
  }
  if (issuer) bulk_wait<0>();        // the last copies land before the block ends
}

}  // namespace

extern "C" int amc_conv_stage_int8_v7(const void* x, long long n,
                                      const void* w1, const void* m1,
                                      const void* o1, const void* w2t,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // float4 loads, bulk copies
  cudaError_t err = cudaFuncSetAttribute(
      conv_stage_int8_v7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n < sms ? n : sms;
  conv_stage_int8_v7_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const int8_t*>(w1),
      static_cast<const int*>(m1), static_cast<const int*>(o1),
      static_cast<const int8_t*>(w2t), static_cast<const int*>(m2),
      static_cast<const int*>(o2), inv_sx, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
