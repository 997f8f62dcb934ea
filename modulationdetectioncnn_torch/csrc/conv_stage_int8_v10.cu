// Fused int8 conv stage with the folded bf16 conv1 (v9 and v10), for
// Hopper (sm_90a). One kernel body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v9_kernel
//   (ops/infer.py:1103, reached by pl.pallas_call in make_int8_classifier_v9
//   and make_conv_stage) with amc_conv_stage_int8_v9, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v10_kernel
//   (ops/infer.py:1247, make_int8_classifier_v10 and make_conv_stage) with
//   amc_conv_stage_int8_v10.
//
// Computes, per frame of x (B, 2, 128) f32:
//   xq   = clip(round_half_even(x * inv_sx), -127, 127)
//   A[t] = [xq_I(t), xq_Q(t), xq_I(t+1), xq_Q(t+1), xq_I(t+2), xq_Q(t+2), 1, 0]
//          (bf16, exact since |xq| <= 127; taps past the frame are 0)
//   f    = A . w1f[0:8], (128 x 8) . (8 x 512), f32 sums     the TPU's K=8 dot
//   a1   = (int8) trunc(clip(f, 0, 127))                         (126, 512)
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2l[j, k*80 + co]          t < 124
//   out  = clip((s + o2) >> m2, 0, 127)                        (124, 80) int8
// w1f is conv1 with its requantize folded in (quant.py::fold_conv1_weights):
// row 2k+h holds tap k of plane h in plane h's columns (zero in the other
// plane's), row 6 the offset, the bias lane. Every product and partial sum
// is an integer multiple of 2^-shift1, less than 2^24 such units in
// magnitude, so the f32 sum is exact in any order and a1 equals the integer
// spec clip((acc + o1) >> m1, 0, 127), provided the tensor core neither
// drops bits inside a 24-bit window nor flushes small terms. chip_smoke.py
// checks that on the card over the whole map, on a model at the fold's
// 2^24 edge too: 0 mismatches.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7 computes the
// same map): conv1 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536
// ~ 124.8 G int8 ops (63.9 us at 1,979 TOP/s), against ~45 MB moved (x
// 4.2 MB in, the map 40.6 MB out; ~13.4 us at 3.35 TB/s): operation-bound,
// ~64 us. The folded conv1's padded bf16 lanes are this design's cost, not
// the function's, and are not counted.
//
// Design: row 1's (conv_stage_int8.cu) with conv1 on the tensor cores. One
// persistent block of 512 threads per SM walks frames f = blockIdx.x,
// + gridDim.x, ... . The consumers are row 1's (conv2_wgmma.cuh's
// consume_ring_s8): two warpgroups own 64 output rows each and run wgmma
// m64n80k32 s8 with the weight resident (3 taps x 80 channels x 512,
// 122,880 bytes, staged from w2l (512, 240) by stage_w2p_resident's
// transpose), A a ring stage moved down k rows for tap k, rq2 into a tile
// in shared memory and one bulk copy per warpgroup and frame. 8 producer
// warps build the map into the 4-stage ring: stage c holds K chunk c,
// channels 128c .. 128c + 127 (plane c / 2), 130 rows x 128 bytes in the
// 128-byte swizzle (segment s of row r at s ^ (r & 7)). Each producer warp
// quantizes the whole frame into its own 528 bytes of shared memory, as
// (I, Q) bf16 pairs by time (one float4 per plane and lane, loaded a frame
// ahead), and reads its A fragments from there: rows 16m + g and + 8 of
// each of the 8 m-tiles, K lanes 2*tig, 2*tig+1 = the pair at t + tig, or
// (1, 0) for tig = 3. So one A serves all 4 chunks, and B is w1f's rows
// 0..7 as the fold gives them; a chunk's columns meet the other plane's
// rows as exact zeros. Warp p owns channels 16p .. 16p + 15 of every chunk
// as two n8 tiles whose columns are permuted (column n of tile j is channel
// 16p + 4(n/2) + 2j + n%2), so that the D fragments of the pair give lane
// (g, tig) channels 4tig .. 4tig + 3 of rows g and g + 8: each row is one
// 4-byte st.shared into segment p ^ g, conflict-free across the warp. Its
// B fragments (2 per chunk, 8 registers) stay in registers for the launch.
// The product is mma.sync m16n8k8 bf16 with f32 sums: K = 8 is the fold's
// width, so m16n8k16 would double the tensor work for zero lanes; 16 a
// chunk per warp, 512 a frame per block, ~4 % of conv2's int8-equivalent
// tensor work. The convert, exact for every f32 sum (rq1_bytes): d + 1024
// rounded toward zero, two of those to an f16 pair toward zero with
// negatives to 0, one DPX add-min-relu for the pair's clamp to [0, 127] and
// a byte permute for 4 outputs, then the store: 10 instructions per 4
// outputs, where row 1's producer spends about 15 (its __dp4a, shift and
// clamp per channel and a shuffle per row). Each writer fences its
// st.shared against the async proxy before it arrives on the stage's
// `full` mbarrier (256 arrivals); the consumers release a stage on `empty`.
// Rows 126..129 of a stage feed only output rows 124..127, never stored:
// 126 and 127 get conv1 of the taps past the frame, 128 and 129 nothing.
// Shared memory: 1 KB of alignment, 68 KB of ring, 120 KB of weight, 20 KB
// of tiles, 4 KB of quantized frames; one block per SM.
//
// What sets the pace (scripts/conv_int8_modes.py, copies of this body and
// row 1's with parts taken out; B=4096, H100 SXM at 700 W, PERF.md): as
// in row 1, neither role alone. conv2's products alone take 0.086-0.089
// ms, the producers alone 0.066-0.069, both without waits or epilogue
// 0.130-0.135, the whole kernel 0.145-0.150 (row 1: 0.083-0.086, 0.068-
// 0.071, 0.120-0.123, 0.141-0.148). The producers are latency-bound, two
// warps to a scheduler: without the convert (7 of its 10 instructions)
// they take 0.042, without the products 0.059, without the fence 0.065,
// and issuing a chunk's products four m-tiles ahead of their converts
// changes nothing. Three other exact converts were slower: the f16 pair
// clamped by f16 min/max (0.067 alone, 0.155-0.160 whole), the f32 clamp
// with a magic add (0.084, 0.172-0.177), the saturating multiply (0.074,
// 0.151-0.155); cvt.rzi, which issues 16 a cycle per SM, 0.181-0.185 whole.
//
// v9 and v10 share this schedule: the TPU's v10 differs from v9 only in
// issuing the next chunk's conv1 dot before the current chunk's epilogue,
// and here the ring's producers run ahead of the consumers for every frame
// in any case (the next frame's input is loaded while this one is built),
// so the two entries launch the same kernel and time alike.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv2_wgmma.cuh"

namespace {

constexpr int T = 128;                 // frame length
constexpr int T2 = T - 4;              // conv2 output rows
constexpr int K1 = 512;                // stacked conv1 channels, h*256 + c
constexpr int C2 = 80;                 // conv2 channels
constexpr int NB = 3 * C2;             // resident weight columns, k*C2 + co
constexpr int CHUNKS = K1 / WG_CHUNK;  // K chunks (ring stages) per frame
constexpr int STAGES = CHUNKS;         // stage c holds chunk c
constexpr int PRODUCERS = 8;           // warp p owns channels 16p .. 16p + 15 of a chunk
constexpr int M_TILES = T / 16;        // conv1's 16-row tiles (rows 126, 127 unused)
constexpr int THREADS = WG_CONSUMERS + 32 * PRODUCERS;
constexpr int XQ_WORDS = T + 4;        // a warp's quantized frame, then 4 zero pairs
constexpr int RING_BYTES = STAGES * WG_STAGE;
constexpr int W_BYTES = CHUNKS * 2 * NB * 64;   // 8 K tiles of 64 bytes
constexpr int TILE_BYTES = 64 * C2;             // a warpgroup's 64 rows of the map
constexpr int OUT_BYTES = 2 * 2 * TILE_BYTES;   // two tiles per warpgroup, by frame parity
constexpr int XQ_BYTES = PRODUCERS * XQ_WORDS * 4;
constexpr int SMEM_BYTES =
    1024 + RING_BYTES + W_BYTES + OUT_BYTES + XQ_BYTES + 2 * STAGES * 8;
static_assert(PRODUCERS * 16 == WG_CHUNK, "a producer warp owns 16 channels of a chunk");
static_assert(XQ_WORDS * 4 % 16 == 0, "a warp's frame buffer takes 16-byte stores");
static_assert(SMEM_BYTES <= 232448, "ring, weight, tiles and barriers fit the 227 KB a block may have");
static_assert(2 * SMEM_BYTES > 228 * 1024, "one block per SM");

// Two floats as a bf16 pair, lo in the low half (exact for integers <= 256).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// xq of one sample: the multiply rounded on its own, then rint (round half
// to even), as the reference's jnp.round, and the clip.
__device__ __forceinline__ float quantize(float v, float inv_sx) {
  return fminf(fmaxf(rintf(__fmul_rn(v, inv_sx)), -127.0f), 127.0f);
}

// D = A . B for the folded conv1: bf16 in, f32 sums, 16 x 8 x 8.
__device__ __forceinline__ void mma_fold(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// Two f32 to an f16 pair rounded toward zero, negatives to +0; hi in the
// upper half.
__device__ __forceinline__ uint32_t f16_pair_rz_relu(float hi, float lo) {
  uint32_t r;
  asm("cvt.rz.relu.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// rq1 of four exact sums, trunc(clip(d, 0, 127)), as the bytes of one word
// (d0 in the low byte). d + 1024 rounded toward zero keeps floor(d) for d
// in [-1024, 1024) (f32's grid there is 2^-13, integers on it; below -1024
// d is itself on that grid, so the sum is 0 or at most -2^-13). To f16
// toward zero, that lands on f16's integer grid of [1024, 2048): bits
// 0x6400 + floor(d). Below -1024 the pair's half is +0, above 1024 its
// bits are 0x6800 or more (65504 or inf past f16's range): each half read
// as an int16 is monotonic in d, and max(min(half - 0x6400, 127), 0) is
// the answer.
__device__ __forceinline__ uint32_t rq1_bytes(float d0, float d1, float d2, float d3) {
  const uint32_t p01 = __viaddmin_s16x2_relu(
      f16_pair_rz_relu(__fadd_rz(d1, 1024.0f), __fadd_rz(d0, 1024.0f)), 0x9C009C00u, 0x007F007Fu);
  const uint32_t p23 = __viaddmin_s16x2_relu(
      f16_pair_rz_relu(__fadd_rz(d3, 1024.0f), __fadd_rz(d2, 1024.0f)), 0x9C009C00u, 0x007F007Fu);
  return __byte_perm(p01, p23, 0x6420);
}

// Producer warp p (of PRODUCERS): conv1 + rq1 of channels 16p .. 16p + 15
// of every chunk of every frame this block walks; xq is the warp's own
// frame buffer.
__device__ __forceinline__ void produce(const float* __restrict__ x, long long n,
                                        const uint16_t* __restrict__ w1f, float inv_sx,
                                        uint8_t* ring, uint32_t* xq, uint32_t full,
                                        uint32_t empty, int p, int lane) {
  const int g = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  // B of chunk c, tile j for the launch: column g is channel
  // 128c + 16p + 4(g/2) + 2j + g%2, K rows 2tig and 2tig + 1 of the fold.
  uint32_t b[CHUNKS][2];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ch = c * WG_CHUNK + 16 * p + 4 * (g >> 1) + 2 * j + (g & 1);
      b[c][j] = static_cast<uint32_t>(__ldg(w1f + 2 * tig * K1 + ch)) |
                static_cast<uint32_t>(__ldg(w1f + (2 * tig + 1) * K1 + ch)) << 16;
    }
  if (lane < XQ_WORDS - T) xq[T + lane] = 0u;   // the taps past the frame end
  // Rows 16m + g and 16m + g + 8 share their swizzle phase g: this lane's
  // word of channels 4tig .. 4tig + 3 of segment p sits at segment p ^ g.
  uint8_t* rows = ring + g * WG_CHUNK + ((p ^ g) << 4) + 4 * tig;

  const long long step = gridDim.x;
  long long f = blockIdx.x;
  float4 xv[2];
  if (f < n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) xv[h] = __ldg(reinterpret_cast<const float4*>(x + f * 2 * T + h * T) + lane);
  }
  for (int it = 0; f < n; f += step, ++it) {
    uint4 pairs;   // (I, Q) at t = 4 lane .. 4 lane + 3
    pairs.x = bf16_pair(quantize(xv[0].x, inv_sx), quantize(xv[1].x, inv_sx));
    pairs.y = bf16_pair(quantize(xv[0].y, inv_sx), quantize(xv[1].y, inv_sx));
    pairs.z = bf16_pair(quantize(xv[0].z, inv_sx), quantize(xv[1].z, inv_sx));
    pairs.w = bf16_pair(quantize(xv[0].w, inv_sx), quantize(xv[1].w, inv_sx));
    __syncwarp();                     // every lane has read the last frame's pairs
    *reinterpret_cast<uint4*>(xq + 4 * lane) = pairs;
    __syncwarp();
    if (f + step < n) {   // the next frame's samples, in flight while this one is built
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xv[h] = __ldg(reinterpret_cast<const float4*>(x + (f + step) * 2 * T + h * T) + lane);
    }
    uint32_t a[M_TILES][2];
#pragma unroll
    for (int m = 0; m < M_TILES; ++m) {
      const uint32_t lo = xq[16 * m + g + tig], hi = xq[16 * m + g + 8 + tig];
      a[m][0] = tig < 3 ? lo : 0x3F80u;   // the bias lane: bf16 1.0, then 0
      a[m][1] = tig < 3 ? hi : 0x3F80u;
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_wait(empty + 8 * c, (it & 1) ^ 1);
      uint8_t* st = rows + c * WG_STAGE;
#pragma unroll
      for (int m = 0; m < M_TILES; ++m) {
        float d0[4], d1[4];
        mma_fold(d0, a[m][0], a[m][1], b[c][0]);
        mma_fold(d1, a[m][0], a[m][1], b[c][1]);
        *reinterpret_cast<uint32_t*>(st + 16 * m * WG_CHUNK) = rq1_bytes(d0[0], d0[1], d1[0], d1[1]);
        *reinterpret_cast<uint32_t*>(st + (16 * m + 8) * WG_CHUNK) =
            rq1_bytes(d0[2], d0[3], d1[2], d1[3]);
      }
      fence_proxy_async();   // these st.shared before wgmma's reads (async proxy)
      mbar_arrive(full + 8 * c);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_folded_kernel(const float* __restrict__ x, long long n,
                         const uint16_t* __restrict__ w1f,
                         const int8_t* __restrict__ w2l,
                         const int* __restrict__ m2,
                         const int* __restrict__ o2, float inv_sx,
                         int8_t* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t ws = base + RING_BYTES, tiles = ws + W_BYTES, xqs = tiles + OUT_BYTES;
  const uint32_t full = xqs + XQ_BYTES, empty = full + 8 * STAGES;
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
    const int p = warp - WG_CONSUMERS / 32;
    produce(x, n, w1f, inv_sx, smem_raw + (base - raw),
            reinterpret_cast<uint32_t*>(smem_raw + (xqs - raw)) + p * XQ_WORDS, full, empty,
            p, lane);
    return;
  }

  // The consumers: the weight once, while the producers build the first
  // stages, then row 1's consumer role.
  stage_w2p_resident<1, C2>(reinterpret_cast<const uint8_t*>(w2l), K1, C2, 0, 2 * CHUNKS,
                            smem_raw + (ws - raw));
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");
  consume_ring_s8<C2, T2, CHUNKS>(m2, o2, out, n, smem_raw, base, ws, tiles, full, empty);
}

int launch(const void* x, long long n, const void* w1f, const void* w2l, const void* m2,
           const void* o2, float inv_sx, void* out, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // float4 loads, bulk copies
  cudaError_t err = cudaFuncSetAttribute(
      conv_stage_folded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n < sms ? n : sms;
  conv_stage_folded_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const uint16_t*>(w1f),
      static_cast<const int8_t*>(w2l), static_cast<const int*>(m2),
      static_cast<const int*>(o2), inv_sx, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int amc_conv_stage_int8_v9(const void* x, long long n,
                                      const void* w1f, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch(x, n, w1f, w2l, m2, o2, inv_sx, out, stream);
}

extern "C" int amc_conv_stage_int8_v10(const void* x, long long n,
                                       const void* w1f, const void* w2l,
                                       const void* m2, const void* o2,
                                       float inv_sx, void* out, void* stream) {
  return launch(x, n, w1f, w2l, m2, o2, inv_sx, out, stream);
}
