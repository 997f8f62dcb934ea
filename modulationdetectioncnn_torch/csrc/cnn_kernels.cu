// The stand-alone conv kernels of the VT-CNN2 topology, for Hopper (sm_90a),
// at widths given at run time (any B, T, C, Cin, Co). Eight C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv1_kernel
//   (ops/cnn_kernels.py:78, reached by pl.pallas_call in conv1_stacked,
//   ops/cnn_kernels.py:111) with amc_conv1_stacked,
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv2_kernel
//   (:129, conv2_stacked, :165) with amc_conv2_stacked,
//   amc_conv2_stacked_wgmma and amc_conv2_stacked_ffma (three routes, below),
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv1_int8_kernel
//   (:223, conv1_stacked_int8, :249) with amc_conv1_stacked_int8_dp4a and
//   amc_conv1_stacked_int8 (two routes, below), and
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv2_int8_kernel
//   (:268, conv2_stacked_int8, :300) with amc_conv2_stacked_int8 and
//   amc_conv2_stacked_int8_wgmma.
//
// Computes (channel n = h*C + c of the stacked layout, t_out = t_in - 2):
//   conv1   x (B, 2, T) f32, w1p (3, C) f32, b1 (C,) f32 -> (B, T-2, 2C) bf16|f32
//           out[b,t,n] = out_t(relu((((0 + x[b,h,t]*w1p[0,c]) + x[b,h,t+1]*w1p[1,c])
//                                    + x[b,h,t+2]*w1p[2,c]) + b1[c]))
//           each product and sum rounded on its own (__fmul_rn, __fadd_rn),
//           in conv1_accumulate's order, so the plain version equals it bit
//           for bit;
//   conv1 int8  x (B, 2, T) int8, w1p (3, C) int8, m/o (2C,) int32
//           out[b,t,n] = clip((acc + o[n]) >> m[n], 0, 127), acc the exact
//           int32 sum of the same three products;
//   conv2   a1s (B, t_in, K) bf16 or f32, w2p (K, 3Co) of the same type,
//           b2 (Co,) f32 -> (B, t_out, Co) bf16|f32
//           out[b,t,co] = out_t(relu(sum_k sum_j a1s[b,t+k,j] * w2p[j,k*Co+co]
//                                    + b2[co]))
//           bf16: tensor cores (f32 sums); f32: FMAs on the CUDA cores (no
//           TF32). The TPU kernel built z = a1s . w2p in VMEM and shift-added
//           its lanes (z0[t] + z1[t+1] + z2[t+2]); here tap k's A rows are
//           t+k, so the shift-add happens in the accumulator and z is never
//           stored: the sums differ from the plain version's only in their
//           order;
//   conv2 int8  a1s (B, t_in, K) int8, w2p (K, 3Co) int8, m/o (Co,) int32
//           -> (B, t_out, Co) int8, the same sum exact in int32, then the
//           requantize of conv1 int8.
//
// Bound on the H100 SXM at B = 4096, T = 128, C = 256, Co = 80 (inputs read
// once, outputs written once; chip_smoke.py recomputes it from each run's
// tensors): conv1 writes 528.5 MB bf16 (0.159 ms at 3.35 TB/s; 1.06 GB, 0.317
// ms, in f32) for 1.6 GFLOP; conv1 int8 265 MB (0.079 ms); conv2 bf16 reads
// 528.5 MB and writes 81 MB (0.182 ms) for 124.8 GFLOP (0.126 ms at 989
// TFLOP/s); conv2 int8 305 MB (0.091 ms) for 124.8 GOP (0.063 ms at 1,979
// TOP/s): all bound by bytes, except conv2 f32, whose 124.8 GFLOP on the
// CUDA cores (67 TFLOP/s) take 1.86 ms.
//
// conv1 (float, and int8's general route): one warp per output row (b, t),
// lanes over channel pairs, so a warp writes 128 contiguous bytes per step
// and the row's six inputs are read once; the pair of two channels is one
// 4-byte (bf16), 8-byte (f32) or 2-byte (int8) store, aligned because 2C is
// even. In int8 that body is bound by load and store issue: per 2 output
// bytes it loads three weight bytes and each channel's shift and offset
// (about 10 loads), so it wrote 264 MB at B = 4096 at ~0.59 TB/s.
//
// conv1 int8 has two bodies; ops/cnn_kernels.py::conv1_int8_route picks one
// from the widths (a dispatch by shape, never a retry):
//
// - The dp4a route (amc_conv1_stacked_int8_dp4a; C a multiple of 16, 16 <=
//   C <= 2048, 3 <= T <= 8192: the default widths always). A thread owns 16
//   consecutive output channels of the stacked row (n0 .. n0+15, all of one
//   plane since C % 16 == 0) for the whole launch, with their taps packed
//   one word a channel, (w0, w1, w2, 0) as bytes, and their shifts and
//   offsets in registers (48 registers, loaded once). A row of 2C channels
//   is 2C / 16 threads (one warp at C = 256), and a 256-thread block works
//   on 256 / (2C / 16) rows at once. Persistent blocks (as many as fit on
//   the card) walk frames; each stages the next frame's 2T bytes into a
//   second shared buffer by cp.async (4-byte words from the aligned word at
//   or below its first byte, so any T and any offset of x; words past x's
//   end arrive as zeros) while it computes the current one. Per row t a
//   thread forms its plane's window x[t .. t+3] as one word (two aligned
//   shared loads and a funnel shift), computes each channel with one
//   __dp4a(window, taps, 0) (the fourth byte meets the weight's zero, so the
//   int32 sum is exact), requantizes it (requant, conv2_wgmma.cuh), packs 16
//   bytes with __byte_perm and issues one 16-byte streaming store (st.global
//   .cs: the 264 MB output does not fit in L2): a warp writes 512 contiguous
//   bytes a row. About 100 instructions a thread a row, so issue stays
//   under the bytes (0.079 ms at B = 4096). The same layout (a thread's
//   channels and their taps in registers, the frame staged once, one wide
//   store a row) serves the float conv1.
// - The general route (amc_conv1_stacked_int8; any width): the body above.
//
// conv2 has three bodies; ops/cnn_kernels.py::conv2_route picks one from the
// widths, the dtype and the alignment (a dispatch by shape, never a retry):
//
// - The Hopper route (amc_conv2_stacked_wgmma, amc_conv2_stacked_int8_wgmma;
//   bf16 or int8, K * element size a multiple of 16 bytes, K <= 512, Co a
//   multiple of 4, a1s and w2p 16-byte aligned: the default widths always).
//   Persistent blocks, one per SM, each with its weight resident in shared
//   memory for the whole launch: 3 taps x NT channels x K, in wgmma's
//   K-major layout (64-byte swizzle), transposed there once by the block
//   from w2p (122,880 bytes at K = 512: NT = 80 channels in int8, 40 in
//   bf16, whose 80 channels take two blocks side by side, so the second
//   read of a frame's map hits L2). So w2p crosses L2 once per block, not
//   once per (frame, 128-row tile): 16 MB in all instead of 1.0 GB (bf16)
//   or 0.5 GB (int8) at B = 4096. A producer warp streams the map through a
//   6-stage ring of TMA boxes (130 rows x 128 bytes of K, 128-byte swizzle;
//   rows past t_in and bytes past K arrive as zeros, so the tile needs no
//   hand-zeroed rows) on full/empty mbarriers, running ahead across work
//   items (frame, 128-row tile). Two consumer warpgroups own 64 tile rows
//   each and issue wgmma with both operands in shared memory (m64n40k16
//   bf16, m64n80k32 s8): for tap k, A is the ring's tile moved down k rows,
//   a descriptor start k * 128 bytes further, so the shift-add happens in
//   the accumulator and z is never stored. The 128-byte swizzle follows the
//   address bits, so the moved start needs no base offset (a base offset of
//   (start >> 7) & 7 read the wrong rows on the H100). A stage is released
//   once the products that read it are done (one product group stays in
//   flight); the epilogue (bias + ReLU + one rounding, or the requantize,
//   with its constants in registers for the launch) stores 4 bytes or more
//   a lane (int8: two lanes swap halves to make 4 channels of one row)
//   while the producer already fills the next item's stages. The
//   consumer's pieces (products, resident weight, int8 epilogue) live in
//   conv2_wgmma.cuh, which the v7 conv stage (conv_stage_int8.cu) shares.
//   What bounds it (PERF.md section 6, chip_smoke.py and scripts/probe.py
//   conv2_maps): the map's stream, ~2.2 TB/s of the card's 3.35 in this
//   access pattern, and in bf16 the second read of each frame by the other
//   channel tile's block. Found on the way, with code not kept (its
//   numbers are not recorded): wgmma
//   runs at its peak at these shapes from registers or shared memory; an
//   ldmatrix-fed A from registers was no faster than A from shared
//   memory; what held the first body was the per-item epilogue, whose
//   per-lane constant loads stalled both warpgroups at once (now loaded
//   once per launch, with one product group left in flight); a 2-block
//   cluster multicasting each box (each bf16 frame read once) and
//   warpgroups taking alternate items from rings of their own both ran
//   slower.
// - The FFMA route (amc_conv2_stacked_ffma; float32, K a multiple of 4, Co a
//   multiple of 4, a1s and w2p 16-byte aligned, any K: the default widths
//   always). IEEE f32 FMAs on the CUDA cores, no TF32: its bound is the
//   124.8 GFLOP at 67 TFLOP/s, 1.86 ms at B = 4096 (the bytes take 0.36).
//   Persistent blocks, one per SM, walk work items of 128 consecutive rows
//   of the map taken as B * t_in rows (a tile may span two frames; its rows
//   t >= t_out mix two frames and are not stored: 2 of 126 rows at T 128,
//   against 4 of 128 for tiles of one frame's 124 outputs, and 4032 items
//   at B = 4096 where those gave 4096) for one 80-channel tile. A producer
//   warp keeps a 4-stage ring full on full/empty mbarriers, running ahead
//   across items; a stage is K j .. j+31: the map's box (130 rows x 128
//   bytes, the 128-byte swizzle; rows past B * t_in and K past k_in arrive
//   as zeros) and three boxes of w2p (32 rows x 80 columns k*Co + 80y ..,
//   one a tap, straight from its (K, 3Co) layout: no transpose, no integer
//   division), 47 KB in all. The weight is streamed, not resident, so K has
//   no limit; it crosses L2 once per item (2.0 GB at B = 4096, far under
//   L2's rate). Eight consumer warps (two a scheduler: ten would leave two
//   schedulers three) do register-blocked outer products: a thread owns 8
//   rows (pairs 16 apart) x 5 channels (4 from one 16-byte load, 1 of
//   channels 64-79), 40 sums; per 4 K a warp issues 480 FFMA beside 16 map
//   and 24 weight loads and 4 XORs of the swizzle: the 4 lanes of a row
//   share each map load, and the 8 rows of a load fall on 4 swizzle phases
//   (2 wavefronts). Tap k of a row reads map row + k, so the shift-add
//   happens in the accumulator, as in the other routes. The epilogue (bias,
//   ReLU, one rounding) stores 16 bytes (f32) or 8 (bf16) for the 4
//   channels and one element for the fifth, masked at the tile's edges.
//   163-166 registers, 0 spills. What bounds it (PERF.md section 6,
//   scripts/conv2_ffma_modes.py): FFMA issue at 1,980 MHz, and the weight
//   loads: 24 instructions beside 480 FFMA, they cost 12 % of the time
//   (their 16-byte loads 8 %), while the map's loads cost nothing
//   measurable and the waits for a stage's data 3.5 %; 2.76 ms at B =
//   4096, 1.5x the bound, 2-4 % over torch.matmul's f32 z. Found on the
//   way, with code not kept (its numbers are not recorded): a thread's rows
//   8 apart or in fours, tiles of one frame, 4 consumer warps of 16 rows,
//   4 lanes a warp along rows in place of 8, a barrier across the
//   consumers each stage, and the next chunk's
//   weights loaded into a second register set (which needs 8 warps in all
//   for its 221 registers: a ninth warp puts three on one scheduler, whose
//   16,384 registers then hold each thread to 168, whatever setmaxnreg or
//   __maxnreg__ ask) all ran no faster.
// - The general route (amc_conv2_stacked, amc_conv2_stacked_int8; any
//   width): one block of 8 warps per (frame, 128 output
//   rows, 80 channels) tile. K is walked in 64-byte chunks: the tile's 130
//   input rows and the chunk of all three taps' weights, transposed to
//   [k*80 + co][j], are staged in shared memory (16-byte loads when the rows
//   allow it, else bytes), zero-filled past T, K and Co, then mma.sync
//   (m16n8k16 bf16, m16n8k32 s8) or FMAs (f32). The weight is read again
//   for every tile, from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv2_wgmma.cuh"

namespace {

constexpr int C1_WARPS = 8;                  // conv1: rows per block
constexpr int THREADS = 256;                 // 8 warps
constexpr int BM = 128;                      // conv2: output rows per tile
constexpr int A_ROWS = BM + 2;               // input rows a tile reads
constexpr int BN = 80;                       // conv2: channels per tile
constexpr int NB = 3 * BN;                   // weight columns per tile
constexpr int KCB = 64;                      // K chunk, bytes
constexpr int SROW = KCB + 16;               // padded smem row (20 words)
constexpr int NT = BN / 8;                   // mma n-fragments per warp
static_assert(BM == 8 * 16, "conv2: one 16-row m-tile per warp");
static_assert(SROW % 16 == 0, "16-byte staging stores");

enum Mode { BF16_MMA = 0, INT8_MMA = 1, F32_FMA = 2 };

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }

// ------------------------------------------------------------------ conv1

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
conv1_f32_kernel(const float* __restrict__ x, long long rows, int t_in, int c,
                 const float* __restrict__ w1p, const float* __restrict__ b1,
                 OutT* __restrict__ out) {
  const int t_out = t_in - 2, lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * C1_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const long long b = r / t_out;
  const int t = static_cast<int>(r - b * t_out);
  const float* xr = x + b * 2 * t_in + t;
  float xv[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k) xv[h][k] = xr[h * t_in + k];
  OutT* o = out + r * 2 * c;
  for (int q = lane; q < c; q += 32) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * q + e, h = n >= c, cc = n - h * c;
      // Select the plane's inputs, not index by h: keeps xv in registers.
      const float x0 = h ? xv[1][0] : xv[0][0], x1 = h ? xv[1][1] : xv[0][1],
                  x2 = h ? xv[1][2] : xv[0][2];
      float acc = 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(x0, w1p[cc]));
      acc = __fadd_rn(acc, __fmul_rn(x1, w1p[c + cc]));
      acc = __fadd_rn(acc, __fmul_rn(x2, w1p[2 * c + cc]));
      v[e] = fmaxf(__fadd_rn(acc, b1[cc]), 0.0f);
    }
    store2(o + 2 * q, v[0], v[1]);
  }
}

__global__ void __launch_bounds__(THREADS)
conv1_int8_kernel(const int8_t* __restrict__ x, long long rows, int t_in, int c,
                  const int8_t* __restrict__ w1p, const int* __restrict__ m,
                  const int* __restrict__ o, int8_t* __restrict__ out) {
  const int t_out = t_in - 2, lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * C1_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const long long b = r / t_out;
  const int t = static_cast<int>(r - b * t_out);
  const int8_t* xr = x + b * 2 * t_in + t;
  int xv[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k) xv[h][k] = xr[h * t_in + k];
  int8_t* orow = out + r * 2 * c;
  for (int q = lane; q < c; q += 32) {
    int v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * q + e, h = n >= c, cc = n - h * c;
      const int x0 = h ? xv[1][0] : xv[0][0], x1 = h ? xv[1][1] : xv[0][1],
                x2 = h ? xv[1][2] : xv[0][2];
      const int acc = x0 * w1p[cc] + x1 * w1p[c + cc] + x2 * w1p[2 * c + cc];
      v[e] = requant(acc, o[n], m[n]);
    }
    *reinterpret_cast<uint16_t*>(orow + 2 * q) =
        static_cast<uint16_t>(v[0] | (v[1] << 8));
  }
}

// ------------------------------------------------------ conv1 int8, dp4a

constexpr int DP_THREADS = 256;
constexpr int DP_CH = 16;                    // output channels a thread owns
constexpr int DP_MAX_C = DP_THREADS * DP_CH / 2;
constexpr int DP_MAX_T = 8192;               // two frames' words in 32 KB

// Words of shared memory a frame is staged in: its 2T bytes from the aligned
// word at or below its first byte (up to 3 bytes before it), and the word
// after its last window.
__host__ __device__ constexpr int dp_frame_words(int t_in) { return (2 * t_in + 10) / 4; }

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage frame f of x (2 * t_in bytes) into buf: word i holds the 4 bytes at
// (the frame's first byte rounded down to 4) + 4i, zeros past x_end.
__device__ __forceinline__ void dp_stage(const int8_t* x, long long f, int t_in,
                                         uintptr_t x_end, uint32_t* buf) {
  const uintptr_t a0 = (reinterpret_cast<uintptr_t>(x) + f * 2 * t_in) & ~uintptr_t(3);
  for (int i = threadIdx.x; i < dp_frame_words(t_in); i += DP_THREADS) {
    const uintptr_t src = a0 + 4 * static_cast<uintptr_t>(i);
    const bool in = src < x_end;
    cp_async4(smem_u32(buf + i), in ? reinterpret_cast<const void*>(src) : x, in ? 4 : 0);
  }
}

// x (b, 2, t_in) int8, w1p (3, c) int8, m, o (2c,) int32 -> out (b, t_in-2,
// 2c) int8, 16-byte aligned; c % 16 == 0, c <= DP_MAX_C, t_in <= DP_MAX_T.
__global__ void __launch_bounds__(DP_THREADS)
conv1_int8_dp4a_kernel(const int8_t* __restrict__ x, long long b, int t_in, int c,
                       const int8_t* __restrict__ w1p, const int* __restrict__ m,
                       const int* __restrict__ o, int8_t* __restrict__ out) {
  extern __shared__ uint32_t xs[];                    // two frames' words
  const int words = dp_frame_words(t_in);
  const int groups = 2 * c / DP_CH;                   // threads a row
  const int slots = DP_THREADS / groups;              // rows a block does at once
  const int g = threadIdx.x % groups, s = threadIdx.x / groups;
  const int n0 = g * DP_CH, h = n0 >= c, c0 = n0 - h * c;
  uint32_t wp[DP_CH];
  int off[DP_CH], sh[DP_CH];
#pragma unroll
  for (int i = 0; i < DP_CH; ++i) {
    wp[i] = static_cast<uint32_t>(static_cast<uint8_t>(__ldg(w1p + c0 + i))) |
            static_cast<uint32_t>(static_cast<uint8_t>(__ldg(w1p + c + c0 + i))) << 8 |
            static_cast<uint32_t>(static_cast<uint8_t>(__ldg(w1p + 2 * c + c0 + i))) << 16;
    off[i] = __ldg(o + n0 + i);
    sh[i] = __ldg(m + n0 + i);
  }
  const int t_out = t_in - 2;
  const long long n2 = 2LL * c;
  const uintptr_t x_end = reinterpret_cast<uintptr_t>(x) + b * 2 * t_in;
  long long f = blockIdx.x;
  if (f < b) dp_stage(x, f, t_in, x_end, xs);
  cp_async_commit();
  for (int k = 0; f < b; ++k, f += gridDim.x) {
    const uint32_t* cur = xs + (k & 1) * words;
    if (f + gridDim.x < b) dp_stage(x, f + gridDim.x, t_in, x_end, xs + ((k + 1) & 1) * words);
    cp_async_commit();
    cp_async_wait<1>();                               // frame f's words are in
    __syncthreads();
    if (s < slots) {
      const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(x) + f * 2 * t_in) & 3) +
                       h * t_in;
      int8_t* orow = out + f * t_out * n2 + n0;
      for (int t = s; t < t_out; t += slots) {
        const int idx = lead + t;
        const int win = static_cast<int>(
            __funnelshift_r(cur[idx >> 2], cur[(idx >> 2) + 1], 8 * (idx & 3)));
        uint32_t pk[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * q + e;
            r[e] = requant(__dp4a(win, static_cast<int>(wp[i]), 0), off[i], sh[i]);
          }
          pk[q] = __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040),
                              0x5410);
        }
        __stcs(reinterpret_cast<int4*>(orow + t * n2),
               make_int4(static_cast<int>(pk[0]), static_cast<int>(pk[1]),
                         static_cast<int>(pk[2]), static_cast<int>(pk[3])));
      }
    }
    __syncthreads();                                  // cur is staged again next round
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ conv2

// D += A . B, bf16 in, f32 sums, 16 x 8 x 16 (c: the fragment's 4 sums).
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B, int8 in, int32 sums, 16 x 8 x 32.
__device__ __forceinline__ void mma(int* c, const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage bytes [kc, kc + KCB) of the tile's A_ROWS input rows (row t0 + i of
// frame `a`, row_bytes each, t_in rows) into as[i][0..KCB), zeros past the
// frame's rows and the row's bytes. vec: row_bytes and the base are
// multiples of 16, so every 16-byte piece is whole or wholly past the end.
__device__ __forceinline__ void stage_a(const uint8_t* __restrict__ a, int t0,
                                        int t_in, int row_bytes, int kc, int vec,
                                        uint8_t* as) {
  if (vec) {
    for (int i = threadIdx.x; i < A_ROWS * (KCB / 16); i += THREADS) {
      const int row = i / (KCB / 16), q = i % (KCB / 16);
      const int t = t0 + row, byte = kc + q * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < t_in && byte < row_bytes)
        v = *reinterpret_cast<const uint4*>(a + static_cast<long long>(t) * row_bytes + byte);
      *reinterpret_cast<uint4*>(as + row * SROW + q * 16) = v;
    }
  } else {
    for (int i = threadIdx.x; i < A_ROWS * KCB; i += THREADS) {
      const int row = i / KCB, q = i % KCB;
      const int t = t0 + row, byte = kc + q;
      as[row * SROW + q] = (t < t_in && byte < row_bytes)
                               ? a[static_cast<long long>(t) * row_bytes + byte] : 0;
    }
  }
}

// Stage elements [kc/ES, (kc + KCB)/ES) of the tile's weight columns,
// transposed: ws[k*BN + n][j bytes] = w2p[j, k*co + co0 + n], zeros past K
// and Co. Consecutive threads read consecutive columns of a w2p row.
template <int ES>
__device__ __forceinline__ void stage_w(const uint8_t* __restrict__ w2p, int k_in,
                                        int co, int co0, int kc, uint8_t* ws) {
  constexpr int PER = KCB / ES;             // elements per row per chunk
  for (int i = threadIdx.x; i < NB * PER; i += THREADS) {
    const int jj = i / NB, kn = i % NB, k = kn / BN, n = kn % BN;
    const int j = kc / ES + jj, col = co0 + n;
    uint8_t* dst = ws + kn * SROW + jj * ES;
    const bool ok = j < k_in && col < co;
    const uint8_t* src = w2p + (static_cast<long long>(j) * 3 * co + k * co + col) * ES;
    if constexpr (ES == 1) {
      *dst = ok ? *src : 0;
    } else if constexpr (ES == 2) {
      *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
    } else {
      *reinterpret_cast<uint32_t*>(dst) = ok ? *reinterpret_cast<const uint32_t*>(src) : 0;
    }
  }
}

// a: (B, t_in, k_in) of the mode's type; w2p: (k_in, 3*co); b2: (co,) f32
// (float modes); m2, o2: (co,) int32 (INT8_MMA); out: (B, t_in-2, co).
// Grid: x = frame * row_tiles + row tile, y = channel tile.
template <int MODE, typename OutT>
__global__ void __launch_bounds__(THREADS)
conv2_kernel(const uint8_t* __restrict__ a, int row_tiles, int t_in, int k_in,
             int co, const uint8_t* __restrict__ w2p, const float* __restrict__ b2,
             const int* __restrict__ m2, const int* __restrict__ o2, int vec,
             OutT* __restrict__ out) {
  constexpr int ES = MODE == BF16_MMA ? 2 : MODE == INT8_MMA ? 1 : 4;
  __shared__ __align__(16) uint8_t as[A_ROWS * SROW];
  __shared__ __align__(16) uint8_t ws[NB * SROW];
  const int t_out = t_in - 2, row_bytes = k_in * ES;
  const long long f = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * BM, co0 = blockIdx.y * BN;
  const uint8_t* af = a + f * static_cast<long long>(t_in) * row_bytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // Tensor cores: warp w owns tile rows 16w..16w+15 and all BN channels.
  // CUDA cores (f32): thread (tr, tc) owns rows 8tr..8tr+7, channels
  // 5tc..5tc+4.
  constexpr int ACC = MODE == F32_FMA ? 8 * 5 : NT * 4;
  using Acc = typename std::conditional<MODE == INT8_MMA, int, float>::type;
  Acc acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  const int tr = tid / 16, tc = tid % 16;

  for (int kc = 0; kc < row_bytes; kc += KCB) {
    __syncthreads();                         // the previous chunk is consumed
    stage_a(af, t0, t_in, row_bytes, kc, vec, as);
    stage_w<ES>(w2p, k_in, co, co0, kc, ws);
    __syncthreads();
    if constexpr (MODE == F32_FMA) {
#pragma unroll 1
      for (int jj = 0; jj < KCB / 4; ++jj) {
        float av[10];
#pragma unroll
        for (int r = 0; r < 10; ++r)
          av[r] = *reinterpret_cast<const float*>(as + (8 * tr + r) * SROW + 4 * jj);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int cc = 0; cc < 5; ++cc) {
            const float w = *reinterpret_cast<const float*>(
                ws + (k * BN + 5 * tc + cc) * SROW + 4 * jj);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r * 5 + cc] = fmaf(av[r + k], w, acc[r * 5 + cc]);
          }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint8_t* arow = as + (warp * 16 + k + g) * SROW + 4 * tig;
        const uint8_t* brow = ws + (k * BN + g) * SROW + 4 * tig;
#pragma unroll
        for (int kb = 0; kb < KCB; kb += 32) {
          const uint32_t af4[4] = {lds32(arow + kb), lds32(arow + 8 * SROW + kb),
                                   lds32(arow + kb + 16), lds32(arow + 8 * SROW + kb + 16)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint8_t* p = brow + j * 8 * SROW + kb;
            mma(acc + 4 * j, af4, lds32(p), lds32(p + 16));   // bf16 or int8 by Acc
          }
        }
      }
    }
  }

  OutT* of = out + f * static_cast<long long>(t_out) * co;
  if constexpr (MODE == F32_FMA) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = t0 + 8 * tr + r;
      if (t >= t_out) continue;
#pragma unroll
      for (int cc = 0; cc < 5; ++cc) {
        const int ch = co0 + 5 * tc + cc;
        if (ch < co)
          store1(of + static_cast<long long>(t) * co + ch,
                 fmaxf(__fadd_rn(acc[r * 5 + cc], b2[ch]), 0.0f));
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + warp * 16 + g + half * 8;
      if (t >= t_out) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = co0 + j * 8 + 2 * tig + e;
          if (ch >= co) continue;
          const Acc v = acc[4 * j + 2 * half + e];
          OutT* dst = of + static_cast<long long>(t) * co + ch;
          if constexpr (MODE == INT8_MMA) {
            *dst = static_cast<int8_t>(requant(v, o2[ch], m2[ch]));
          } else {
            store1(dst, fmaxf(__fadd_rn(v, b2[ch]), 0.0f));
          }
        }
    }
  }
}

template <int MODE, typename OutT>
int launch_conv2(const void* a, long long b, int t_in, int k_in, int co,
                 const void* w2p, const float* b2, const int* m2, const int* o2,
                 int vec, void* out, void* stream) {
  const int t_out = t_in - 2;
  const int row_tiles = (t_out + BM - 1) / BM;
  const long long bx = b * row_tiles;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(bx), (co + BN - 1) / BN);
  conv2_kernel<MODE, OutT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), row_tiles, t_in, k_in, co,
      static_cast<const uint8_t*>(w2p), b2, m2, o2, vec, static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- conv2, the Hopper route

// The consumer (products, resident weight, int8 epilogue) is
// conv2_wgmma.cuh's, shared with conv_stage_int8.cu.
constexpr int WG_THREADS = WG_CONSUMERS + 32;   // and one producer warp
constexpr int A_TX = A_ROWS * WG_CHUNK;         // bytes one box brings
constexpr int STAGES = 6;
constexpr int RING_BYTES = STAGES * WG_STAGE;
constexpr int WG_MAX_K = 512;                   // the resident weight's budget, in elements
static_assert(A_ROWS == WG_ROWS, "a box is a stage's rows");
static_assert(1024 + RING_BYTES + WG_MAX_K * 2 * 120 + 2 * STAGES * 8 <= 232448,
              "ring, weight and barriers fit the 227 KB a block may have");
static_assert(2 * (1024 + RING_BYTES + WG_CHUNK * 120) > 228 * 1024,
              "one block per SM at any K: the grid is one block per SM");

// Per mode: element size, channels per block (the weight of 3 * NT columns
// and K <= 512 is 122,880 bytes in both), the accumulator type.
template <int MODE> struct Wg;
template <> struct Wg<BF16_MMA> {
  static constexpr int ES = 2, NT = 40;
  using Acc = float;
};
template <> struct Wg<INT8_MMA> {
  static constexpr int ES = 1, NT = 80;
  using Acc = int;
};

// a: the (B, t_in, k_in) map as a 3-D tensor map, boxes of 130 rows x 128
// bytes in the 128-byte swizzle (rows past t_in and bytes past k_in read as
// zeros). Work item w = frame * row_tiles + row tile; block (x, y) takes
// items x, x + gridDim.x, ... for channels [y*NT, y*NT + NT).
template <int MODE, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
conv2_wgmma_kernel(const __grid_constant__ CUtensorMap amap, long long items, int row_tiles,
                   int t_in, int k_in, int co, int k_chunks,
                   const uint8_t* __restrict__ w2p, const float* __restrict__ b2,
                   const int* __restrict__ m2, const int* __restrict__ o2,
                   OutT* __restrict__ out) {
  using W = Wg<MODE>;
  using Acc = typename W::Acc;
  constexpr int NB = 3 * W::NT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  const uint32_t ws = base + RING_BYTES;
  const uint32_t full = ws + k_chunks * WG_CHUNK * NB, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int co0 = blockIdx.y * W::NT;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // the producer: lane 0 keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (long long w = blockIdx.x; w < items; w += gridDim.x) {
        const int f = static_cast<int>(w / row_tiles), t0 = static_cast<int>(w % row_tiles) * BM;
        for (int c = 0; c < k_chunks; ++c, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, A_TX);
          tma_load_3d(base + s * WG_STAGE, &amap, c * (WG_CHUNK / W::ES), t0, f, full + 8 * s);
        }
      }
    }
    return;
  }

  // The consumers: the weight once, while the first boxes arrive.
  stage_w2p_resident<W::ES, W::NT>(w2p, k_in, co, co0, 2 * k_chunks, smem_raw + (ws - raw));
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");

  // Warpgroup g owns tile rows 64g .. 64g + 63 (warp w of it rows 16(w%4)
  // .. +15 of those). For tap k its A is the same tile moved down k rows:
  // a descriptor start k * 128 bytes further, so the shift-add happens in
  // the accumulator. Epilogue constants stay in registers for the launch.
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16, a_row0 = (warp / 4) * 64;
  const int t_out = t_in - 2, g = lane >> 2, tq = lane & 3;
  Acc ep0[W::NT / 8][2], ep1[W::NT / 8][2];   // bf16: bias; int8: shift, offset
  if constexpr (MODE == INT8_MMA) {
    load_rq2<W::NT>(m2, o2, co0, co, ep0, ep1);
  } else {
#pragma unroll
    for (int j = 0; j < W::NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = co0 + 8 * j + 2 * tq + e;
        ep0[j][e] = ch < co ? __ldg(b2 + ch) : 0.0f;
      }
  }
  int it = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const long long f = w / row_tiles;
    const int t0 = static_cast<int>(w % row_tiles) * BM;
    Acc acc[W::NT / 2];
#pragma unroll
    for (int i = 0; i < W::NT / 2; ++i) acc[i] = 0;
#pragma unroll 1
    for (int c = 0; c < k_chunks; ++c, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      __syncwarp();                  // converged again for the .aligned products
      stage_products<W::NT>(acc, base + s * WG_STAGE + a_row0 * WG_CHUNK,
                            ws + 2 * c * (NB * 64));
      wgmma_wait<1>();               // the previous chunk's products are done:
      __syncwarp();                  // this warp releases its stage
      if (c > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < W::NT / 2; ++i) pin(acc[i]);

    OutT* of = out + f * static_cast<long long>(t_out) * co;
    const int r_lo = t0 + row0 + g, r_hi = r_lo + 8;
    if constexpr (MODE == INT8_MMA) {
      store_rq2<W::NT>(acc, ep0, ep1, of, r_lo, co0, co, t_out);
    } else {
#pragma unroll
      for (int j = 0; j < W::NT / 8; ++j) {
        const int ch = co0 + 8 * j + 2 * tq;    // this lane's two channels (Co % 4 == 0)
        if (ch < co) {
          if (r_lo < t_out)
            store2(of + static_cast<long long>(r_lo) * co + ch,
                   fmaxf(__fadd_rn(acc[4 * j], ep0[j][0]), 0.0f),
                   fmaxf(__fadd_rn(acc[4 * j + 1], ep0[j][1]), 0.0f));
          if (r_hi < t_out)
            store2(of + static_cast<long long>(r_hi) * co + ch,
                   fmaxf(__fadd_rn(acc[4 * j + 2], ep0[j][0]), 0.0f),
                   fmaxf(__fadd_rn(acc[4 * j + 3], ep0[j][1]), 0.0f));
        }
      }
    }
  }
}

// The Hopper route's envelope (ops/cnn_kernels.py::conv2_route): rows of
// whole 16-byte units (TMA's stride rule), the weight within its budget,
// channels in groups of 4 (the epilogue's 4-byte stores).
bool conv2_wgmma_fits(int k_in, int co, int es) {
  return k_in >= 1 && k_in <= WG_MAX_K && k_in * es % 16 == 0 && co > 0 && co % 4 == 0;
}

// Persistent blocks, one per SM (the ring and the smallest weight take more
// than half of the SM's 228 KB): sms / channel tiles blocks per channel
// tile, all resident at once, so the blocks of a frame's channel tiles run
// side by side and its second read of the map hits L2.
// cudaErrorInvalidValue outside the envelope, for an unaligned pointer, or
// if the tensor map cannot be made.
template <int MODE, typename OutT>
int launch_conv2_wgmma(const void* a, long long b, int t_in, int k_in, int co,
                       const void* w2p, const float* b2, const int* m2, const int* o2,
                       void* out, void* stream) {
  using W = Wg<MODE>;
  constexpr int NB = 3 * W::NT;
  if (!conv2_wgmma_fits(k_in, co, W::ES) || t_in < 3 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(w2p) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_in), static_cast<cuuint64_t>(t_in),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k_in) * W::ES,
                                 static_cast<cuuint64_t>(t_in) * k_in * W::ES};
  const cuuint32_t box[3] = {WG_CHUNK / W::ES, A_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&amap, W::ES == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             3, const_cast<void*>(a), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (t_in - 2 + BM - 1) / BM;
  const long long items = b * row_tiles;
  const int k_chunks = (k_in * W::ES + WG_CHUNK - 1) / WG_CHUNK;
  const int smem = 1024 + RING_BYTES + k_chunks * WG_CHUNK * NB + 2 * STAGES * 8;
  const int tiles_c = (co + W::NT - 1) / W::NT;
  if (tiles_c > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = conv2_wgmma_kernel<MODE, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long gx = sms / tiles_c;
  gx = gx < 1 ? 1 : gx > items ? items : gx;
  const dim3 grid(static_cast<unsigned>(gx), tiles_c);
  kernel<<<grid, WG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      amap, items, row_tiles, t_in, k_in, co, k_chunks, static_cast<const uint8_t*>(w2p), b2,
      m2, o2, static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- conv2 float32, the FFMA route

constexpr int FF_BN = 80;                       // channels a block owns: 16 quads + 16 singles
constexpr int FF_KC = WG_CHUNK / 4;             // K a stage holds: one 128-byte row of floats
constexpr int FF_STAGES = 4;
constexpr int FF_WARPS = 8;                     // consumer warps, 2 per scheduler
constexpr int FF_CONSUMERS = 32 * FF_WARPS;
constexpr int FF_THREADS = FF_CONSUMERS + 32;   // and one producer warp
constexpr int FF_P = 2;                         // a thread's rows: runs of FF_P, 8 FF_P apart
constexpr int FF_WARP_ROWS = BM * 4 / FF_WARPS; // rows a warp owns (4 warps side by side)
constexpr int FF_W_TAP = FF_KC * FF_BN * 4;     // one tap's weight box: 10,240 bytes
constexpr int FF_W_ROWS4 = 4 * FF_BN * 4;       // 4 rows of a tap's box, bytes
constexpr int FF_STAGE = WG_STAGE + 3 * FF_W_TAP;
constexpr int FF_TX = A_ROWS * WG_CHUNK + 3 * FF_W_TAP;    // bytes one stage's boxes bring
constexpr int FF_SMEM = 1024 + FF_STAGES * FF_STAGE + 2 * FF_STAGES * 8;
static_assert(FF_BN == 4 * 16 + 16, "16 threads a row: 4 channels and 1 each");
static_assert(FF_WARPS % 4 == 0 && FF_WARP_ROWS % (8 * FF_P) == 0,
              "whole warps per scheduler; a warp's rows in runs of 8 P");
static_assert(FF_STAGE % 1024 == 0, "stages on the swizzle's 1024-byte atom");
static_assert(FF_SMEM <= 232448, "the ring fits the 227 KB a block may have");
static_assert(2 * FF_SMEM > 228 * 1024, "one block per SM: the grid is one block per SM");

__device__ __forceinline__ void store4(float* o, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A thread's weights for 4 rows j of a stage (w_j: the first row of tap
// 0's box): per row q and tap k, channels 4n .. 4n+3 and 64 + n.
struct FfWeights {
  float4 quad[4][3];
  float one[4][3];
};

__device__ __forceinline__ void ff_load_weights(FfWeights& w, const uint8_t* w_j, int n) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint8_t* p = w_j + k * FF_W_TAP + q * FF_BN * 4;
      w.quad[q][k] = *reinterpret_cast<const float4*>(p + 16 * n);
      w.one[q][k] = *reinterpret_cast<const float*>(p + 4 * (64 + n));
    }
}

// The products of chunk j4 (K j .. j+3) into a thread's M x P rows x 5
// channels: map row row0 + d + 8P m's chunk j4 lies at aoff[d] ^ (j4 << 4)
// plus 1024 P m of the stage; tap k of row e reads map row e + k, so the
// shift-add happens in the accumulator.
template <int M, int P, int D>
__device__ __forceinline__ void ff_chunk(float (&acc)[M][P][5], const FfWeights& w,
                                         const uint8_t* a_st, const uint32_t (&aoff)[D], int j4) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float4 a[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
      a[d] = *reinterpret_cast<const float4*>(a_st + ((aoff[d] ^ (j4 << 4)) +
                                                      m * 8 * P * WG_CHUNK));
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const float x = lane4(a[e + k], q);
          float* o = acc[m][e];
          o[0] = fmaf(x, w.quad[q][k].x, o[0]);
          o[1] = fmaf(x, w.quad[q][k].y, o[1]);
          o[2] = fmaf(x, w.quad[q][k].z, o[2]);
          o[3] = fmaf(x, w.quad[q][k].w, o[3]);
          o[4] = fmaf(x, w.one[q][k], o[4]);
        }
  }
}

// a: the map as B * t_in rows of K floats (a 2-D tensor map), boxes of 130
// rows x 32 floats in the 128-byte swizzle; w: w2p (K, 3Co) as a 2-D tensor
// map, boxes of 32 rows x 80 columns, no swizzle. Rows past B * t_in and
// columns past K or 3Co read as zeros. Work item w is the 128 rows from
// 128 w on (a tile may span two frames: its rows t >= t_out mix two frames
// and are not stored); block (x, y) takes items x, x + gridDim.x, ... for
// channels [80y, 80y + 80). A stage holds K j .. j+31: the map's box, then
// tap k's box of w2p's columns k*Co + 80y .. +79 (columns of the next tap
// or past 3Co, where the tile passes Co, feed only channels not stored).
template <typename OutT>
__global__ void __launch_bounds__(FF_THREADS, 1)
conv2_ffma_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap wmap,
                  int items, int rows, int t_in, int co, int k_stages,
                  const float* __restrict__ b2, OutT* __restrict__ out) {
  constexpr int P = FF_P, M = FF_WARP_ROWS / (8 * P), D = P + 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t full = base + FF_STAGES * FF_STAGE, empty = full + 8 * FF_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int co0 = blockIdx.y * FF_BN;
  if (tid == 0) {
    for (int s = 0; s < FF_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, FF_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == FF_WARPS) {  // the producer: lane 0 keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int c = 0; c < k_stages; ++c, ++it) {
          const int s = it % FF_STAGES;
          const uint32_t bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ((it / FF_STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, FF_TX);
          tma_load(sm + s * FF_STAGE, &amap, c * FF_KC, w * BM, bar);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            tma_load(sm + s * FF_STAGE + WG_STAGE + k * FF_W_TAP, &wmap, k * co + co0, c * FF_KC,
                     bar);
        }
      }
    }
    return;
  }

  // Thread (lane / 4, lane % 4) of warp w owns tile rows row0 + 8P m + e
  // (m < M, e < P), row0 = FF_WARP_ROWS (w / 4) + P (lane / 4), and
  // channels 4n .. 4n+3 and 64 + n of the block's 80, n = 4 (w % 4) + lane % 4:
  // the 4 lanes of a row read one map address (a broadcast), the 8 rows of
  // an instruction fall on 8/P swizzle phases. aoff[d] is map row row0 + d
  // with its swizzle phase folded in (ff_chunk).
  const int n = 4 * (warp & 3) + (lane & 3);
  const int row0 = FF_WARP_ROWS * (warp >> 2) + P * (lane >> 2);
  uint32_t aoff[D];
#pragma unroll
  for (int d = 0; d < D; ++d) aoff[d] = (row0 + d) * WG_CHUNK | ((row0 + d) & 7) << 4;
  float bias[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int ch = co0 + (i < 4 ? 4 * n + i : 64 + n);
    bias[i] = ch < co ? __ldg(b2 + ch) : 0.0f;
  }
  const int t_out = t_in - 2;
  int it = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    float acc[M][P][5];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < P; ++e)
#pragma unroll
        for (int i = 0; i < 5; ++i) acc[m][e][i] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < k_stages; ++c, ++it) {
      const int s = it % FF_STAGES;
      mbar_wait(full + 8 * s, (it / FF_STAGES) & 1);
      const uint8_t* a_st = sm + s * FF_STAGE;
      const uint8_t* w_st = a_st + WG_STAGE;
#pragma unroll 2
      for (int j4 = 0; j4 < FF_KC / 4; ++j4) {   // K j .. j+3: one 16-byte chunk of each row
        FfWeights wj;
        ff_load_weights(wj, w_st + j4 * FF_W_ROWS4, n);
        ff_chunk(acc, wj, a_st, aoff, j4);
      }
      __syncwarp();                  // the warp is done with the stage: release it
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int e = 0; e < P; ++e) {
        const int r = w * BM + row0 + 8 * P * m + e, f = r / t_in, t = r - f * t_in;
        if (r >= rows || t >= t_out) continue;
        OutT* o = out + (static_cast<long long>(f) * t_out + t) * co + co0;
        const float* v = acc[m][e];
        if (co0 + 4 * n < co)     // Co % 4 == 0: the 4 channels are all in or all out
          store4(o + 4 * n, fmaxf(__fadd_rn(v[0], bias[0]), 0.0f),
                 fmaxf(__fadd_rn(v[1], bias[1]), 0.0f), fmaxf(__fadd_rn(v[2], bias[2]), 0.0f),
                 fmaxf(__fadd_rn(v[3], bias[3]), 0.0f));
        if (co0 + 64 + n < co) store1(o + 64 + n, fmaxf(__fadd_rn(v[4], bias[4]), 0.0f));
      }
  }
}

// The FFMA route's envelope (ops/cnn_kernels.py::conv2_route): rows of
// whole 16-byte units for both tensor maps (the map's K * 4 bytes, w2p's
// 3 Co * 4 bytes), channels in groups of 4 (the epilogue's 16-byte
// stores). The weight is streamed, so K has no limit.
bool conv2_ffma_fits(int k_in, int co) {
  return k_in >= 4 && k_in % 4 == 0 && co >= 4 && co % 4 == 0;
}

// Persistent blocks, one per SM (the 4-stage ring takes 189 KB): sms /
// channel tiles blocks per channel tile. cudaErrorInvalidValue outside the
// envelope, for an unaligned pointer, or if a tensor map cannot be made.
template <typename OutT>
int launch_conv2_ffma(const void* a, long long b, int t_in, int k_in, int co, const void* w2p,
                      const float* b2, void* out, void* stream) {
  if (!conv2_ffma_fits(k_in, co) || t_in < 3 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w2p) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = b * t_in;     // row coordinates and items are int
  if (rows > 0x7fffffffLL - 2 * BM) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap amap, wmap;
  const cuuint64_t adims[2] = {static_cast<cuuint64_t>(k_in), static_cast<cuuint64_t>(rows)};
  const cuuint64_t astrides[1] = {static_cast<cuuint64_t>(k_in) * 4};
  const cuuint32_t abox[2] = {FF_KC, A_ROWS};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(3) * co, static_cast<cuuint64_t>(k_in)};
  const cuuint64_t wstrides[1] = {static_cast<cuuint64_t>(3) * co * 4};
  const cuuint32_t wbox[2] = {FF_BN, FF_KC};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(a), adims, astrides,
             abox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w2p), wdims, wstrides,
             wbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = static_cast<int>((rows + BM - 1) / BM);
  const int k_stages = (k_in + FF_KC - 1) / FF_KC;
  const int tiles_c = (co + FF_BN - 1) / FF_BN;
  if (tiles_c > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = conv2_ffma_kernel<OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FF_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gx = sms / tiles_c;
  gx = gx < 1 ? 1 : gx > items ? items : gx;
  const dim3 grid(gx, tiles_c);
  kernel<<<grid, FF_THREADS, FF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      amap, wmap, items, static_cast<int>(rows), t_in, co, k_stages, b2,
      static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

long long conv1_blocks(long long b, int t_in) {
  return (b * (t_in - 2) + C1_WARPS - 1) / C1_WARPS;
}

}  // namespace

// x (B, 2, t_in) f32, w1p (3, c) f32, b1 (c,) f32 -> out (B, t_in-2, 2c),
// bf16 when out_f32 is 0, else f32.
extern "C" int amc_conv1_stacked(const void* x, long long b, int t_in, int c,
                                 const void* w1p, const void* b1, int out_f32,
                                 void* out, void* stream) {
  const long long blocks = conv1_blocks(b, t_in);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(w1p);
  const auto* bias = static_cast<const float*>(b1);
  if (out_f32)
    conv1_f32_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        xf, b * (t_in - 2), t_in, c, w, bias, static_cast<float*>(out));
  else
    conv1_f32_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        xf, b * (t_in - 2), t_in, c, w, bias, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x (B, 2, t_in) int8, w1p (3, c) int8, m, o (2c,) int32 -> (B, t_in-2, 2c) int8.
extern "C" int amc_conv1_stacked_int8(const void* x, long long b, int t_in, int c,
                                      const void* w1p, const void* m, const void* o,
                                      void* out, void* stream) {
  const long long blocks = conv1_blocks(b, t_in);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv1_int8_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), b * (t_in - 2), t_in, c,
      static_cast<const int8_t*>(w1p), static_cast<const int*>(m),
      static_cast<const int*>(o), static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The dp4a route of amc_conv1_stacked_int8, on the same arguments, for c a
// multiple of 16 with 16 <= c <= DP_MAX_C, 3 <= t_in <= DP_MAX_T and out
// 16-byte aligned (else cudaErrorInvalidValue, before any launch).
extern "C" int amc_conv1_stacked_int8_dp4a(const void* x, long long b, int t_in, int c,
                                           const void* w1p, const void* m, const void* o,
                                           void* out, void* stream) {
  if (c % DP_CH || c < DP_CH || c > DP_MAX_C || t_in < 3 || t_in > DP_MAX_T ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return 0;
  const int smem = 2 * dp_frame_words(t_in) * static_cast<int>(sizeof(uint32_t));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv1_int8_dp4a_kernel,
                                                        DP_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  if (grid > b) grid = b;
  conv1_int8_dp4a_kernel<<<static_cast<unsigned>(grid), DP_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), b, t_in, c, static_cast<const int8_t*>(w1p),
      static_cast<const int*>(m), static_cast<const int*>(o), static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a1s (B, t_in, k_in) and w2p (k_in, 3co), both bf16 (in_f32 0) or both f32
// (in_f32 1); b2 (co,) f32 -> (B, t_in-2, co), bf16 (out_f32 0) or f32.
// vec: k_in * element size and a1s's address are multiples of 16.
extern "C" int amc_conv2_stacked(const void* a1s, long long b, int t_in, int k_in,
                                 int co, const void* w2p, const void* b2, int in_f32,
                                 int out_f32, int vec, void* out, void* stream) {
  const auto* bias = static_cast<const float*>(b2);
  if (in_f32)
    return out_f32 ? launch_conv2<F32_FMA, float>(a1s, b, t_in, k_in, co, w2p, bias,
                                                  nullptr, nullptr, vec, out, stream)
                   : launch_conv2<F32_FMA, __nv_bfloat16>(a1s, b, t_in, k_in, co, w2p,
                                                          bias, nullptr, nullptr, vec,
                                                          out, stream);
  return out_f32 ? launch_conv2<BF16_MMA, float>(a1s, b, t_in, k_in, co, w2p, bias,
                                                 nullptr, nullptr, vec, out, stream)
                 : launch_conv2<BF16_MMA, __nv_bfloat16>(a1s, b, t_in, k_in, co, w2p,
                                                         bias, nullptr, nullptr, vec,
                                                         out, stream);
}

// a1s (B, t_in, k_in) int8, w2p (k_in, 3co) int8, m, o (co,) int32 ->
// (B, t_in-2, co) int8.
extern "C" int amc_conv2_stacked_int8(const void* a1s, long long b, int t_in,
                                      int k_in, int co, const void* w2p, const void* m,
                                      const void* o, int vec, void* out, void* stream) {
  return launch_conv2<INT8_MMA, int8_t>(a1s, b, t_in, k_in, co, w2p, nullptr,
                                        static_cast<const int*>(m),
                                        static_cast<const int*>(o), vec, out, stream);
}

// The Hopper route of amc_conv2_stacked, for bf16 a1s and w2p inside
// conv2_wgmma_fits, both 16-byte aligned (else cudaErrorInvalidValue):
// b2 (co,) f32 -> (B, t_in-2, co), bf16 (out_f32 0) or f32.
extern "C" int amc_conv2_stacked_wgmma(const void* a1s, long long b, int t_in, int k_in,
                                       int co, const void* w2p, const void* b2, int out_f32,
                                       void* out, void* stream) {
  const auto* bias = static_cast<const float*>(b2);
  return out_f32 ? launch_conv2_wgmma<BF16_MMA, float>(a1s, b, t_in, k_in, co, w2p, bias,
                                                       nullptr, nullptr, out, stream)
                 : launch_conv2_wgmma<BF16_MMA, __nv_bfloat16>(a1s, b, t_in, k_in, co, w2p,
                                                               bias, nullptr, nullptr, out,
                                                               stream);
}

// The FFMA route of amc_conv2_stacked, for float32 a1s and w2p inside
// conv2_ffma_fits, both 16-byte aligned (else cudaErrorInvalidValue):
// b2 (co,) f32 -> (B, t_in-2, co), bf16 (out_f32 0) or f32.
extern "C" int amc_conv2_stacked_ffma(const void* a1s, long long b, int t_in, int k_in, int co,
                                      const void* w2p, const void* b2, int out_f32, void* out,
                                      void* stream) {
  const auto* bias = static_cast<const float*>(b2);
  return out_f32 ? launch_conv2_ffma<float>(a1s, b, t_in, k_in, co, w2p, bias, out, stream)
                 : launch_conv2_ffma<__nv_bfloat16>(a1s, b, t_in, k_in, co, w2p, bias, out,
                                                    stream);
}

// The Hopper route of amc_conv2_stacked_int8, on the same terms.
extern "C" int amc_conv2_stacked_int8_wgmma(const void* a1s, long long b, int t_in,
                                            int k_in, int co, const void* w2p, const void* m,
                                            const void* o, void* out, void* stream) {
  return launch_conv2_wgmma<INT8_MMA, int8_t>(a1s, b, t_in, k_in, co, w2p, nullptr,
                                              static_cast<const int*>(m),
                                              static_cast<const int*>(o), out, stream);
}
