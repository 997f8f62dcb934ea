// Fused bf16 conv stages, for Hopper (sm_90a). One templated body, three C
// entry points, which differ only in how conv1's input arrives:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_v4_kernel
//   (ops/infer.py:1819, reached by pl.pallas_call in make_bf16_classifier_v4,
//   ops/infer.py:1921) with amc_conv_stage_bf16_v4, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_v2_kernel
//   (ops/infer.py:199, make_bf16_forward_v2, ops/infer.py:272) with
//   amc_conv_stage_bf16_v2, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_kernel
//   (ops/infer.py:82, make_bf16_forward, ops/infer.py:150) with
//   amc_conv_stage_bf16.
//
// Computes, per frame, conv1 into a1 (126, 512) bf16 (n = h*256 + c):
//   v4 (IN_FRAME_BF16), x (B, 2, 128) f32, rounded here: xb = bf16_rn(x)
//     (the TPU kernel read the (B, 8, 128) bf16 tap planes that an XLA
//     prologue built from the same frames)
//     a1[t, n] = bf16_rn(relu(((xb[h,t] * w1e[3h,n] + xb[h,t+1] * w1e[3h+1,n])
//                              + xb[h,t+2] * w1e[3h+2,n]) + w1e[6,n]))
//   v2 (IN_TAP_ROWS), xe (B, 126, 8) bf16 tap rows (ops/infer_bf16.py's
//     expand_taps_bf16, the XLA prologue of make_bf16_forward_v2: lane 3h+k
//     of row t is xb[h, t+k], lane 6 is 1.0, lane 7 zero)
//     a1[t, n] = bf16_rn(relu(((xe[t,3h] * w1e[3h,n] + xe[t,3h+1] * w1e[3h+1,n])
//                              + xe[t,3h+2] * w1e[3h+2,n]) + xe[t,6] * w1e[6,n]))
//     (lane 7 and the other plane's lanes meet zeros of the block-diagonal
//     w1e and add exact zeros, so they are skipped): v4's a1 on the same
//     frames, bit for bit, since xe[t,6] * w1e[6,n] = w1e[6,n] exactly.
//   bf16 (IN_FRAME_F32), x (B, 2, 128) f32, NOT rounded; w1p (3, 256) and
//     b1 (512,) f32 (conv1's taps and its bias duplicated over the planes):
//     a1[t, n] = bf16_rn(relu(((x[h,t] * w1p[0,c] + x[h,t+1] * w1p[1,c])
//                              + x[h,t+2] * w1p[2,c]) + b1[n]))
//     in the JAX kernel's order (conv1_accumulate, then + b1). Its products
//     are not exact, so each one and each sum is rounded on its own
//     (__fmul_rn, __fadd_rn; an FMA would round once).
// Every product of v4 and v2 is of two bf16 values, exact in f32, so an FMA
// that adds one rounds exactly as the plain version's separate add; all
// three sum in the plain versions' order, so a1 is bit-exact against them.
// Then, for all three:
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2t[k*80+co, j]            f32, t < 124
//   out[t, co] = bf16_rn(relu(s + b2[co]))                     (124, 80) bf16
// The reference sums z_k = a1[t+k] . w2[:, k] per tap, then z0 + z1 + z2 +
// b2; the tensor cores sum the products in their own order, so the map
// differs from the plain version's only by the order of f32 sums. That
// order is fixed by the design below and does not depend on B: a frame's
// map is the same bit for bit at every batch size.
//
// Bound on the H100 SXM at B = 4096: conv1 2*B*126*512*3 ~ 1.6 G plus conv2
// 2*B*124*80*1536 ~ 124.8 G bf16 operations (~0.128 ms at 989 TFLOP/s)
// against ~85 MB moved (the (B, 124, 80) bf16 map written once, ~0.025 ms
// at 3.35 TB/s): operation-bound, ~0.128 ms. The bf16 entry's conv1 is
// ~1.6 GFLOP of f32 (~0.024 ms at 67 TFLOP/s) on pipes that run beside the
// tensor cores, so its bound is the larger of that and conv2's bf16
// operations alone (~0.126 ms).
//
// Design. conv2's K is split by I/Q plane between the two blocks of a
// 2-block cluster. conv1 is block-diagonal (channel h*256 + c depends only
// on x[h]) and w2t is [k*80 + co, h*256 + c], so block h (its cluster rank)
// needs only plane h of a frame, builds only its own half of conv1 (126 x
// 256: the pair builds each frame's conv1 once) and holds only w2t[:, h*256
// .. h*256+255] resident, 240 x 256 bf16 = 122,880 bytes, in the K-major
// 64-byte-swizzled columns of conv2_wgmma.cuh (w_resident_offset<240>): per
// block, row 1's (conv_stage_int8.cu) geometry with bf16 in place of s8.
// Each cluster is persistent and walks frames c, c + clusters, ... (both
// blocks the same frames: the handshake below needs every loop bound
// equal); the launch holds cudaOccupancyMaxActiveClusters clusters, fewer
// when B is smaller.
//   Producers: 8 warps build plane h's conv1 into a 4-stage ring; a stage
// is one 128-byte chunk (64 bf16 channels x 130 rows, 17 KB, 128-byte
// swizzle), so a plane is 4 chunks and stage c always holds chunk c. The
// frame's input is staged per frame as one float4 window per row, (x[t],
// x[t+1], x[t+2], 1) (v4, f32; the frame's plane) or (xe[t,3h..3h+2],
// xe[t,6]) (v2), double-buffered by frame parity and loaded one frame
// ahead. Warp p writes rows t = p + 8q (one swizzle phase a warp), one
// 128-byte row a step and 2 channels a lane, their 4 constants each for
// all 4 chunks in registers; it loads 8 rows' windows before their stores
// (one row at a time, each load waiting on the last store, the producers
// alone ran 1.4x slower). Per row: a broadcast 16-byte load of the window, a
// product and three FMAs per channel (v4, v2; row 12: 3 products and 3
// adds, each rounded), one cvt.rn.relu.bf16x2 and one 4-byte st.shared,
// about 5.5 instructions per output (7.5 for row 12). Each writer fences
// its st.shared against the async proxy before it arrives on the stage's
// `full` mbarrier. Ring rows 126..129 are zeroed once: they feed only
// output rows 124..127, which are never stored. conv1 stays on the CUDA
// cores: the tensor cores' own sum order would break the bit-exact conv1.
//   Consumers: two warpgroups own 64 of the 128 rows each and run wgmma
// m64n80k16 bf16 -> f32 on the resident weight, tap k's A the stage moved
// down k rows (conv2_wgmma.cuh::stage_products), releasing a stage on
// `empty` with one product group left in flight.
//   The pair's sum, through distributed shared memory: block r finishes
// output rows [64r, 64r + 64), its warpgroup r's. Its other warpgroup waits
// until the peer's receive buffer is free (`recv_empty`), then writes its
// 64 x 80 f32 partial (20 KB, float4s in fragment order) into it with
// st.async, each 16 bytes counted as complete_tx bytes on the peer's
// `recv_full`, which the peer's finisher arms with the 20 KB it expects:
// no fence and no arrival per thread. Warpgroup r waits on its own
// `recv_full`, adds the peer's partial to its own (two terms: the same
// bits in either order), its first thread returns the buffer with one
// remote arrival on the peer's `recv_empty`, then it adds b2, rounds with
// ReLU to bf16 into a 64 x 80 tile in shared memory, and its first thread
// copies the tile out with one bulk copy (the rows are contiguous in the
// map). (The first body, with a remote arrival of cluster-scope release
// from each of the 128 threads on both sides and one window loaded a row,
// ran 0.289 ms at B=4096; this one 0.2455.) Shared memory per block: 1 KB
// of alignment, 68 KB of ring, 120 KB of weight, 20 KB receive buffer, 10
// KB tile, 4 KB of windows; one block per SM.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W, device ms, old
// body / this one in one call, B = 4096): rows 15, 14, 12 at 0.661 / 0.246,
// 0.688-0.707 / 0.243-0.245 and 0.662 / 0.256, under torch.matmul's conv2
// alone (0.258); B = 2048 0.132-0.134, B = 16384 0.948-0.993. What sets the
// pace (scripts/conv_bf16_modes.py: copies with parts taken out, row 15, B
// = 4096, CUDA events): the whole body 0.251-0.257; conv2's products alone
// 0.157, 1.2x the bound (by the shapes, at the full tensor rate the two
// warpgroups' wgmma operands would read ~112 of the 128 bytes a cycle
// shared memory gives); conv1's producers alone 0.104-0.108; both without
// the pair sum and epilogue 0.221, with or without waits between them (on
// the same SM conv1's instructions slow the tensor cores by ~0.6 of their
// own time, as in row 1); the epilogue ~0.03 more; the pair's handshake
// within the noise (without it 0.255). Holding a frame's 16 windows in
// registers, or loading 16 rows' at once, changed nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv2_wgmma.cuh"

namespace {

// How conv1's input arrives (the kernel's template parameter).
constexpr int IN_FRAME_BF16 = 0;          // v4: f32 frames, rounded to bf16 here
constexpr int IN_TAP_ROWS = 1;            // v2: bf16 tap rows, the bias on lane 6
constexpr int IN_FRAME_F32 = 2;           // bf16: f32 frames and f32 conv1 weights

constexpr int T = 128;                    // frame length
constexpr int T1 = T - 2;                 // conv1 rows
constexpr int T2 = T - 4;                 // conv2 rows
constexpr int C1 = 256;                   // conv1 channels per I/Q plane: a block's K
constexpr int K1 = 2 * C1;                // stacked conv1 channels, h*C1 + c
constexpr int C2 = 80;                    // conv2 channels
constexpr int NB = 3 * C2;                // resident weight columns, k*C2 + co
constexpr int CH = WG_CHUNK / 2;          // bf16 channels per chunk
constexpr int CHUNKS = C1 / CH;           // K chunks (ring stages) per plane
constexpr int STAGES = CHUNKS;            // stage c holds chunk c
constexpr int PRODUCERS = 8;              // producer warps; warp p owns rows p + 8q
constexpr int ROWS = (T1 + PRODUCERS - 1) / PRODUCERS;   // rows per warp and stage
constexpr int GROUP = 8;                  // rows whose windows a producer loads at once
constexpr int THREADS = WG_CONSUMERS + 32 * PRODUCERS;
constexpr int RING_BYTES = STAGES * WG_STAGE;
constexpr int W_BYTES = 2 * C1 / 64 * NB * 64;   // 8 K tiles of 64 bytes
constexpr int PART_FLOATS = 64 * C2;             // a warpgroup's partial, f32
constexpr int RECV_BYTES = PART_FLOATS * 4;
constexpr int TILE_BYTES = 64 * C2 * 2;          // a warpgroup's 64 rows of the map
constexpr int WIN_ROWS = 128;
constexpr int WIN_BYTES = 2 * WIN_ROWS * 16;     // two frames' windows, float4 a row
constexpr int OFF_W = RING_BYTES;
constexpr int OFF_RECV = OFF_W + W_BYTES;
constexpr int OFF_TILE = OFF_RECV + RECV_BYTES;
constexpr int OFF_WIN = OFF_TILE + TILE_BYTES;
constexpr int OFF_BAR = OFF_WIN + WIN_BYTES;
constexpr int SMEM_BYTES = 1024 + OFF_BAR + (2 * STAGES + 2) * 8;
static_assert(PRODUCERS == 8, "a warp's rows share their swizzle phase (t & 7)");
static_assert(C1 % CH == 0 && PRODUCERS * ROWS <= WIN_ROWS, "chunks and windows");
static_assert(ROWS % GROUP == 0, "whole groups of rows");
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(2 * SMEM_BYTES > 228 * 1024, "one block per SM");

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// bf16_rn(relu(hi)) in the upper half, bf16_rn(relu(lo)) in the lower.
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// conv1 of one channel before ReLU, from its window (x0, x1, x2, x3) and
// constants (w0, w1, w2, w3), in the plain versions' order.
template <int IN>
__device__ __forceinline__ float conv1(float4 x, float4 w) {
  if constexpr (IN == IN_FRAME_F32) {
    float acc = __fmul_rn(x.x, w.x);
    acc = __fadd_rn(acc, __fmul_rn(x.y, w.y));
    acc = __fadd_rn(acc, __fmul_rn(x.z, w.z));
    return __fadd_rn(acc, w.w);
  } else {   // exact products of bf16 values: each FMA rounds as one add
    float acc = __fmul_rn(x.x, w.x);
    acc = __fmaf_rn(x.y, w.y, acc);
    acc = __fmaf_rn(x.z, w.z, acc);
    return __fmaf_rn(x.w, w.w, acc);   // x.w = 1 (v4) or the tap row's lane 6 (v2)
  }
}

__device__ __forceinline__ uint32_t map_peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into the peer block's shared memory (shared::cluster address),
// counted as complete_tx bytes on the peer's mbarrier bar when they land.
__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t bar, float a, float b, float c,
                                        float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
         "r"(__float_as_uint(d)), "r"(bar) : "memory");
}

// Arrive on an mbarrier of the peer block (a shared::cluster address).
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait on a local mbarrier that the peer completes (acquire at cluster
// scope: st.async's complete_tx releases at cluster scope).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_CL:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_CL;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// The frame's input for the window of row pt, loaded one frame ahead.
template <int IN>
struct Input {
  float x[3];
  uint4 row;

  __device__ __forceinline__ void load(const void* in, long long f, int h, int pt) {
    if constexpr (IN == IN_TAP_ROWS) {
      row = __ldg(static_cast<const uint4*>(in) + f * T1 + pt);
    } else {
      const float* xp = static_cast<const float*>(in) + (f * 2 + h) * T + pt;
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = __ldg(xp + k);
    }
  }

  __device__ __forceinline__ float4 window(int h) const {
    if constexpr (IN == IN_TAP_ROWS) {
      const uint32_t w[4] = {row.x, row.y, row.z, row.w};
      return h == 0 ? make_float4(bf16_lo(w[0]), bf16_hi(w[0]), bf16_lo(w[1]), bf16_lo(w[3]))
                    : make_float4(bf16_hi(w[1]), bf16_lo(w[2]), bf16_hi(w[2]), bf16_lo(w[3]));
    } else if constexpr (IN == IN_FRAME_BF16) {
      return make_float4(__bfloat162float(__float2bfloat16_rn(x[0])),
                         __bfloat162float(__float2bfloat16_rn(x[1])),
                         __bfloat162float(__float2bfloat16_rn(x[2])), 1.0f);
    } else {
      return make_float4(x[0], x[1], x[2], 1.0f);
    }
  }
};

// Producer warp p (of PRODUCERS), thread pt of the producers: plane h's
// conv1 + ReLU + bf16, rows t = p + 8q of every chunk of every frame the
// cluster walks.
template <int IN>
__device__ __forceinline__ void produce(const void* __restrict__ in, long long n,
                                        const void* __restrict__ w1,
                                        const float* __restrict__ b1d, uint8_t* sm,
                                        uint32_t full, uint32_t empty, int h, int p, int lane,
                                        long long f, long long step) {
  const int pt = 32 * p + lane;
  // Channel n = h*C1 + c*CH + 2*lane + e of chunk c: its taps and bias.
  float4 w[CHUNKS][2];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = c * CH + 2 * lane + e, nn = h * C1 + cc;
      if constexpr (IN == IN_FRAME_F32) {
        const float* w1p = static_cast<const float*>(w1);
        w[c][e] = make_float4(__ldg(w1p + cc), __ldg(w1p + C1 + cc), __ldg(w1p + 2 * C1 + cc),
                              __ldg(b1d + nn));
      } else {
        const __nv_bfloat16* w1e = static_cast<const __nv_bfloat16*>(w1);
        w[c][e] = make_float4(__bfloat162float(w1e[(3 * h) * K1 + nn]),
                              __bfloat162float(w1e[(3 * h + 1) * K1 + nn]),
                              __bfloat162float(w1e[(3 * h + 2) * K1 + nn]),
                              __bfloat162float(w1e[6 * K1 + nn]));
      }
    }
  // Rows T1..129 of every stage feed only the dropped output rows: zeros,
  // fenced with the first chunk's rows.
  for (int i = pt; i < STAGES * (WG_ROWS - T1) * (WG_CHUNK / 4); i += 32 * PRODUCERS) {
    const int s = i / ((WG_ROWS - T1) * (WG_CHUNK / 4)), r = i % ((WG_ROWS - T1) * (WG_CHUNK / 4));
    reinterpret_cast<uint32_t*>(sm + s * WG_STAGE + T1 * WG_CHUNK)[r] = 0u;
  }
  // Row t = p + 8q: segment s = lane / 4 sits at s ^ (t & 7) = s ^ p.
  const int col = (((lane >> 2) ^ p) << 4) + 4 * (lane & 3);
  uint8_t* rows = sm + p * WG_CHUNK + col;
  float4* win = reinterpret_cast<float4*>(sm + OFF_WIN);

  Input<IN> next;
  if (f < n && pt < T1) next.load(in, f, h, pt);
  for (int it = 0; f < n; f += step, ++it) {
    float4* __restrict__ wb = win + (it & 1) * WIN_ROWS;
    if (pt < T1) wb[pt] = next.window(h);
    asm volatile("bar.sync 3, %0;\n" :: "n"(32 * PRODUCERS) : "memory");
    if (f + step < n && pt < T1) next.load(in, f + step, h, pt);   // in flight meanwhile
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      mbar_wait(empty + 8 * c, (it & 1) ^ 1);
      uint8_t* __restrict__ st = rows + c * WG_STAGE;
#pragma unroll
      for (int q0 = 0; q0 < ROWS; q0 += GROUP) {
        float4 x[GROUP];   // broadcasts, all in flight before the first store
#pragma unroll
        for (int u = 0; u < GROUP; ++u) x[u] = wb[p + PRODUCERS * (q0 + u)];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int q = q0 + u;
          if (q < ROWS - 1 || p + PRODUCERS * q < T1)   // warp-uniform
            *reinterpret_cast<uint32_t*>(st + PRODUCERS * WG_CHUNK * q) =
                relu_bf16x2(conv1<IN>(x[u], w[c][0]), conv1<IN>(x[u], w[c][1]));
        }
      }
      fence_proxy_async();   // these st.shared before wgmma's reads (async proxy)
      mbar_arrive(full + 8 * c);
    }
  }
}

// in: frames (B, 2, 128) f32 or tap rows (B, 126, 8) bf16, by IN. w1: w1e
// (8, 512) bf16, or w1p (3, 256) f32 with b1d (512,) f32, conv1's bias
// duplicated over the planes, for IN_FRAME_F32 (b1d unused otherwise).
// Launched as clusters of 2 blocks (cluster rank = I/Q plane).
template <int IN>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_bf16_kernel(const void* __restrict__ in, long long n,
                       const void* __restrict__ w1, const float* __restrict__ b1d,
                       const __nv_bfloat16* __restrict__ w2t,
                       const float* __restrict__ b2,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t ws = base + OFF_W, recv = base + OFF_RECV, tile = base + OFF_TILE;
  const uint32_t full = base + OFF_BAR, empty = full + 8 * STAGES;
  const uint32_t recv_full = empty + 8 * STAGES, recv_empty = recv_full + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int h = static_cast<int>(cluster.block_rank());   // this block's I/Q plane
  const long long f0 = blockIdx.x / 2, step = gridDim.x / 2;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32 * PRODUCERS);
      mbar_init(empty + 8 * s, WG_CONSUMERS / 32);
    }
    mbar_init(recv_full, 1);    // the finisher's expect_tx, then the peer's 20 KB
    mbar_init(recv_empty, 1);   // the peer's finisher: its buffer is read
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // both blocks' barriers exist before either arrives remotely

  if (warp >= WG_CONSUMERS / 32) {
    produce<IN>(in, n, w1, b1d, sm, full, empty, h, warp - WG_CONSUMERS / 32, lane, f0, step);
  } else {
    // The weight once, plane h's half of every w2t row, while the
    // producers build the first stages.
    const uint4* w2v = reinterpret_cast<const uint4*>(w2t);
    for (int i = tid; i < NB * (C1 / 8); i += WG_CONSUMERS) {
      const int col = i / (C1 / 8), s = i % (C1 / 8);
      *reinterpret_cast<uint4*>(sm + OFF_W + w_resident_offset<NB>(col, 16 * s)) =
          __ldg(w2v + col * (K1 / 8) + h * (C1 / 8) + s);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");

    // Warpgroup g owns rows 64g .. 64g + 63 (warp w of it rows 16(w%4) ..
    // +15); warpgroup h finishes them (64 or 60 below T2), the other sends
    // its partial to the peer, which finishes its rows.
    const int wg = warp / 4, tw = tid % 128, tq = lane & 3;
    const bool finisher = wg == h, issuer = finisher && tw == 0;
    const int rows = h ? T2 - 64 : 64, r_lo = (warp % 4) * 16 + (lane >> 2);
    const uint32_t peer = static_cast<uint32_t>(h ^ 1);
    const uint32_t peer_recv = map_peer(recv, peer) + 16 * tw;
    const uint32_t peer_recv_full = map_peer(recv_full, peer);
    const uint32_t peer_recv_empty = map_peer(recv_empty, peer);
    float bias[C2 / 8][2];
#pragma unroll
    for (int j = 0; j < C2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bias[j][e] = __ldg(b2 + 8 * j + 2 * tq + e);
    int it = 0;
    for (long long f = f0; f < n; f += step, ++it) {
      float acc[C2 / 2];
#pragma unroll
      for (int i = 0; i < C2 / 2; ++i) acc[i] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < CHUNKS; ++c) {
        mbar_wait(full + 8 * c, it & 1);
        __syncwarp();                  // converged again for the .aligned products
        stage_products<C2>(acc, base + c * WG_STAGE + wg * 64 * WG_CHUNK,
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
      if (!finisher) {
        mbar_wait_cluster(recv_empty, (it & 1) ^ 1);   // the peer has read the last one
#pragma unroll
        for (int i = 0; i < C2 / 8; ++i)
          st_peer(peer_recv + i * (128 * 16), peer_recv_full, acc[4 * i], acc[4 * i + 1],
                  acc[4 * i + 2], acc[4 * i + 3]);
        continue;
      }
      if (issuer) mbar_expect_tx(recv_full, RECV_BYTES);
      mbar_wait_cluster(recv_full, it & 1);
      const float4* part = reinterpret_cast<const float4*>(sm + OFF_RECV) + tw;
#pragma unroll
      for (int i = 0; i < C2 / 8; ++i) {
        const float4 v = part[i * 128];
        acc[4 * i] = __fadd_rn(acc[4 * i], v.x);
        acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], v.y);
        acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], v.z);
        acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], v.w);
      }
      // The last frame's copy has read the tile before anyone rewrites it.
      if (issuer) bulk_wait_read<0>();
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      // Every thread has read the buffer: the peer may refill it.
      if (issuer) mbar_arrive_peer(peer_recv_empty);
      uint8_t* tl = sm + OFF_TILE;
#pragma unroll
      for (int j = 0; j < C2 / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r_lo + 8 * half;
          if (row < rows)
            *reinterpret_cast<uint32_t*>(tl + (row * C2 + 8 * j + 2 * tq) * 2) =
                relu_bf16x2(__fadd_rn(acc[4 * j + 2 * half], bias[j][0]),
                            __fadd_rn(acc[4 * j + 2 * half + 1], bias[j][1]));
        }
      fence_proxy_async();             // the tile's st.shared before the bulk copy reads it
      asm volatile("bar.sync 2, 128;\n" ::: "memory");
      if (issuer) {
        bulk_store(out + (f * T2 + 64 * h) * C2, tile, rows * C2 * 2);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait<0>();        // the last copy lands before the block ends
  }
  cluster.sync();   // no block leaves while its peer may still reach its shared memory
}

template <int IN>
int launch(const void* in, long long n, const void* w1, const void* b1, const void* w2t,
           const void* b2, void* out, void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(w2t) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // 16-byte loads, bulk copies
  auto kernel = conv_stage_bf16_kernel<IN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int fit = 0;   // clusters of 2 the card holds at once
  if (fit == 0) {
    if ((err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg)) != cudaSuccess)
      return static_cast<int>(err);
    if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cfg.gridDim = dim3(static_cast<unsigned>(2 * (n < fit ? n : fit)));
  err = cudaLaunchKernelEx(&cfg, kernel, in, n, w1, static_cast<const float*>(b1),
                           static_cast<const __nv_bfloat16*>(w2t),
                           static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int amc_conv_stage_bf16_v4(const void* x, long long n, const void* w1e,
                                      const void* w2t, const void* b2, void* out,
                                      void* stream) {
  return launch<IN_FRAME_BF16>(x, n, w1e, nullptr, w2t, b2, out, stream);
}

extern "C" int amc_conv_stage_bf16_v2(const void* xe, long long n, const void* w1e,
                                      const void* w2t, const void* b2, void* out,
                                      void* stream) {
  return launch<IN_TAP_ROWS>(xe, n, w1e, nullptr, w2t, b2, out, stream);
}

extern "C" int amc_conv_stage_bf16(const void* x, long long n, const void* w1p,
                                   const void* b1, const void* w2t, const void* b2,
                                   void* out, void* stream) {
  return launch<IN_FRAME_F32>(x, n, w1p, b1, w2t, b2, out, stream);
}
