// Fused int8 conv stage on tap planes with the integer conv1 (v6 and v4),
// for Hopper (sm_90a). One kernel body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v6_kernel
//   (ops/infer.py:906, reached by pl.pallas_call in make_int8_classifier_v6,
//   ops/infer.py:983) with amc_conv_stage_int8_v6, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v4_kernel
//   (ops/infer.py:780, make_int8_classifier_v4, ops/infer.py:852) with
//   amc_conv_stage_int8_v4. The two TPU kernels compute one function ("Math
//   is IDENTICAL to v4", ops/infer.py:894-905) and differed only in how
//   Mosaic scheduled the chunk loop (v6 issued the next chunk's conv1 dot
//   beside this chunk's requantize), so both entry points launch the one
//   kernel below, whose ring overlaps the next frame's load with this
//   frame's products for both.
//
// Computes, per frame of xp (B, 8, 128) int8 tap planes (ops/infer.py's
// tap_planes, the JAX package's quantize + expand_tap_planes, which both
// packages run outside the kernel):
//   a1[t, n] = clip((sum_j xp[j, t] * w1e[j, n] + o1[n]) >> m1[n], 0, 127)
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2l[j, k*80 + co]          t < 124
//   out  = clip((s + o2) >> m2, 0, 127)                        (124, 80) int8
// the TPU's v4 (one K = 8 dot of the transposed planes against w1e), which
// is v7's function from the planes, with no bf16 fold. The kernel uses
// planes 0..5 at columns 0..125 and each plane's own block of w1e (rows
// 3h..3h+2, columns h*256 ..): planes 6 and 7 meet w1e's zero rows 6 and 7,
// the other plane's block is zero (quant.py::expand_conv1_weights; held on
// every model the port builds by tests/test_torch_v6_rows.py), and columns
// 126 and 127 feed only conv1 rows 126 and 127, which feed no stored
// output. So the map equals the plain version's on any planes.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (the planes 4.2 MB in,
// the map 40.6 MB out; ~13.4 us at 3.35 TB/s): operation-bound, ~64 us.
//
// Design: row 1's (conv_stage_int8.cu) and rows 5 and 10's
// (conv_stage_int8_v5.cu), from planes in place of frames. One persistent
// block of 512 threads per SM walks frames f = blockIdx.x, + gridDim.x,
// ... . 8 producer warps build conv1 + rq1 into a 4-stage ring in shared
// memory with conv1_producer_s8.cuh's produce under its PlanesIn policy:
// each lane loads one 4-byte word of columns 4l..4l+3 of each of planes
// 0..5 one frame ahead (six words, 768 bytes a warp, where the frames
// policy loads two float4s and quantizes them), two byte permutes per I/Q
// plane make the (xp[3h][t], xp[3h+1][t], xp[3h+2][t], .) window of its
// byte, and from there the producer is rows 5 and 10's: a shuffle of the
// window, a __dp4a per channel against each plane's taps from its own
// block of w1e (16 registers of packed taps) with o1 as its addend, the
// shift, rq1's clamp on int16 pairs, one 4-byte st.shared per 4 outputs
// into the 128-byte swizzle, fenced against the async proxy before the
// stage's `full` mbarrier. The two consumer warpgroups are conv2_wgmma.cuh's
// consume_ring_s8, as in rows 1, 3, 4, 5 and 10: wgmma m64n80k32 s8 with
// the weight resident (3 taps x 80 channels x 512, 122,880 bytes, staged
// from w2l by stage_w2p_resident's transpose), A a ring stage moved down k
// rows for tap k, rq2 into a tile in shared memory and one bulk copy per
// warpgroup and frame. Shared memory: row 1's, 1 KB of alignment, 68 KB of
// ring, 120 KB of weight, 20 KB of tiles; one block per SM. What sets the
// pace is row 1's: the producers and conv2's tensor cores on the same SMs
// cost about their sum.
//
// Measured (scripts/conv_int8_modes.py check and chip_smoke.py, NVIDIA H100
// 80GB HBM3 at 700.00 W, PERF.md): 121 registers, 0 spills; B=4096
// 0.135-0.137 ms device against the earlier body's 0.372-0.388 (one frame
// at a time on conv_stage_int8_mma.cuh, conv1 and conv2 on mma.sync),
// lane-packed _int_mm's conv2 0.326 and row 5's 0.138 in the same call;
// B=2048 0.073, B=16384 0.494-0.495.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv1_producer_s8.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_v6_kernel(const int8_t* __restrict__ xp, long long n,
                          const int8_t* __restrict__ w1e,
                          const int* __restrict__ m1,
                          const int* __restrict__ o1,
                          const int8_t* __restrict__ w2l,
                          const int* __restrict__ m2,
                          const int* __restrict__ o2,
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
    produce<2>(PlanesIn{xp}, n, w1e, m1, o1, smem_raw + (base - raw), full, empty,
               warp - WG_CONSUMERS / 32, lane);
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

}  // namespace

extern "C" int amc_conv_stage_int8_v6(const void* xp, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch_ring(conv_stage_int8_v6_kernel, xp, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}

extern "C" int amc_conv_stage_int8_v4(const void* xp, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch_ring(conv_stage_int8_v6_kernel, xp, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}
