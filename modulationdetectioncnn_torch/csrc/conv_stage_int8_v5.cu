// Fused int8 conv stage from f32 frames with the integer conv1 (v5 and v1),
// for Hopper (sm_90a). One kernel body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v5_kernel
//   (ops/infer.py:1515, reached by pl.pallas_call in make_int8_classifier_v5,
//   ops/infer.py:1592) with amc_conv_stage_int8_v5, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_kernel
//   (ops/infer.py:317, the v1 conv stage of make_int8_forward, pl.pallas_call
//   at ops/infer.py:386) with amc_conv_stage_int8_v1. The two TPU kernels
//   compute one function (f32 frames in, quantize, conv1, rq1, conv2 with
//   N = 3*80, shift-add, rq2) and differed only in how Mosaic scheduled
//   conv1 (v1 a broadcast multiply-add on the VPU, v5 three K = 8 dots), so
//   both entry points launch the one kernel below.
//
// Computes, per frame of x (B, 2, 128) f32, v7's function (golden/quant.py's
// integer spec, with no bf16 fold, so a model that quant.fold_conv1_weights
// refuses runs here too):
//   xq   = clip(round_half_even(x * inv_sx), -127, 127)                int8
//   a1[t, h*256+c] = clip((sum_k xq[h, t+k] * w1e[3h+k, h*256+c] + o1) >> m1,
//                         0, 127)                              (126, 512)
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2l[j, k*80 + co]          t < 124
//   out  = clip((s + o2) >> m2, 0, 127)                        (124, 80) int8
// from the tap-plane conv1 w1e (8, 512) and the taps-on-N conv2 w2l
// (512, 240) that the TPU kernels' layouts reduce to.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (x 4.2 MB in, the map
// 40.6 MB out; ~13.4 us at 3.35 TB/s): operation-bound, ~64 us.
//
// Design: row 1's (conv_stage_int8.cu), under v5's and v1's arguments. One
// persistent block of 512 threads per SM walks frames f = blockIdx.x,
// + gridDim.x, ... . 8 producer warps build conv1 + rq1 into a 4-stage
// ring in shared memory with conv1_producer_s8.cuh's produce, row 1's
// producer, reading each plane's taps from its own block of w1e (16
// registers of packed taps where row 1 keeps 8): the quantize of 4 samples
// of each plane a lane (float4 loads one frame ahead), a __dp4a per
// channel with o1 as its addend, the shift, rq1's clamp on int16 pairs,
// one 4-byte st.shared per 4 outputs into the 128-byte swizzle, fenced
// against the async proxy before the stage's `full` mbarrier. The two
// consumer warpgroups are conv2_wgmma.cuh's consume_ring_s8, as in rows 1,
// 3 and 4: wgmma m64n80k32 s8 with the weight resident (3 taps x 80
// channels x 512, 122,880 bytes, staged from w2l by stage_w2p_resident's
// transpose, as row 3 stages it), A a ring stage moved down k rows for tap
// k, rq2 into a tile in shared memory and one bulk copy per warpgroup and
// frame. Shared memory: row 1's, 1 KB of alignment, 68 KB of ring, 120 KB
// of weight, 20 KB of tiles; one block per SM. What sets the pace is row
// 1's (conv_stage_int8.cu): the producers and conv2's tensor cores on the
// same SMs cost about their sum.
//
// Measured (scripts/conv_int8_modes.py check, H100 SXM at 700 W, PERF.md):
// 124 registers, 0 spills; B=4096 0.136-0.137 ms device against the
// earlier body's 0.38-0.46 (one frame at a time, conv1 and conv2 on
// mma.sync), lane-packed _int_mm's conv2 0.307 and row 1's 0.142 in the
// same call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv1_producer_s8.cuh"

namespace {

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_v5_kernel(const float* __restrict__ x, long long n,
                          const int8_t* __restrict__ w1e,
                          const int* __restrict__ m1,
                          const int* __restrict__ o1,
                          const int8_t* __restrict__ w2l,
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
    produce<2>(x, n, w1e, m1, o1, inv_sx, smem_raw + (base - raw), full, empty,
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

extern "C" int amc_conv_stage_int8_v5(const void* x, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch_ring(conv_stage_int8_v5_kernel, x, n, w1e, m1, o1, w2l, m2, o2, inv_sx, out,
                     stream);
}

extern "C" int amc_conv_stage_int8_v1(const void* x, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch_ring(conv_stage_int8_v5_kernel, x, n, w1e, m1, o1, w2l, m2, o2, inv_sx, out,
                     stream);
}
