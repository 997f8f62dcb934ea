// Fused int8 conv stage on tap rows with the integer conv1 (v3 and v2),
// for Hopper (sm_90a). One kernel body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v3_kernel
//   (ops/infer.py:600, reached by pl.pallas_call in make_int8_classifier_v3,
//   ops/infer.py:697) with amc_conv_stage_int8_v3, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v2_kernel
//   (ops/infer.py:459, make_int8_forward_v2, ops/infer.py:515) with
//   amc_conv_stage_int8_v2. The two TPU kernels compute one function and
//   differed in layout (v3 wrote (B, 126, 128) with garbage rows and lanes
//   nulled by zero rows of the padded dense1 weight, v2 the compact map)
//   and in how they overlapped their loads; both entries here write the
//   compact (B, 124, 80) map that every dense stage reads and launch the
//   one kernel below, whose producers load the next frame's rows while
//   this frame's products run (what v3's prefetch did).
//
// Computes, per frame of xe (B, 126, 8) int8 tap rows (ops/infer.py's
// expand_taps, the JAX package's quantize + expand_taps, which both
// packages run outside the kernel; lane 3h+k of row t is xq[h, t+k], lanes
// 6 and 7 zero):
//   a1[t, n] = clip((sum_j xe[t, j] * w1e[j, n] + o1[n]) >> m1[n], 0, 127)
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2l[j, k*80 + co]          t < 124
//   out  = clip((s + o2) >> m2, 0, 127)                        (124, 80) int8
// v7's function from the rows, with no bf16 fold. The kernel uses lanes
// 0..5 of each row and each plane's own block of w1e (rows 3h..3h+2,
// columns h*256 ..): lanes 6 and 7 meet w1e's zero rows 6 and 7, and the
// other plane's block is zero (quant.py::expand_conv1_weights; held on
// every model the port builds by tests/test_torch_v6_rows.py). So the map
// equals the plain version's on any rows (tests/test_torch_v3_rows.py).
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (the rows 4.1 MB in, the
// map 40.6 MB out; ~13.4 us at 3.35 TB/s): operation-bound, ~64 us.
//
// Design: rows 6 and 7's (conv_stage_int8_v6.cu), from rows in place of
// planes. One persistent block of 512 threads per SM walks frames f =
// blockIdx.x, + gridDim.x, ... . 8 producer warps build conv1 + rq1 into a
// 4-stage ring in shared memory with conv1_producer_s8.cuh's produce under
// its RowsIn policy: warp p's lane l loads the one row 4l + p % 4 whose
// windows its warp needs, 8 bytes by one ld.global.nc one frame ahead
// (rows 126 and 127 of lane 31 load as zero: they do not exist), and takes
// plane 0's window as the row's first word and plane 1's by one funnel
// shift of its two words; from there the producer is rows 5, 6, 7 and
// 10's: a shuffle of the window, a __dp4a per channel against each plane's
// taps from its own block of w1e with o1 as its addend, the shift, rq1's
// clamp on int16 pairs, one 4-byte st.shared per 4 outputs into the
// 128-byte swizzle, fenced against the async proxy before the stage's
// `full` mbarrier. The two consumer warpgroups are conv2_wgmma.cuh's
// consume_ring_s8, as in rows 1 and 3 to 7 and 10: wgmma m64n80k32 s8 with
// the weight resident (3 taps x 80 channels x 512, 122,880 bytes, staged
// from w2l by stage_w2p_resident's transpose), A a ring stage moved down k
// rows for tap k, rq2 into a tile in shared memory and one bulk copy per
// warpgroup and frame. Shared memory: row 1's, 1 KB of alignment, 68 KB of
// ring, 120 KB of weight, 20 KB of tiles; one block per SM. What sets the
// pace is row 1's: the producers and conv2's tensor cores on the same SMs
// cost about their sum.
//
// Measured (scripts/probe.py conv_v3_old and chip_smoke.py, NVIDIA H100
// 80GB HBM3 at 700.00 W, PERF.md): 115 registers, 0 spills; B=4096
// 0.133-0.135 ms device against the earlier body's 0.367-0.386 (one frame
// at a time per block, conv1 and conv2 on mma.sync), lane-packed
// _int_mm's conv2 0.325 and row 6's 0.138 in the same call; B=2048 0.068-
// 0.073, B=16384 0.487-0.498.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv1_producer_s8.cuh"

namespace {

static_assert(T1 * 8 % 16 == 0, "a frame's rows start 16-byte aligned");

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_v3_kernel(const int8_t* __restrict__ xe, long long n,
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
    const int p = warp - WG_CONSUMERS / 32;
    produce<2>(RowsIn{xe, p & 3}, n, w1e, m1, o1, smem_raw + (base - raw), full, empty, p,
               lane);
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

extern "C" int amc_conv_stage_int8_v3(const void* xe, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch_ring(conv_stage_int8_v3_kernel, xe, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}

extern "C" int amc_conv_stage_int8_v2(const void* xe, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch_ring(conv_stage_int8_v3_kernel, xe, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}
