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
// producer warps build it, chunk by chunk, into a ring of 4 stages, one
// 128-byte K chunk of 128 channels of one I/Q plane a stage, in the
// 128-byte swizzle wgmma reads: conv1_producer_s8.cuh's produce (quantize,
// a __dp4a per channel, rq1 on int16 pairs, one 4-byte st.shared per 4
// outputs, fenced against the async proxy before the stage's `full`
// mbarrier), which rows 5 and 10 (conv_stage_int8_v5.cu) share, reading
// their taps from w1e. The consumers release a stage on `empty` once the
// products that read it are done, one product group left in flight. The
// epilogue writes each warpgroup's rows into a tile in shared memory (two
// per warpgroup, by frame parity) and its first thread copies the tile out
// with one bulk copy (the rows are contiguous in the map) instead of 4-byte
// stores scattered over 16 rows. That consumer role is conv2_wgmma.cuh's
// consume_ring_s8, which conv_stage_int8_v10.cu (rows 3 and 4, conv1 on
// the tensor cores) and conv_stage_int8_v5.cu share. Shared memory: 1 KB
// of alignment, 68 KB of ring, 120 KB of weight, 20 KB of tiles; one
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

#include "conv1_producer_s8.cuh"

namespace {

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
    produce<1>(FramesIn{x, inv_sx}, n, w1, m1, o1, smem_raw + (base - raw), full, empty,
               warp - WG_CONSUMERS / 32, lane);
    return;
  }

  // The consumers: the weight once, while the producers build the first
  // stages.
  stage_w2t_resident<C2, K1>(w2t, smem_raw + (ws - raw));
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS) : "memory");

  consume_ring_s8<C2, T2, CHUNKS>(m2, o2, out, n, smem_raw, base, ws, tiles, full, empty);
}

}  // namespace

extern "C" int amc_conv_stage_int8_v7(const void* x, long long n,
                                      const void* w1, const void* m1,
                                      const void* o1, const void* w2t,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch_ring(conv_stage_int8_v7_kernel, x, n, w1, m1, o1, w2t, m2, o2, inv_sx, out,
                     stream);
}

extern "C" const char* amc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
