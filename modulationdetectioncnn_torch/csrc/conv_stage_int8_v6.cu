// Fused int8 conv stage on tap planes, conv1 and conv2 on the int8 tensor
// cores, for Hopper (sm_90a). One templated body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v6_kernel
//   (ops/infer.py:906, reached by pl.pallas_call in make_int8_classifier_v6,
//   ops/infer.py:983) with amc_conv_stage_int8_v6, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v4_kernel
//   (ops/infer.py:780, make_int8_classifier_v4, ops/infer.py:852) with
//   amc_conv_stage_int8_v4.
//
// Computes, per frame of xp (B, 8, 128) int8 tap planes (ops/infer.py's
// tap_planes, the JAX package's quantize + expand_tap_planes, which both
// packages run outside the kernel):
//   a1[t, n] = clip((sum_j xp[j, t] * w1e[j, n] + o1[n]) >> m1[n], 0, 127)
//   then conv2 and rq2 as in conv_stage_int8_mma.cuh -> (124, 80) int8
// the v7 function from the planes, with no bf16 fold.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (~13.4 us at 3.35 TB/s):
// operation-bound, ~64 us.
//
// Design (simple and right first): the tap-plane body of
// conv_stage_int8_mma.cuh, which v5 ran until it took row 1's design (a
// persistent block of 8 warps per SM, conv2's weight resident in shared
// memory, conv1 as one int8 mma.sync.m16n8k16 per 8 columns with the 8
// planes on K, exact integer rq1), reading each frame's 1 KB of planes. The
// TPU's v6 software-pipelined its chunk loop one chunk deep (the next
// chunk's conv1 dot issued beside this chunk's requantize); here v6
// (PREFETCH) copies the next frame's planes into a second buffer with
// cp.async while the current frame's products run. v4 loads each frame in
// turn; the two compute the same map.
#include "conv_stage_int8_mma.cuh"

namespace {

constexpr int SMEM_BYTES =
    W2S_BYTES + A1S_BYTES + W1S_BYTES + Q1S_BYTES + 2 * PLANES_BYTES;
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(PLANES_BYTES == 4 * THREADS, "one word of planes per thread");

template <bool PREFETCH>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_planes_kernel(const int8_t* __restrict__ xp, long long n,
                              const int8_t* __restrict__ w1e,
                              const int* __restrict__ m1,
                              const int* __restrict__ o1,
                              const int8_t* __restrict__ w2l,
                              const int* __restrict__ m2,
                              const int* __restrict__ o2,
                              int8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w2s = reinterpret_cast<int8_t*>(smem);
  int8_t* a1s = reinterpret_cast<int8_t*>(smem + W2S_BYTES);
  uint32_t* w1s = reinterpret_cast<uint32_t*>(smem + W2S_BYTES + A1S_BYTES);
  int* q1s = reinterpret_cast<int*>(smem + W2S_BYTES + A1S_BYTES + W1S_BYTES);
  int8_t* ps = reinterpret_cast<int8_t*>(smem + W2S_BYTES + A1S_BYTES +
                                         W1S_BYTES + Q1S_BYTES);
  const int tid = threadIdx.x;

  stage_conv2(w2l, w2s, a1s);
  stage_conv1_int8(w1e, m1, o1, w1s, q1s);
  const Rq2 rq = load_rq2(m2, o2);

  long long f = blockIdx.x;
  int buf = 0;
  constexpr int CHUNKS = PLANES_BYTES / 16;  // 16-byte copies per frame
  if (PREFETCH) {
    if (f < n && tid < CHUNKS)
      cp_async16(ps + 16 * tid, xp + f * PLANES_BYTES + 16 * tid);
    cp_async_commit();
  }
  __syncthreads();

  for (; f < n; f += gridDim.x) {
    int8_t* P = ps + buf * PLANES_BYTES;
    if (PREFETCH) {
      // Start the next frame's copy into the other buffer, then wait for
      // this frame's (the older group).
      const long long fn = f + gridDim.x;
      if (fn < n && tid < CHUNKS)
        cp_async16(ps + (buf ^ 1) * PLANES_BYTES + 16 * tid,
                   xp + fn * PLANES_BYTES + 16 * tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      reinterpret_cast<uint32_t*>(P)[tid] =
          reinterpret_cast<const uint32_t*>(xp + f * PLANES_BYTES)[tid];
    }
    __syncthreads();
    conv1_planes(P, w1s, q1s, a1s);
    __syncthreads();
    conv2_rq2_store(a1s, w2s, rq, f, out);
    if (PREFETCH) buf ^= 1;
    // The buffer the next iteration refills was last read by this frame's
    // conv1, before the second __syncthreads above; a1s is rewritten only
    // after the next frame's first __syncthreads.
  }
  if (PREFETCH) cp_async_wait<0>();
}

template <bool PREFETCH>
int launch(const void* xp, long long n, const void* w1e, const void* m1,
           const void* o1, const void* w2l, const void* m2, const void* o2,
           void* out, void* stream) {
  return launch_persistent(
      conv_stage_int8_planes_kernel<PREFETCH>, SMEM_BYTES, n, stream,
      static_cast<const int8_t*>(xp), n, static_cast<const int8_t*>(w1e),
      static_cast<const int*>(m1), static_cast<const int*>(o1),
      static_cast<const int8_t*>(w2l), static_cast<const int*>(m2),
      static_cast<const int*>(o2), static_cast<int8_t*>(out));
}

}  // namespace

extern "C" int amc_conv_stage_int8_v6(const void* xp, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch<true>(xp, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}

extern "C" int amc_conv_stage_int8_v4(const void* xp, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch<false>(xp, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}
