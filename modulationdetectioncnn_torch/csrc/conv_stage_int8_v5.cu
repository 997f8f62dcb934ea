// Fused int8 conv stage with the quantize and the tap planes inside, conv1
// and conv2 on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v5_kernel
//   (ops/infer.py:1515, reached by pl.pallas_call in make_int8_classifier_v5,
//   ops/infer.py:1592) with amc_conv_stage_int8_v5, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_kernel
//   (ops/infer.py:317, the v1 conv stage of make_int8_forward, pl.pallas_call
//   at ops/infer.py:386) with amc_conv_stage_int8_v1. The two TPU kernels
//   compute one function (f32 frames in, quantize, conv1, rq1, conv2 with
//   N = 3*80, shift-add, rq2) and differed only in how Mosaic scheduled
//   conv1 (v1 a broadcast multiply-add on the VPU, v5 a K = 8 dot), so both
//   entry points launch the one kernel below.
//
// Computes, per frame of x (B, 2, 128) f32:
//   xq   = clip(round_half_even(x * inv_sx), -127, 127)                int8
//   P[3h+k, t] = xq[h, t+k] for t < 126, else 0; P[6], P[7] = 0   (8, 128)
//   a1[t, n] = clip((sum_j P[j, t] * w1e[j, n] + o1[n]) >> m1[n], 0, 127)
//   then conv2 and rq2 as in conv_stage_int8_mma.cuh -> (124, 80) int8
// the v7 function (golden/quant.py's integer spec) with no bf16 fold, so a
// model that quant.fold_conv1_weights refuses still runs on tensor cores.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (~13.4 us at 3.35 TB/s):
// operation-bound, ~64 us.
//
// Design (simple and right first): v10's persistent block of 8 warps per SM
// with conv2's weight resident in shared memory, and conv1 on the tensor
// cores in integers: the TPU kernel's three row-offset K=8 dots become one
// int8 mma.sync.m16n8k16 per 8 columns whose K lanes are the 6 (plane, tap)
// values of the row (lanes 6..15 zero), with exact int32 sums and the
// integer rq1 in the epilogue. Each thread quantizes one sample of the
// frame (rint of a separately rounded multiply by the f32 reciprocal) and
// scatters it into the three planes that hold it. Frames are read one at a
// time, as the TPU kernel read them (it had no prefetch).
#include "conv_stage_int8_mma.cuh"

namespace {

constexpr int SMEM_BYTES =
    W2S_BYTES + A1S_BYTES + W1S_BYTES + Q1S_BYTES + PLANES_BYTES;
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(THREADS == 2 * T, "one thread per sample of a frame");

__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_v5_kernel(const float* __restrict__ x, long long n,
                          const int8_t* __restrict__ w1e,
                          const int* __restrict__ m1,
                          const int* __restrict__ o1,
                          const int8_t* __restrict__ w2l,
                          const int* __restrict__ m2,
                          const int* __restrict__ o2, float inv_sx,
                          int8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w2s = reinterpret_cast<int8_t*>(smem);
  int8_t* a1s = reinterpret_cast<int8_t*>(smem + W2S_BYTES);
  uint32_t* w1s = reinterpret_cast<uint32_t*>(smem + W2S_BYTES + A1S_BYTES);
  int* q1s = reinterpret_cast<int*>(smem + W2S_BYTES + A1S_BYTES + W1S_BYTES);
  int8_t* P = reinterpret_cast<int8_t*>(smem + W2S_BYTES + A1S_BYTES +
                                        W1S_BYTES + Q1S_BYTES);
  const int tid = threadIdx.x;

  stage_conv2(w2l, w2s, a1s);
  stage_conv1_int8(w1e, m1, o1, w1s, q1s);
  // Planes 6, 7 and the two tail columns of planes 0..5 stay zero: the
  // scatter below never writes them.
  for (int i = tid; i < PLANES_BYTES; i += THREADS)
    P[i] = 0;
  const Rq2 rq = load_rq2(m2, o2);
  const int h = tid / T, t = tid % T;
  __syncthreads();

  for (long long f = blockIdx.x; f < n; f += gridDim.x) {
    float q = rintf(__fmul_rn(x[f * 2 * T + tid], inv_sx));
    const int8_t v = static_cast<int8_t>(
        static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f)));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (t >= k && t - k < T - 2) P[(3 * h + k) * T + t - k] = v;
    __syncthreads();
    conv1_planes(P, w1s, q1s, a1s);
    __syncthreads();
    conv2_rq2_store(a1s, w2s, rq, f, out);
    // The next frame's scatter may rewrite P at once: every thread read it
    // in conv1, before the second __syncthreads above. Its conv1 rewrites
    // a1s only after its first __syncthreads, when all have left conv2.
  }
}

int launch(const void* x, long long n, const void* w1e, const void* m1,
           const void* o1, const void* w2l, const void* m2, const void* o2,
           float inv_sx, void* out, void* stream) {
  return launch_persistent(
      conv_stage_int8_v5_kernel, SMEM_BYTES, n, stream,
      static_cast<const float*>(x), n, static_cast<const int8_t*>(w1e),
      static_cast<const int*>(m1), static_cast<const int*>(o1),
      static_cast<const int8_t*>(w2l), static_cast<const int*>(m2),
      static_cast<const int*>(o2), inv_sx, static_cast<int8_t*>(out));
}

}  // namespace

extern "C" int amc_conv_stage_int8_v5(const void* x, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch(x, n, w1e, m1, o1, w2l, m2, o2, inv_sx, out, stream);
}

extern "C" int amc_conv_stage_int8_v1(const void* x, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch(x, n, w1e, m1, o1, w2l, m2, o2, inv_sx, out, stream);
}
