// Fused int8 conv stage of the VT-CNN2 classifier, for Hopper (sm_90a).
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v7_kernel
// (reached by pl.pallas_call in make_int8_classifier_v7 and make_conv_stage).
//
// Computes, per frame of x (B, 2, 128) f32:
//   xq  = clip(round_half_even(x * inv_sx), -127, 127)               int8
//   a1[t, h*256+c] = rq1(sum_k xq[h, t+k] * w1[k, c])        (126, 512) int8
//   a2[t, co] = rq2(sum_{k, j} a1[t+k, j] * w2t[co, k*512+j])  (124, 80) int8
// with rq(acc) = clip((acc + offset) >> shift, 0, 127) per channel. The
// output is the compact (B, 124, 80) map; the TPU kernel's 128-lane padding
// and garbage rows are not reproduced. Largest int32 sum: 1536 * 127^2
// ~ 2.5e7, far from overflow.
//
// Bound on the H100 SXM at B = 4096: 2*B*(126*512*3 + 124*80*1536)
// ~ 126.4 G int8 operations, ~64 us at 1,979 dense int8 TOP/s, against
// ~44.8 MB moved (~13 us at 3.35 TB/s): compute-bound.
//
// Design (simple and right first): one persistent block per SM keeps the
// whole conv2 weight (80 x 1536 int8, 123 KB) in shared memory for all the
// frames it walks, so weights are read from device memory once per SM, not
// once per frame; the (126, 512) conv1 tile never leaves shared memory.
// conv2 runs on the integer pipes with __dp4a (4 int8 MACs per
// instruction) and a 4-row x 5-channel register tile per thread. It does
// not reach the bound: the tensor cores (mma.sync / wgmma on int8) are the
// way there, in a later kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 128;              // frame length
constexpr int T1 = T - 2;           // conv1 output rows
constexpr int T2 = T - 4;           // conv2 output rows
constexpr int C1 = 256;             // conv1 channels per I/Q plane
constexpr int K1 = 2 * C1;          // stacked conv1 channels, h*C1 + c
constexpr int C2 = 80;              // conv2 channels
constexpr int KW = 3 * K1;          // conv2 reduction length
constexpr int THREADS = 512;        // == K1: one conv1 channel per thread
// Padded shared-memory row strides, in bytes. 516 = 129 words: conv1 rows
// four apart fall in different banks. 1540 = 385 words: neighbouring conv2
// channels fall in different banks.
constexpr int A1_STRIDE = K1 + 4;
constexpr int W2_STRIDE = KW + 4;
constexpr int TT = 4;               // conv2 register tile: rows
constexpr int TC = 5;               //                      channels
constexpr int ROW_TILES = T2 / TT;  // 31
constexpr int COL_TILES = C2 / TC;  // 16
constexpr int W2_BYTES = C2 * W2_STRIDE;
constexpr int A1_BYTES = T1 * A1_STRIDE;
constexpr int SMEM_BYTES = W2_BYTES + A1_BYTES + 2 * T;

static_assert(T2 % TT == 0 && C2 % TC == 0, "conv2 tile must divide the map");
static_assert(ROW_TILES * COL_TILES <= THREADS, "one conv2 tile per thread");
static_assert(W2_BYTES % 16 == 0 && A1_BYTES % 4 == 0, "smem alignment");

__device__ __forceinline__ int requant(int acc, int offset, int shift) {
  int v = (acc + offset) >> shift;  // arithmetic shift on signed int32
  return min(max(v, 0), 127);
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
  extern __shared__ __align__(16) unsigned char smem[];
  int* w2s = reinterpret_cast<int*>(smem);                        // words
  int8_t* a1s = reinterpret_cast<int8_t*>(smem + W2_BYTES);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + W2_BYTES + A1_BYTES);
  const int tid = threadIdx.x;

  // conv2 weights -> shared memory, once per block.
  const int* w2g = reinterpret_cast<const int*>(w2t);
  for (int i = tid; i < C2 * (KW / 4); i += THREADS) {
    const int co = i / (KW / 4), q = i % (KW / 4);
    w2s[co * (W2_STRIDE / 4) + q] = __ldg(w2g + i);
  }

  // conv1: this thread's channel j = h*C1 + c, constants in registers.
  const int h = tid / C1, c = tid % C1;
  const int w10 = w1[c], w11 = w1[C1 + c], w12 = w1[2 * C1 + c];
  const int sh1 = m1[tid], off1 = o1[tid];

  // conv2: this thread's tile, rows t0..t0+3 x channels c0..c0+4.
  const bool has_tile = tid < ROW_TILES * COL_TILES;
  const int t0 = (tid / COL_TILES) * TT, c0 = (tid % COL_TILES) * TC;
  int sh2[TC], off2[TC];
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    sh2[j] = has_tile ? m2[c0 + j] : 0;
    off2[j] = has_tile ? o2[c0 + j] : 0;
  }
  const int* a1w = reinterpret_cast<const int*>(a1s);

  for (long long f = blockIdx.x; f < n; f += gridDim.x) {
    // quantize: the multiply is rounded on its own, then rint rounds half
    // to even, as the reference's jnp.round / np.round do.
    if (tid < 2 * T) {
      float q = rintf(__fmul_rn(x[f * 2 * T + tid], inv_sx));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      xq[tid] = static_cast<int8_t>(static_cast<int>(q));
    }
    __syncthreads();

    const int8_t* xh = xq + h * T;
    for (int t = 0; t < T1; ++t) {
      int acc = xh[t] * w10 + xh[t + 1] * w11 + xh[t + 2] * w12;
      a1s[t * A1_STRIDE + tid] = static_cast<int8_t>(requant(acc, off1, sh1));
    }
    __syncthreads();

    if (has_tile) {
      int acc[TT][TC];
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = 0;
      for (int k = 0; k < 3; ++k) {
        const int* arow = a1w + (t0 + k) * (A1_STRIDE / 4);
        const int* wrow = w2s + c0 * (W2_STRIDE / 4) + k * (K1 / 4);
#pragma unroll 4
        for (int q = 0; q < K1 / 4; ++q) {
          int a[TT], w[TC];
#pragma unroll
          for (int i = 0; i < TT; ++i) a[i] = arow[i * (A1_STRIDE / 4) + q];
#pragma unroll
          for (int j = 0; j < TC; ++j) w[j] = wrow[j * (W2_STRIDE / 4) + q];
#pragma unroll
          for (int i = 0; i < TT; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
        }
      }
      int8_t* o = out + (f * T2 + t0) * C2 + c0;
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j)
          o[i * C2 + j] = static_cast<int8_t>(requant(acc[i][j], off2[j], sh2[j]));
    }
    __syncthreads();  // a1s and xq are rewritten for the next frame
  }
}

}  // namespace

extern "C" int amc_conv_stage_int8_v7(const void* x, long long n,
                                      const void* w1, const void* m1,
                                      const void* o1, const void* w2t,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_stage_int8_v7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv_stage_int8_v7_kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > n) blocks = n;
  conv_stage_int8_v7_kernel<<<static_cast<unsigned>(blocks), THREADS,
                              SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const int8_t*>(w1),
      static_cast<const int*>(m1), static_cast<const int*>(o1),
      static_cast<const int8_t*>(w2t), static_cast<const int*>(m2),
      static_cast<const int*>(o2), inv_sx, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* amc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
