// Fused bf16 dense1 -> ReLU -> dense2 -> class mask [-> argmax], for
// Hopper (sm_90a). One templated body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_dense_argmax_bf16_kernel
//   (ops/infer.py:1848, reached by pl.pallas_call in make_bf16_classifier_v4,
//   ops/infer.py:1940) with amc_dense_argmax_bf16, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_dense_stage_bf16_kernel
//   (ops/infer.py:107, the dense stage of make_bf16_forward and
//   make_bf16_forward_v2, ops/infer.py:172 and :292) with amc_dense_bf16,
//   which stops at the logits and writes them, (B, 11) f32.
//
// Computes, per frame of h (B, 9920) bf16 (the conv map flattened t*80+c):
//   d1[d]    = bf16_rn(relu(sum_k h[k] * w3t[d, k] + b3[d]))    f32 sums
//   logit[c] = sum_d d1[d] * w4[d, c] + b4[c]                    f32
//   logit[c] = -inf for c >= nc (the model's own classes)
//   label    = argmax, ties to the lowest index                 int32
//              (amc_dense_argmax_bf16; amc_dense_bf16 writes the logits)
// w3t (256, 9920), w4 (256, 11) bf16; b3, b4 f32. The TPU kernels read a
// (B, 128*128) map whose padded rows and lanes met zero rows of their W3
// (v4) or the compact (B, 9920) map (the forwards), and the forwards wrote
// 128 logits of which the caller kept the model's own; this one reads the
// compact map and writes 11, the padded ones at -inf as the plain version
// does. Both entries share the logits, so the argmax of amc_dense_bf16's
// logits is amc_dense_argmax_bf16's label.
//
// Bound on the H100 SXM at B = 4096: the map read once, 4096*9920*2 =
// 81.3 MB (~0.024 ms at 3.35 TB/s), against 2*B*(9920*256 + 256*11) ~
// 20.8 G bf16 operations (~0.021 ms at 989 TFLOP/s): memory-bound, ~0.024 ms.
//
// Design (simple and right first): a block owns 32 frames and all 256
// dense1 outputs, so dense2 and the argmax finish in shared memory and only
// the label (or the 11 logits) leaves the block. dense1 runs on the tensor
// cores (bf16 mma.sync.m16n8k16, f32 sums), each warp 16 frames x 64
// outputs; K walks in chunks of 32 through two shared-memory buffers fed
// by cp.async, the next chunk in flight while the current one is
// multiplied. W3 (5.1 MB) is read by every block and stays in the 50 MB
// L2; the map is read from device memory once. dense2 is 352 scalar dot
// products of 256 exact bf16 products per block, summed in order; the
// argmax is a strict ">" scan.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KD = 124 * 80;      // dense1 reduction length (9920)
constexpr int D = 256;            // dense1 outputs
constexpr int NC = 11;            // classes, padded
constexpr int BM = 32;            // frames per block
constexpr int KC = 32;            // K chunk (bf16)
constexpr int NCH = KD / KC;      // chunks (310)
constexpr int SSTRIDE = KC + 8;   // bf16 per staged row (20 words: no bank conflicts)
constexpr int DSTRIDE = D + 8;    // bf16 per d1 row
constexpr int THREADS = 256;
constexpr int HS_ELEMS = BM * SSTRIDE;
constexpr int WS_ELEMS = D * SSTRIDE;
constexpr int SMEM_BYTES = 2 * (HS_ELEMS + WS_ELEMS) * 2 + BM * DSTRIDE * 2 + BM * NC * 4;
static_assert(KD % KC == 0 && KC % 16 == 0, "chunks tile the reduction");
static_assert((HS_ELEMS * 2) % 16 == 0 && (WS_ELEMS * 2) % 16 == 0, "16-byte regions");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue chunk c of the block's 32 map rows and of w3t into one buffer pair.
// Rows past the batch re-read the last frame; their results are dropped.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ h,
                                           const __nv_bfloat16* __restrict__ w3t,
                                           long long f0, long long n,
                                           __nv_bfloat16* hs, __nv_bfloat16* ws,
                                           int c) {
  const int tid = threadIdx.x;
  if (tid < BM * (KC / 8)) {
    const int r = tid / (KC / 8), q = tid % (KC / 8);
    const long long f = min(f0 + r, n - 1);
    cp_async16(hs + r * SSTRIDE + q * 8, h + f * KD + c * KC + q * 8);
  }
#pragma unroll
  for (int i = tid; i < D * (KC / 8); i += THREADS) {
    const int d = i / (KC / 8), q = i % (KC / 8);
    cp_async16(ws + d * SSTRIDE + q * 8, w3t + static_cast<long long>(d) * KD + c * KC + q * 8);
  }
  cp_async_commit();
}

// ARGMAX: labels (B,) int32 into out; else the logits (B, NC) f32.
template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS)
dense_argmax_bf16_kernel(const __nv_bfloat16* __restrict__ h, long long n,
                         const __nv_bfloat16* __restrict__ w3t,
                         const float* __restrict__ b3,
                         const __nv_bfloat16* __restrict__ w4,
                         const float* __restrict__ b4, int nc,
                         void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = hs + 2 * HS_ELEMS;
  __nv_bfloat16* d1s = ws + 2 * WS_ELEMS;
  float* logits = reinterpret_cast<float*>(d1s + BM * DSTRIDE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = (warp & 1) * 16, d0 = (warp >> 1) * 64;
  const long long f0 = static_cast<long long>(blockIdx.x) * BM;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  load_chunk(h, w3t, f0, n, hs, ws, 0);
  load_chunk(h, w3t, f0, n, hs + HS_ELEMS, ws + WS_ELEMS, 1);
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* hb = hs + (c & 1) * HS_ELEMS;
    const __nv_bfloat16* wb = ws + (c & 1) * WS_ELEMS;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      const __nv_bfloat16* p = hb + (r0 + g) * SSTRIDE + kk + 2 * tig;
      const uint32_t a[4] = {lds32(p), lds32(p + 8 * SSTRIDE), lds32(p + 8),
                             lds32(p + 8 * SSTRIDE + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* q = wb + (d0 + j * 8 + g) * SSTRIDE + kk + 2 * tig;
        mma_bf16(acc[j], a, lds32(q), lds32(q + 8));
      }
    }
    __syncthreads();
    if (c + 2 < NCH)
      load_chunk(h, w3t, f0, n, hs + (c & 1) * HS_ELEMS, ws + (c & 1) * WS_ELEMS, c + 2);
    else
      cp_async_commit();    // an empty group keeps the wait count uniform
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = d0 + j * 8 + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + g + 8 * half;
      const float v0 = fmaxf(__fadd_rn(acc[j][2 * half], b3[d]), 0.0f);
      const float v1 = fmaxf(__fadd_rn(acc[j][2 * half + 1], b3[d + 1]), 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(d1s + r * DSTRIDE + d) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < BM * NC; idx += THREADS) {
    const int r = idx / NC, c = idx % NC;
    float s = 0.0f;
    for (int d = 0; d < D; ++d)
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(d1s[r * DSTRIDE + d]),
                                 __bfloat162float(w4[d * NC + c])));
    const float v = c < nc ? __fadd_rn(s, b4[c]) : -INFINITY;
    if constexpr (ARGMAX)
      logits[r * NC + c] = v;
    else if (f0 + r < n)
      static_cast<float*>(out)[(f0 + r) * NC + c] = v;
  }
  if constexpr (ARGMAX) {
    __syncthreads();
    if (tid < BM && f0 + tid < n) {
      int best = 0;
      float bv = logits[tid * NC];
      for (int c = 1; c < NC; ++c) {
        if (logits[tid * NC + c] > bv) {  // strict: ties keep the lowest index
          bv = logits[tid * NC + c];
          best = c;
        }
      }
      static_cast<int*>(out)[f0 + tid] = best;
    }
  }
}

template <bool ARGMAX>
int launch(const void* h, long long n, const void* w3t, const void* b3,
           const void* w4, const void* b4, int nc, void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_argmax_bf16_kernel<ARGMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + BM - 1) / BM;
  dense_argmax_bf16_kernel<ARGMAX><<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), n, static_cast<const __nv_bfloat16*>(w3t),
      static_cast<const float*>(b3), static_cast<const __nv_bfloat16*>(w4),
      static_cast<const float*>(b4), nc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int amc_dense_argmax_bf16(const void* h, long long n, const void* w3t,
                                     const void* b3, const void* w4, const void* b4,
                                     int nc, void* out, void* stream) {
  return launch<true>(h, n, w3t, b3, w4, b4, nc, out, stream);
}

extern "C" int amc_dense_bf16(const void* h, long long n, const void* w3t,
                              const void* b3, const void* w4, const void* b4, int nc,
                              void* out, void* stream) {
  return launch<false>(h, n, w3t, b3, w4, b4, nc, out, stream);
}
