// Fused int8 dense1 -> requantize -> dense2 -> argmax, for Hopper (sm_90a).
// One templated body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_dense_argmax_int8_kernel
// (ops/infer.py:631, the dense stage of make_int8_classifier_v7 and of
// v3..v10) with amc_dense_argmax_int8, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_dense_stage_int8_kernel
// (ops/infer.py:342, the dense stage of make_int8_forward_v2, call
// ops/infer.py:535, and of v1) with amc_dense_int8, which stops at the
// logits and writes them, (B, 11) f32.
//
// Computes, per frame of h (B, 9920) int8 (the conv map flattened t*80+c):
//   a3[d]  = clip((sum_k h[k] * w3t[d, k] + o3[d]) >> m3[d], 0, 127)   int8
//   acc4[c] = sum_d a3[d] * w4[d, c]                                  int32
//   logit[c] = float(acc4[c]) * s4[c] + b4[c]                           f32
//   label  = argmax over the 11 classes, ties to the lowest index     int32
//            (amc_dense_argmax_int8; amc_dense_int8 writes the logits)
// The logit is a rounded multiply and then a rounded add (__fmul_rn,
// __fadd_rn), never a fused multiply-add: the reference rounds twice, and
// an FMA could flip the argmax of a near tie.
//
// Bound on the H100 SXM at B = 4096: 2*B*(9920*256 + 256*11) ~ 20.8 G int8
// operations (~10.5 us at 1,979 TOP/s) against ~43.2 MB moved, mostly the
// activations read once (~13 us at 3.35 TB/s): memory-bound.
//
// Design (simple and right first): a block owns 32 frames and all 256
// dense1 outputs, so dense2 and the argmax finish in shared memory and
// only the label leaves the block. The reduction walks K in 64-byte
// chunks staged through shared memory (the weight chunk padded to 17 words
// a row so the 32 lanes of a warp hit 32 banks); each thread keeps a
// 4-frame x 8-output tile of int32 sums and multiplies with __dp4a.
// Activations are read from device memory once. The integer pipes, not
// memory, limit it; the tensor cores are a later kernel's work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KD = 124 * 80;      // dense1 reduction length (9920)
constexpr int KDW = KD / 4;       // in 32-bit words (2480)
constexpr int D = 256;            // dense1 outputs
constexpr int NC = 11;            // classes
constexpr int BM = 32;            // frames per block
constexpr int KC = 16;            // words per K chunk (64 bytes)
constexpr int W_STRIDE = KC + 1;  // padded weight-chunk row, in words
constexpr int THREADS = 256;
constexpr int FT = 4;             // register tile: frames
constexpr int DT = 8;             //                outputs (stride 32)

static_assert(KDW % KC == 0, "K chunks must tile the reduction");
static_assert((BM / FT) * 32 == THREADS && DT * 32 == D, "thread tiling");

// ARGMAX: labels (B,) int32 into out; else the logits (B, NC) f32.
template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS)
dense_argmax_int8_kernel(const int8_t* __restrict__ h, long long n,
                         const int8_t* __restrict__ w3t,
                         const int* __restrict__ m3,
                         const int* __restrict__ o3,
                         const int8_t* __restrict__ w4,
                         const float* __restrict__ s4,
                         const float* __restrict__ b4,
                         void* __restrict__ out) {
  __shared__ int hs[BM][KC];
  __shared__ int ws[D][W_STRIDE];
  __shared__ int8_t a3[BM][D];
  __shared__ float logits[BM][NC];

  const int tid = threadIdx.x;
  const long long f0 = static_cast<long long>(blockIdx.x) * BM;
  const int fg = tid / 32, dg = tid % 32;
  const int* hw = reinterpret_cast<const int*>(h);
  const int* ww = reinterpret_cast<const int*>(w3t);

  int acc[FT][DT];
#pragma unroll
  for (int i = 0; i < FT; ++i)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0;

  for (int kc = 0; kc < KDW / KC; ++kc) {
#pragma unroll
    for (int r = 0; r < (BM * KC) / THREADS; ++r) {
      const int idx = tid + r * THREADS, row = idx / KC, q = idx % KC;
      const long long f = f0 + row;
      hs[row][q] = f < n ? __ldg(hw + f * KDW + kc * KC + q) : 0;
    }
#pragma unroll
    for (int r = 0; r < (D * KC) / THREADS; ++r) {
      const int idx = tid + r * THREADS, d = idx / KC, q = idx % KC;
      ws[d][q] = __ldg(ww + d * KDW + kc * KC + q);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      int a[FT], w[DT];
#pragma unroll
      for (int i = 0; i < FT; ++i) a[i] = hs[fg * FT + i][q];
#pragma unroll
      for (int j = 0; j < DT; ++j) w[j] = ws[dg + 32 * j][q];
#pragma unroll
      for (int i = 0; i < FT; ++i)
#pragma unroll
        for (int j = 0; j < DT; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = dg + 32 * j, sh = m3[d], off = o3[d];
#pragma unroll
    for (int i = 0; i < FT; ++i) {
      const int v = (acc[i][j] + off) >> sh;  // arithmetic shift
      a3[fg * FT + i][d] = static_cast<int8_t>(min(max(v, 0), 127));
    }
  }
  __syncthreads();

  for (int idx = tid; idx < BM * NC; idx += THREADS) {
    const int r = idx / NC, c = idx % NC;
    int s = 0;
    for (int d = 0; d < D; ++d) s += a3[r][d] * static_cast<int>(w4[d * NC + c]);
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(s), s4[c]), b4[c]);
    if constexpr (ARGMAX)
      logits[r][c] = v;
    else if (f0 + r < n)
      static_cast<float*>(out)[(f0 + r) * NC + c] = v;
  }
  if constexpr (ARGMAX) {
    __syncthreads();
    if (tid < BM && f0 + tid < n) {
      int best = 0;
      float bv = logits[tid][0];
      for (int c = 1; c < NC; ++c) {
        if (logits[tid][c] > bv) {  // strict: ties keep the lowest index
          bv = logits[tid][c];
          best = c;
        }
      }
      static_cast<int*>(out)[f0 + tid] = best;
    }
  }
}

template <bool ARGMAX>
int launch(const void* h, long long n, const void* w3t, const void* m3,
           const void* o3, const void* w4, const void* s4, const void* b4,
           void* out, void* stream) {
  const long long blocks = (n + BM - 1) / BM;
  dense_argmax_int8_kernel<ARGMAX><<<static_cast<unsigned>(blocks), THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(h), n, static_cast<const int8_t*>(w3t),
      static_cast<const int*>(m3), static_cast<const int*>(o3),
      static_cast<const int8_t*>(w4), static_cast<const float*>(s4),
      static_cast<const float*>(b4), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int amc_dense_argmax_int8(const void* h, long long n,
                                     const void* w3t, const void* m3,
                                     const void* o3, const void* w4,
                                     const void* s4, const void* b4,
                                     void* out, void* stream) {
  return launch<true>(h, n, w3t, m3, o3, w4, s4, b4, out, stream);
}

extern "C" int amc_dense_int8(const void* h, long long n, const void* w3t,
                              const void* m3, const void* o3, const void* w4,
                              const void* s4, const void* b4, void* out,
                              void* stream) {
  return launch<false>(h, n, w3t, m3, o3, w4, s4, b4, out, stream);
}
