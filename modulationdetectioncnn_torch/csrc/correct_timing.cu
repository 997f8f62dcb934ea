// The per-frame fractional-delay FIR of the symbol-timing correction, for
// Hopper (sm_90a).
//
// Replaces: modulationdetectioncnn_tpu/dsp/normalize.py::correct_timing's
//   kernel `kern` (dsp/normalize.py:189, reached by pl.pallas_call at
//   dsp/normalize.py:198) with amc_correct_timing_fir.
//
// Computes, per row r of x (rows, T) f32 (row r = plane r % 2 of frame
// r / 2) with the frame's filter c (rows / 2, taps) f32, taps odd:
//   out[r, n] = sum_{j < taps} x_pad[r, n + j] * c[r / 2, j]
//   x_pad[r, i] = x[r, i - (taps - 1) / 2] inside the row, 0 outside
// summed as acc = acc + x * c[j] for j = 0, 1, ..., each product and each
// sum rounded to float32 on its own (__fmul_rn, then __fadd_rn, never a
// fused multiply-add), from acc = 0: the JAX kernel's order of arithmetic,
// so the result is bit-exact against the plain PyTorch version
// (dsp/normalize.py::correct_timing_fir_plain), which does the same adds.
//
// Bound on the H100 SXM at the stream bench's 4096 frames (8192 rows of
// T = 128, taps = 17): each row read once (4.19 MB; the JAX kernel read the
// zero-padded 144-sample rows, 4.72 MB), the filters once (0.28 MB), the
// output written once (4.19 MB), ~9 MB at 3.35 TB/s, ~2.7 us; 2*17 float
// operations per output (35.7 M) are nothing beside that: memory-bound.
//
// Design (simple and right first): one warp per row, 8 rows per block of
// 256 threads. The warp copies its row into shared memory with the zero
// halo on each side (the TPU kernel's padded block held in VMEM) and the
// frame's filter beside it, then each lane computes every 32nd output from
// shared memory. Each element is read from device memory once; the 17
// shifted reads per output (the TPU's lane rolls) hit shared memory only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_BLOCKS = 1 << 16;      // grid-stride beyond this many

__global__ void __launch_bounds__(THREADS)
correct_timing_fir_kernel(const float* __restrict__ x, long long rows,
                          int t_len, const float* __restrict__ c, int taps,
                          float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = (taps - 1) / 2;
  const int padded = t_len + taps - 1;
  float* xs = smem + warp * (padded + taps);   // the padded row
  float* cs = xs + padded;                     // its frame's filter
  for (long long r = static_cast<long long>(blockIdx.x) * WARPS + warp;
       r < rows; r += static_cast<long long>(gridDim.x) * WARPS) {
    const float* xr = x + r * t_len;
    for (int i = lane; i < padded; i += 32) {
      const int t = i - half;
      xs[i] = (t >= 0 && t < t_len) ? xr[t] : 0.0f;
    }
    for (int j = lane; j < taps; j += 32) cs[j] = c[(r / 2) * taps + j];
    __syncwarp();
    float* orow = out + r * t_len;
    for (int t = lane; t < t_len; t += 32) {
      float acc = 0.0f;
      for (int j = 0; j < taps; ++j)
        acc = __fadd_rn(acc, __fmul_rn(xs[t + j], cs[j]));
      orow[t] = acc;
    }
    __syncwarp();  // the next row overwrites xs and cs
  }
}

}  // namespace

extern "C" int amc_correct_timing_fir(const void* x, long long rows, int t_len,
                                      const void* c, int taps, void* out,
                                      void* stream) {
  long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const size_t smem = sizeof(float) * WARPS * (t_len + 2 * taps - 1);
  correct_timing_fir_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, t_len, static_cast<const float*>(c),
      taps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
