// The per-frame fractional-delay FIR of the symbol-timing correction, for
// Hopper (sm_90a).
//
// Replaces: modulationdetectioncnn_tpu/dsp/normalize.py::correct_timing's
//   kernel `kern` (dsp/normalize.py:189, reached by pl.pallas_call at
//   dsp/normalize.py:198) with amc_correct_timing_fir_window (T = 128,
//   (taps - 1) / 2 <= 8: the stream's frames and 17 taps) and
//   amc_correct_timing_fir (every other width); dsp/normalize.py::
//   correct_timing_fir_route picks one from the widths and the alignment
//   (a dispatch by shape, never a retry).
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
// The window route (correct_timing_fir_window_kernel<HALF>, HALF = (taps -
// 1) / 2 a template argument, so the window and the taps live in
// registers): one warp per frame, both planes under the frame's one filter,
// no shared memory. Lane j < taps loads tap j (a filter row is 4 * taps
// bytes, only 4-byte aligned) and each lane takes all taps from those lanes
// by __shfl_sync. Lane l owns outputs 4l .. 4l+3 of a plane: it loads its
// own float4 (a warp reads the 512-byte row in one coalesced instruction;
// both planes' loads are issued before any arithmetic), takes x[4l - HALF
// .. 4l + 3 + HALF] from lanes l - 2 .. l + 2 by __shfl_up_sync and
// __shfl_down_sync (16 a plane at HALF > 4, 8 at HALF <= 4), zeros where
// those lanes lie past the row's ends (the zero halo), runs the taps x 4
// outputs from registers in the order above and stores one float4. The old
// body (the general route below) issued two shared-memory loads per tap
// and output, 136 warp-level loads a row, which bounded it by shared-memory
// issue rather than by the bytes.
//
// The general route (correct_timing_fir_kernel, any T and odd taps within
// its shared memory): one warp per row, 8 rows per block of 256 threads.
// The warp copies its row into shared memory with the zero halo on each
// side (the TPU kernel's padded block held in VMEM) and the frame's filter
// beside it, then each lane computes every 32nd output from shared memory.
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

constexpr int WIN_T = 128;              // the window route's frame length
constexpr int WIN_MAX_HALF = 8;          // (taps - 1) / 2 it takes: 17 taps
constexpr unsigned FULL = 0xffffffffu;

// Outputs 4l .. 4l+3 of one plane for lane l, from the lane's own float4 v
// (x[4l .. 4l+3]) and the frame's taps cj, into o (16-byte aligned).
template <int HALF>
__device__ __forceinline__ void fir_window_plane(float4 v, const float (&cj)[2 * HALF + 1],
                                                 int lane, float* __restrict__ o) {
  constexpr int TAPS = 2 * HALF + 1;
  // xx[i] = x[4l - 8 + i]: lanes l-2, l-1 (x[4l-8 .. 4l-1]), l, l+1, l+2;
  // the lanes past the row's ends give zeros.
  float xx[20];
  xx[8] = v.x, xx[9] = v.y, xx[10] = v.z, xx[11] = v.w;
  const float own[4] = {v.x, v.y, v.z, v.w};
  constexpr int REACH = HALF > 4 ? 2 : HALF > 0 ? 1 : 0;   // neighbour lanes a side
#pragma unroll
  for (int d = 1; d <= REACH; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lo = __shfl_up_sync(FULL, own[e], d);
      const float hi = __shfl_down_sync(FULL, own[e], d);
      xx[8 - 4 * d + e] = lane >= d ? lo : 0.0f;
      xx[8 + 4 * d + e] = lane < 32 - d ? hi : 0.0f;
    }
  }
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j)
      acc = __fadd_rn(acc, __fmul_rn(xx[8 - HALF + k + j], cj[j]));
    r[k] = acc;
  }
  *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
}

// x, out (frames, 2, 128) f32, 16-byte aligned; c (frames, 2*HALF+1) f32.
template <int HALF>
__global__ void __launch_bounds__(THREADS)
correct_timing_fir_window_kernel(const float* __restrict__ x, long long frames,
                                 const float* __restrict__ c, float* __restrict__ out) {
  constexpr int TAPS = 2 * HALF + 1;
  static_assert(TAPS <= 32, "one tap a lane");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long f = static_cast<long long>(blockIdx.x) * WARPS + warp; f < frames;
       f += static_cast<long long>(gridDim.x) * WARPS) {
    const float4* xf = reinterpret_cast<const float4*>(x + f * 2 * WIN_T);
    const float4 v0 = __ldg(xf + lane), v1 = __ldg(xf + WIN_T / 4 + lane);
    const float tap = lane < TAPS ? __ldg(c + f * TAPS + lane) : 0.0f;
    float cj[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) cj[j] = __shfl_sync(FULL, tap, j);
    float* o = out + f * 2 * WIN_T + 4 * lane;
    fir_window_plane<HALF>(v0, cj, lane, o);
    fir_window_plane<HALF>(v1, cj, lane, o + WIN_T);
  }
}

template <int HALF>
void launch_window(const float* x, long long frames, const float* c, float* out,
                   cudaStream_t s) {
  long long blocks = (frames + WARPS - 1) / WARPS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  correct_timing_fir_window_kernel<HALF><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      x, frames, c, out);
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

// The window route: x, out (rows / 2, 2, 128) f32, both 16-byte aligned,
// rows even, c (rows / 2, taps) f32 with taps odd and at most 17; else
// cudaErrorInvalidValue, before any launch.
extern "C" int amc_correct_timing_fir_window(const void* x, long long rows, int t_len,
                                             const void* c, int taps, void* out,
                                             void* stream) {
  if (t_len != WIN_T || rows % 2 || taps < 1 || taps % 2 == 0 ||
      taps > 2 * WIN_MAX_HALF + 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(c);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long frames = rows / 2;
  switch ((taps - 1) / 2) {
    case 0: launch_window<0>(xf, frames, cf, of, s); break;
    case 1: launch_window<1>(xf, frames, cf, of, s); break;
    case 2: launch_window<2>(xf, frames, cf, of, s); break;
    case 3: launch_window<3>(xf, frames, cf, of, s); break;
    case 4: launch_window<4>(xf, frames, cf, of, s); break;
    case 5: launch_window<5>(xf, frames, cf, of, s); break;
    case 6: launch_window<6>(xf, frames, cf, of, s); break;
    case 7: launch_window<7>(xf, frames, cf, of, s); break;
    default: launch_window<8>(xf, frames, cf, of, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
