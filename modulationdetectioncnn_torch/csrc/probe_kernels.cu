// The two kernels of the JAX package's probe suite that no product kernel
// of the port computes, for Hopper (sm_90a).
//
// Replaces: scripts/probe.py::probe_r3's `_copy_kernel` (the pl.pallas_call
//   at scripts/probe.py:1044) with amc_copy_bytes: an identity copy of the
//   (B, 16384) int8 conv intermediate, which measured the achieved HBM
//   bandwidth.
// Replaces: scripts/probe.py::probe_r3f's `_pro_kernel` (scripts/probe.py:2061)
//   and probe_r3i's proK1..proK3 (scripts/probe.py:2477) with
//   amc_tap_planes: the int8 prologue alone, (B, 2, T) f32 frames ->
//   (B, 8, T) int8 tap planes, out[b, 3h+k, t] = q(x[b, h, t+k]) for
//   t < T-2 and 0 after, planes 6 and 7 zero, where
//   q(v) = clip(rint(v * inv_sx), -127, 127): a multiply by the f32
//   reciprocal (never a divide), rounded half to even, as
//   ops/requant.py::quantize_input and ops/infer.py::tap_planes (its plain
//   version; the v4/v6 prologue, which stays plain torch on their path).
//
// Bound on the H100 SXM: both move bytes and do almost no arithmetic.
// amc_copy_bytes reads and writes n bytes: 2n / 3.35 TB/s (0.040 ms for
// the 67 MB of the probe's (4096, 16384) int8). amc_tap_planes reads 1 KB
// and writes 1 KB per frame of T = 128: 8.4 MB at B=4096, 2.5 us, shorter
// than a launch.
//
// Design (simple and right first): the copy is a grid-stride loop of
// 16-byte vector loads and stores (neighbouring threads on neighbouring
// addresses), then a byte loop over the tail; the wrapper passes 16-byte
// aligned pointers. The prologue runs one thread per (frame, t): it reads
// the six taps x[b, h, t+k] (the three threads that share an element read
// it through L1) and writes its column of the eight planes, each store
// coalesced over t.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;   // grid-stride beyond this many

__global__ void __launch_bounds__(THREADS)
copy_bytes_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                  long long n_vec, const uint8_t* __restrict__ in_b,
                  uint8_t* __restrict__ out_b, long long n_bytes) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long i = first; i < n_vec; i += stride) out[i] = in[i];
  for (long long i = n_vec * 16 + first; i < n_bytes; i += stride) out_b[i] = in_b[i];
}

__device__ __forceinline__ int8_t quantize(float v, float inv_sx) {
  const float r = rintf(__fmul_rn(v, inv_sx));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

__global__ void __launch_bounds__(THREADS)
tap_planes_kernel(const float* __restrict__ x, long long n, int t_len,
                  float inv_sx, int8_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    const long long b = i / t_len;
    const int t = static_cast<int>(i % t_len);
    const float* xb = x + b * 2 * t_len;
    int8_t* ob = out + b * 8 * t_len + t;
    const bool inside = t < t_len - 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ob[(3 * h + k) * t_len] = inside ? quantize(xb[h * t_len + t + k], inv_sx) : 0;
    ob[6 * t_len] = 0;
    ob[7 * t_len] = 0;
  }
}

long long blocks_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

extern "C" int amc_copy_bytes(const void* in, long long n_bytes, void* out,
                              void* stream) {
  const long long n_vec = n_bytes / 16;
  copy_bytes_kernel<<<static_cast<unsigned>(blocks_for(n_vec > 0 ? n_vec : n_bytes)),
                      THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), n_vec,
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int amc_tap_planes(const void* x, long long b, int t_len, float inv_sx,
                              void* out, void* stream) {
  const long long n = b * t_len;
  tap_planes_kernel<<<static_cast<unsigned>(blocks_for(n)), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, t_len, inv_sx, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
