// Fused int8 conv stage on tap rows, conv1 and conv2 on the int8 tensor
// cores, for Hopper (sm_90a). One templated body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v3_kernel
//   (ops/infer.py:600, reached by pl.pallas_call in make_int8_classifier_v3,
//   ops/infer.py:697) with amc_conv_stage_int8_v3, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v2_kernel
//   (ops/infer.py:459, make_int8_forward_v2, ops/infer.py:515) with
//   amc_conv_stage_int8_v2.
//
// Computes, per frame of xe (B, 126, 8) int8 tap rows (ops/infer.py's
// expand_taps, the JAX package's quantize + expand_taps, which both
// packages run outside the kernel; lane 3h+k of row t is xq[h, t+k], lanes
// 6 and 7 zero):
//   a1[t, n] = clip((sum_j xe[t, j] * w1e[j, n] + o1[n]) >> m1[n], 0, 127)
//   then conv2 and rq2 as in conv_stage_int8_mma.cuh -> (124, 80) int8
// the v7 function from the rows, with no bf16 fold. The TPU kernels wrote
// (B, 126, 128) (v3, with garbage rows and lanes nulled by zero rows of the
// padded dense1 weight) or (B, 124, 80) (v2): layout only; both entries
// here write the compact (B, 124, 80) map that every dense stage reads.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7's): conv1
// 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536 ~ 124.8 G int8 ops
// (63.9 us at 1,979 TOP/s) against ~45 MB moved (~13.4 us at 3.35 TB/s):
// operation-bound, ~64 us.
//
// Design (simple and right first): v4/v6's body (a persistent block of 8
// warps per SM, conv2's weight resident in shared memory, conv1 as one int8
// mma.sync.m16n8k16 per 8 columns with the 8 lanes on K, exact integer
// rq1, conv2 with the shift-add in the accumulator), reading each frame's
// 1008 bytes of rows. A row is the conv1 A fragment's K lanes as they lie
// in memory, so a fragment register is one 32-bit shared load where the
// planes needed four byte loads. The TPU's v3 improved on v2 by its layout;
// here v3 (PREFETCH) copies the next frame's rows into a second buffer with
// cp.async while the current frame's products run, and v2 loads each frame
// in turn. The two compute the same map. conv1_rows repeats the header's
// conv1_planes with its own A loads rather than changing the header: an
// edit there can change how nvcc schedules v4/v6, which include it
// (PERF.md, Findings).
#include "conv_stage_int8_mma.cuh"

namespace {

constexpr int T1 = T - 2;                   // tap rows per frame (126)
constexpr int ROWS_BYTES = T1 * 8;          // 1008 bytes of input per frame
constexpr int XS_BYTES = T * 8;             // a staged frame: rows 126, 127 zero
constexpr int SMEM_BYTES =
    W2S_BYTES + A1S_BYTES + W1S_BYTES + Q1S_BYTES + 2 * XS_BYTES;
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(ROWS_BYTES % 16 == 0, "frames start 16-byte aligned");
static_assert(ROWS_BYTES / 4 <= THREADS, "one word of rows per thread");

// conv1 of one frame from its rows xs (128, 8): a1s[t, n] = rq1(sum_j
// xs[t, j] * w1e[j, n]) for all 128 rows (rows 126 and 127 are zero and
// feed only the dropped output rows). Warp w owns rows 16w .. 16w+15 and
// all 512 columns; A's K lanes 4*tig .. 4*tig+3 are word tig of the row for
// tig < 2, lanes 8..15 zero; the product is exact (|sum| <= 6 * 127 * 127).
__device__ __forceinline__ void conv1_rows(const int8_t* xs, const uint32_t* w1s,
                                           const int* q1s, int8_t* a1s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs);
  const uint32_t a0 = tig < 2 ? xw[(r0 + g) * 2 + tig] : 0u;
  const uint32_t a1 = tig < 2 ? xw[(r0 + g + 8) * 2 + tig] : 0u;
  int8_t* row0 = a1s + (r0 + g) * STRIDE + 2 * tig;
  int8_t* row1 = row0 + 8 * STRIDE;
#pragma unroll 4
  for (int nt = 0; nt < K1 / 8; ++nt) {
    const uint32_t b = tig < 2 ? w1s[(nt * 8 + g) * 2 + tig] : 0u;
    int d[4];
    mma_s8_k16(d, a0, a1, b);
    const int c = nt * 8 + 2 * tig;
    const int s0 = q1s[c], s1 = q1s[c + 1];
    const int f0 = q1s[K1 + c], f1 = q1s[K1 + c + 1];
    *reinterpret_cast<uint16_t*>(row0 + nt * 8) = static_cast<uint16_t>(
        requant(d[0], f0, s0) | (requant(d[1], f1, s1) << 8));
    *reinterpret_cast<uint16_t*>(row1 + nt * 8) = static_cast<uint16_t>(
        requant(d[2], f0, s0) | (requant(d[3], f1, s1) << 8));
  }
}

template <bool PREFETCH>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_int8_rows_kernel(const int8_t* __restrict__ xe, long long n,
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
  int8_t* xs = reinterpret_cast<int8_t*>(smem + W2S_BYTES + A1S_BYTES +
                                         W1S_BYTES + Q1S_BYTES);
  const int tid = threadIdx.x;

  stage_conv2(w2l, w2s, a1s);
  stage_conv1_int8(w1e, m1, o1, w1s, q1s);
  // Rows 126 and 127 of both buffers stay zero: no copy writes them.
  for (int i = tid; i < 2 * (XS_BYTES - ROWS_BYTES); i += THREADS) {
    const int half = XS_BYTES - ROWS_BYTES;
    xs[(i / half) * XS_BYTES + ROWS_BYTES + i % half] = 0;
  }
  const Rq2 rq = load_rq2(m2, o2);

  long long f = blockIdx.x;
  int buf = 0;
  constexpr int CHUNKS = ROWS_BYTES / 16;  // 16-byte copies per frame
  if (PREFETCH) {
    if (f < n && tid < CHUNKS)
      cp_async16(xs + 16 * tid, xe + f * ROWS_BYTES + 16 * tid);
    cp_async_commit();
  }
  __syncthreads();

  for (; f < n; f += gridDim.x) {
    int8_t* X = xs + buf * XS_BYTES;
    if (PREFETCH) {
      // Start the next frame's copy into the other buffer, then wait for
      // this frame's (the older group).
      const long long fn = f + gridDim.x;
      if (fn < n && tid < CHUNKS)
        cp_async16(xs + (buf ^ 1) * XS_BYTES + 16 * tid,
                   xe + fn * ROWS_BYTES + 16 * tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else if (tid < ROWS_BYTES / 4) {
      reinterpret_cast<uint32_t*>(X)[tid] =
          reinterpret_cast<const uint32_t*>(xe + f * ROWS_BYTES)[tid];
    }
    __syncthreads();
    conv1_rows(X, w1s, q1s, a1s);
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
int launch(const void* xe, long long n, const void* w1e, const void* m1,
           const void* o1, const void* w2l, const void* m2, const void* o2,
           void* out, void* stream) {
  return launch_persistent(
      conv_stage_int8_rows_kernel<PREFETCH>, SMEM_BYTES, n, stream,
      static_cast<const int8_t*>(xe), n, static_cast<const int8_t*>(w1e),
      static_cast<const int*>(m1), static_cast<const int*>(o1),
      static_cast<const int8_t*>(w2l), static_cast<const int*>(m2),
      static_cast<const int*>(o2), static_cast<int8_t*>(out));
}

}  // namespace

extern "C" int amc_conv_stage_int8_v3(const void* xe, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch<true>(xe, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}

extern "C" int amc_conv_stage_int8_v2(const void* xe, long long n,
                                      const void* w1e, const void* m1,
                                      const void* o1, const void* w2l,
                                      const void* m2, const void* o2,
                                      void* out, void* stream) {
  return launch<false>(xe, n, w1e, m1, o1, w2l, m2, o2, out, stream);
}
