// Fused bf16 conv stages, for Hopper (sm_90a). One templated body, three C
// entry points, which differ only in how conv1's input arrives:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_v4_kernel
//   (ops/infer.py:1819, reached by pl.pallas_call in make_bf16_classifier_v4,
//   ops/infer.py:1921) with amc_conv_stage_bf16_v4, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_v2_kernel
//   (ops/infer.py:199, make_bf16_forward_v2, ops/infer.py:272) with
//   amc_conv_stage_bf16_v2, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_bf16_kernel
//   (ops/infer.py:82, make_bf16_forward, ops/infer.py:150) with
//   amc_conv_stage_bf16.
//
// Computes, per frame, conv1 into a1 (126, 512) bf16 (n = h*256 + c):
//   v4 (IN_FRAME_BF16), x (B, 2, 128) f32, rounded here: xb = bf16_rn(x)
//     (the TPU kernel read the (B, 8, 128) bf16 tap planes that an XLA
//     prologue built from the same frames)
//     a1[t, n] = bf16_rn(relu(((xb[h,t] * w1e[3h,n] + xb[h,t+1] * w1e[3h+1,n])
//                              + xb[h,t+2] * w1e[3h+2,n]) + w1e[6,n]))
//   v2 (IN_TAP_ROWS), xe (B, 126, 8) bf16 tap rows (ops/infer_bf16.py's
//     expand_taps_bf16, the XLA prologue of make_bf16_forward_v2: lane 3h+k
//     of row t is xb[h, t+k], lane 6 is 1.0, lane 7 zero)
//     a1[t, n] = bf16_rn(relu(((xe[t,3h] * w1e[3h,n] + xe[t,3h+1] * w1e[3h+1,n])
//                              + xe[t,3h+2] * w1e[3h+2,n]) + xe[t,6] * w1e[6,n]))
//     (lane 7 and the other plane's lanes meet zeros of the block-diagonal
//     w1e and add exact zeros, so they are skipped): v4's a1 on the same
//     frames, bit for bit, since xe[t,6] * w1e[6,n] = w1e[6,n] exactly.
//   bf16 (IN_FRAME_F32), x (B, 2, 128) f32, NOT rounded; w1p (3, 256) and
//     b1 (512,) f32 (conv1's taps and its bias duplicated over the planes):
//     a1[t, n] = bf16_rn(relu(((x[h,t] * w1p[0,c] + x[h,t+1] * w1p[1,c])
//                              + x[h,t+2] * w1p[2,c]) + b1[n]))
//     in the JAX kernel's order (conv1_accumulate, then + b1). Its products
//     are not exact, so each one and each sum is rounded on its own
//     (__fmul_rn, __fadd_rn; an FMA would round once).
// Every product of v4 and v2 is of two bf16 values, exact in f32; all three
// sum in the plain versions' order with rounded adds, so a1 is bit-exact
// against them. Then, for all three:
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2t[k*80+co, j]            f32, t < 124
//   out[t, co] = bf16_rn(relu(s + b2[co]))                     (124, 80) bf16
// The reference sums z_k = a1[t+k] . w2[:, k] per tap, then z0 + z1 + z2 +
// b2; the tensor cores sum all 1536 exact products in their own order, so
// the map differs from the plain version's only by the order of f32 sums.
//
// Bound on the H100 SXM at B = 4096: conv1 2*B*126*512*3 ~ 1.6 G plus conv2
// 2*B*124*80*1536 ~ 124.8 G bf16 operations (~0.128 ms at 989 TFLOP/s)
// against ~85 MB moved (the (B, 124, 80) bf16 map written once, ~0.025 ms
// at 3.35 TB/s): operation-bound, ~0.128 ms. The bf16 entry's conv1 is
// ~1.6 GFLOP of f32 (~0.024 ms at 67 TFLOP/s) on pipes that run beside the
// tensor cores, so its bound is the larger of that and conv2's bf16
// operations alone (~0.126 ms).
//
// Design (simple and right first). conv2's bf16 weight (240 x 512, 245,760
// bytes) does not fit in a block's 227 KB beside one frame's conv1
// activation (130 x 512 bf16, 133 KB), so unlike the int8 stages it is not
// resident: it streams through two shared-memory buffers in K slices of 64
// channels (30 KB each, cp.async from L2), the next slice in flight while
// the current one is multiplied. The slice sequence repeats every frame, so
// the first two slices of the next frame load while its conv1 runs. One
// persistent block of 8 warps per SM walks the frames. conv1 is scalar f32
// (each thread two channels, all 126 rows, its 8 weights in registers),
// from the frame (v4, bf16) or its tap rows (v2) staged in shared memory;
// conv2 is bf16 mma.sync.m16n8k16 with f32 sums, each warp 32 rows x 40
// channels, tap k's A fragments read rows t+k so the shift-add happens in
// the accumulator, as in the int8 stages.
#include <cuda_bf16.h>

#include "conv_stage_int8_mma.cuh"

namespace {

// How conv1's input arrives (the kernel's template parameter).
constexpr int IN_FRAME_BF16 = 0;          // v4: f32 frames, rounded to bf16 here
constexpr int IN_TAP_ROWS = 1;            // v2: bf16 tap rows, the bias on lane 6
constexpr int IN_FRAME_F32 = 2;           // bf16: f32 frames and f32 conv1 weights

constexpr int T1 = T - 2;                 // conv1 rows (126)
constexpr int KS = 64;                    // conv2 K slice (channels)
constexpr int NS = K1 / KS;               // slices per frame
constexpr int A1B_STRIDE = K1 + 8;        // bf16 per a1 row (260 words)
constexpr int WSB_STRIDE = KS + 8;        // bf16 per weight-slice row (36 words)
constexpr int XS_STRIDE = T + 4;          // floats per staged input row (frames)
constexpr int A1B_BYTES = A1_ROWS * A1B_STRIDE * 2;
constexpr int WSB_BYTES = N2 * WSB_STRIDE * 2;
constexpr int XS_BYTES = 2 * XS_STRIDE * 4;          // a frame's two planes
constexpr int ROWS_BYTES = T1 * 8 * 4;               // a frame's tap rows
static_assert(A1B_BYTES + 2 * WSB_BYTES + ROWS_BYTES <= 232448,
              "fits the 227 KB a block may have");
static_assert(NS % 2 == 0, "slice s always lands in buffer s % 2");
static_assert(A1B_BYTES % 16 == 0 && WSB_BYTES % 16 == 0, "16-byte regions");
static_assert(THREADS == 2 * T && THREADS * 2 == K1, "thread mappings");
static_assert(T1 * 4 <= 2 * THREADS, "a frame's rows in two words per thread");

template <int IN>
constexpr int smem_bytes() {
  return A1B_BYTES + 2 * WSB_BYTES + (IN == IN_TAP_ROWS ? ROWS_BYTES : XS_BYTES);
}

// D += A . B, bf16 in, f32 sums, 16 x 8 x 16.
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

// Issue the cp.async copies of K slice s of w2t (240, 512) into buf: row n
// of the slice is w2t[n, s*64 .. s*64+63], 128 bytes, 8 copies of 16.
__device__ __forceinline__ void load_slice(const __nv_bfloat16* __restrict__ w2t,
                                           __nv_bfloat16* buf, int s) {
  for (int i = threadIdx.x; i < N2 * (KS / 8); i += THREADS) {
    const int n = i / (KS / 8), q = i % (KS / 8);
    cp_async16(buf + n * WSB_STRIDE + q * 8, w2t + n * K1 + s * KS + q * 8);
  }
  cp_async_commit();
}

// in: frames (B, 2, 128) f32 or tap rows (B, 126, 8) bf16, by IN. w1: w1e
// (8, 512) bf16, or w1p (3, 256) f32 with b1d (512,) f32, conv1's bias
// duplicated over the planes, for IN_FRAME_F32 (b1d unused otherwise).
template <int IN>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_bf16_kernel(const void* __restrict__ in, long long n,
                       const void* __restrict__ w1, const float* __restrict__ b1d,
                       const __nv_bfloat16* __restrict__ w2t,
                       const float* __restrict__ b2,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a1s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem + A1B_BYTES);
  float* xs = reinterpret_cast<float*>(smem + A1B_BYTES + 2 * WSB_BYTES);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  const int r2 = (warp & 3) * (MT * 16), cg = (warp >> 2) * NT;

  load_slice(w2t, wbuf, 0);
  load_slice(w2t, wbuf + N2 * WSB_STRIDE, 1);
  // Rows 126..129 of a1 feed only the dropped output rows: zero once.
  for (int i = tid; i < 4 * A1B_STRIDE; i += THREADS)
    a1s[T1 * A1B_STRIDE + i] = __float2bfloat16_rn(0.0f);
  // conv1: this thread's channels n1, n1+1 of plane h, their 3 taps and
  // bias (as f32).
  const int n1 = 2 * tid, h = n1 / (K1 / 2);
  float w1r[4][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if constexpr (IN == IN_FRAME_F32) {
      const float* w1p = static_cast<const float*>(w1);
#pragma unroll
      for (int k = 0; k < 3; ++k) w1r[k][e] = w1p[k * (K1 / 2) + n1 % (K1 / 2) + e];
      w1r[3][e] = b1d[n1 + e];
    } else {
      const __nv_bfloat16* w1e = static_cast<const __nv_bfloat16*>(w1);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        w1r[k][e] = __bfloat162float(w1e[(3 * h + k) * K1 + n1 + e]);
      w1r[3][e] = __bfloat162float(w1e[6 * K1 + n1 + e]);
    }
  }
  float bias[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[j][e] = b2[(cg + j) * 8 + 2 * tig + e];

  for (long long f = blockIdx.x; f < n; f += gridDim.x) {
    if constexpr (IN == IN_TAP_ROWS) {
      // The frame's 126 x 8 bf16 rows as floats, two per word.
      const __nv_bfloat162* xe =
          static_cast<const __nv_bfloat162*>(in) + f * (T1 * 4);
      for (int i = tid; i < T1 * 4; i += THREADS) {
        const float2 v = __bfloat1622float2(xe[i]);
        xs[2 * i] = v.x;
        xs[2 * i + 1] = v.y;
      }
    } else {
      const float v = static_cast<const float*>(in)[f * 2 * T + tid];
      xs[(tid / T) * XS_STRIDE + tid % T] =
          IN == IN_FRAME_BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
    }
    __syncthreads();
    const float* xh = xs + h * XS_STRIDE;
    for (int t = 0; t < T1; ++t) {
      float x0, x1, x2, x6 = 1.0f;
      if constexpr (IN == IN_TAP_ROWS) {
        const float* row = xs + t * 8;
        x0 = row[3 * h], x1 = row[3 * h + 1], x2 = row[3 * h + 2], x6 = row[6];
      } else {
        x0 = xh[t], x1 = xh[t + 1], x2 = xh[t + 2];
      }
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float acc = __fmul_rn(x0, w1r[0][e]);
        acc = __fadd_rn(acc, __fmul_rn(x1, w1r[1][e]));
        acc = __fadd_rn(acc, __fmul_rn(x2, w1r[2][e]));
        const float b = IN == IN_TAP_ROWS ? __fmul_rn(x6, w1r[3][e]) : w1r[3][e];
        v[e] = fmaxf(__fadd_rn(acc, b), 0.0f);
      }
      *reinterpret_cast<__nv_bfloat162*>(a1s + t * A1B_STRIDE + n1) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
    __syncthreads();

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      cp_async_wait<1>();   // this thread's copies of slice s have landed
      __syncthreads();      // and everyone's
      const __nv_bfloat16* ws = wbuf + (s & 1) * N2 * WSB_STRIDE;
#pragma unroll 1
      for (int k = 0; k < 3; ++k) {
        const __nv_bfloat16* arow = a1s + (r2 + k + g) * A1B_STRIDE + s * KS + 2 * tig;
        const __nv_bfloat16* brow = ws + (k * C2 + cg * 8 + g) * WSB_STRIDE + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const __nv_bfloat16* p = arow + i * 16 * A1B_STRIDE + kk;
            a[i][0] = lds32(p);
            a[i][1] = lds32(p + 8 * A1B_STRIDE);
            a[i][2] = lds32(p + 8);
            a[i][3] = lds32(p + 8 * A1B_STRIDE + 8);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const __nv_bfloat16* p = brow + j * 8 * WSB_STRIDE + kk;
            const uint32_t b0 = lds32(p), b1 = lds32(p + 8);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
          }
        }
      }
      __syncthreads();      // every warp is done with buffer s % 2
      load_slice(w2t, wbuf + (s & 1) * N2 * WSB_STRIDE, (s + 2) % NS);
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = r2 + i * 16 + g + half * 8;
        if (t >= T2) continue;
        __nv_bfloat16* o = out + (f * T2 + t) * C2 + cg * 8 + 2 * tig;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float v0 = fmaxf(__fadd_rn(acc[i][j][2 * half], bias[j][0]), 0.0f);
          const float v1 = fmaxf(__fadd_rn(acc[i][j][2 * half + 1], bias[j][1]), 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    // The next frame's input may overwrite xs at once (conv1 read it before
    // the __syncthreads after conv1), and its conv1 rewrites a1s only after
    // the __syncthreads closing slice NS-1, when every warp has left conv2.
  }
  cp_async_wait<0>();       // no copy may land after the block has left
}

template <int IN>
int launch(const void* in, long long n, const void* w1, const void* b1,
           const void* w2t, const void* b2, void* out, void* stream) {
  return launch_persistent(
      conv_stage_bf16_kernel<IN>, smem_bytes<IN>(), n, stream, in, n, w1,
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2t),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out));
}

}  // namespace

extern "C" int amc_conv_stage_bf16_v4(const void* x, long long n, const void* w1e,
                                      const void* w2t, const void* b2, void* out,
                                      void* stream) {
  return launch<IN_FRAME_BF16>(x, n, w1e, nullptr, w2t, b2, out, stream);
}

extern "C" int amc_conv_stage_bf16_v2(const void* xe, long long n, const void* w1e,
                                      const void* w2t, const void* b2, void* out,
                                      void* stream) {
  return launch<IN_TAP_ROWS>(xe, n, w1e, nullptr, w2t, b2, out, stream);
}

extern "C" int amc_conv_stage_bf16(const void* x, long long n, const void* w1p,
                                   const void* b1, const void* w2t, const void* b2,
                                   void* out, void* stream) {
  return launch<IN_FRAME_F32>(x, n, w1p, b1, w2t, b2, out, stream);
}
