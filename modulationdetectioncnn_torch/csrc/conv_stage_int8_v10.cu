// Fused int8 conv stage with a folded bf16 conv1 and a tensor-core conv2,
// for Hopper (sm_90a). One templated body, two C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v9_kernel
//   (ops/infer.py:1103, reached by pl.pallas_call in make_int8_classifier_v9
//   and make_conv_stage) with amc_conv_stage_int8_v9, and
// Replaces: modulationdetectioncnn_tpu/ops/infer.py::_conv_stage_int8_v10_kernel
//   (ops/infer.py:1247, make_int8_classifier_v10 and make_conv_stage) with
//   amc_conv_stage_int8_v10.
//
// Computes, per frame of x (B, 2, 128) f32:
//   xq   = clip(round_half_even(x * inv_sx), -127, 127)
//   A[t] = [xq_I(t), xq_Q(t), xq_I(t+1), xq_Q(t+1), xq_I(t+2), xq_Q(t+2), 1, 0..0]
//          (16 bf16 lanes, exact since |xq| <= 127; taps past the frame are 0)
//   f    = A . w1f, (128 x 16) . (16 x 512), bf16 mma.sync with f32 sums
//   a1   = (int8) trunc(clip(f, 0, 127))                         (128, 512)
//   s[t, co] = sum_k sum_j a1[t+k, j] * w2l[j, k*80 + co]          t < 124
//   out  = clip((s + o2) >> m2, 0, 127)                        (124, 80) int8
// w1f is conv1 with its requantize folded in (quant.py::fold_conv1_weights):
// every product and partial sum is an integer multiple of 2^-shift1, less
// than 2^24 such units in magnitude, so the f32 sum is exact in any order
// and a1 equals the integer spec clip((acc + o1) >> m1, 0, 127), provided
// the tensor core neither drops bits inside a 24-bit window nor flushes
// small terms.
// chip_smoke.py checks that on the card: 0 mismatches over the whole map.
//
// Bound on the H100 SXM at B = 4096, that of the function (v7 computes the
// same map): conv1 2*B*126*3*512 ~ 1.6 G plus conv2 2*B*124*80*1536
// ~ 124.8 G int8 ops (63.9 us at 1,979 TOP/s), against ~45 MB moved (x
// 4.2 MB in, the map 40.6 MB out; ~13.4 us at 3.35 TB/s): operation-bound,
// ~64 us. The folded conv1's padded bf16 lanes are this design's cost, not
// the function's, and are not counted.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work): one persistent block of 8 warps per SM keeps conv2's weight
// in shared memory for all the frames it walks; the (130, 512) int8 a1 tile
// (rows 128, 129 zero) never leaves shared memory. conv1 is the folded
// bf16 product; conv2, with its shift-add in the accumulator, and rq2 are
// the arithmetic of conv_stage_int8_mma.cuh's conv2_rq2_store, written out
// in this kernel's body: called from the header, nvcc schedules this
// kernel otherwise (fewer registers) and the bench's cnn rate with v10
// read lower beyond the run-to-run spread (PERF.md). The widths, the
// helpers and the launch come from the header. Only wgmma reaches Hopper's
// full int8 rate; with mma.sync fed by 32-bit shared loads this kernel
// stays well above the bound.
// v10 (PREFETCH) copies the next frame's input into a second buffer with
// cp.async while the current frame's products run, as the TPU kernel's
// 2-deep pipelining overlapped the next chunk's input; v9 loads each frame
// in turn.
#include <cuda_bf16.h>

#include "conv_stage_int8_mma.cuh"

namespace {

constexpr int W1F_BYTES = K1 * 8 * 2;       // [n][8] bf16
constexpr int XS_BYTES = 2 * 2 * T * 4;     // two frames of f32
constexpr int SMEM_BYTES = W2S_BYTES + A1S_BYTES + W1F_BYTES + XS_BYTES;
static_assert(W1F_BYTES % 16 == 0, "smem regions 16-byte aligned");
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");

// xq of one sample, as exact bf16 bits: rint of a separately rounded
// multiply (round half to even, as the reference's jnp.round).
__device__ __forceinline__ uint32_t qbits(float v, float inv_sx) {
  float q = fminf(fmaxf(rintf(__fmul_rn(v, inv_sx)), -127.0f), 127.0f);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(q)));
}

// A fragment register of the folded conv1 for row t: K lanes 2*tig and
// 2*tig+1 are tap tig's (I, Q) for tig < 3, the bias lane (1.0, 0) for
// tig == 3. A tap past the frame end is 0.
__device__ __forceinline__ uint32_t conv1_a(const float* xc, int t, int tig,
                                            float inv_sx) {
  if (tig == 3) return 0x3F80u;  // bf16 1.0 in the low half, 0 above
  const int tt = t + tig;
  if (tt >= T) return 0u;
  return qbits(xc[tt], inv_sx) | (qbits(xc[T + tt], inv_sx) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t b0) {
  // K lanes 8..15 of A and B are zero: A registers 2, 3 and B register 1.
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

template <bool PREFETCH>
__global__ void __launch_bounds__(THREADS, 1)
conv_stage_folded_kernel(const float* __restrict__ x, long long n,
                         const __nv_bfloat16* __restrict__ w1f,
                         const int8_t* __restrict__ w2l,
                         const int* __restrict__ m2,
                         const int* __restrict__ o2, float inv_sx,
                         int8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w2s = reinterpret_cast<int8_t*>(smem);
  int8_t* a1s = reinterpret_cast<int8_t*>(smem + W2S_BYTES);
  uint32_t* w1s = reinterpret_cast<uint32_t*>(smem + W2S_BYTES + A1S_BYTES);
  float* xs = reinterpret_cast<float*>(smem + W2S_BYTES + A1S_BYTES + W1F_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // Once per block: conv2's weight transposed to [n][j], conv1's folded
  // weight to [n][kk] as bf16 pairs, a1 rows 128 and 129 zeroed.
  for (int i = tid; i < K1 * N2; i += THREADS) {
    const int j = i / N2, c = i % N2;
    w2s[c * STRIDE + j] = w2l[i];
  }
  const unsigned short* w1b = reinterpret_cast<const unsigned short*>(w1f);
  for (int i = tid; i < K1 * 4; i += THREADS) {
    const int c = i / 4, p = i % 4;
    w1s[i] = static_cast<uint32_t>(w1b[(2 * p) * K1 + c]) |
             (static_cast<uint32_t>(w1b[(2 * p + 1) * K1 + c]) << 16);
  }
  for (int i = tid; i < 2 * STRIDE; i += THREADS) a1s[T * STRIDE + i] = 0;

  // conv2 tiling: rows r2 .. r2+31, channel groups cg .. cg+4 (8 each).
  const int r2 = (warp & 3) * (MT * 16), cg = (warp >> 2) * NT;
  int sh2[NT][2], off2[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = (cg + j) * 8 + 2 * tig + e;
      sh2[j][e] = m2[co];
      off2[j][e] = o2[co];
    }

  long long f = blockIdx.x;
  int buf = 0;
  if (PREFETCH && f < n && tid < 2 * T / 4)
    cp_async16(xs + 4 * tid, x + f * 2 * T + 4 * tid);
  if (PREFETCH) cp_async_commit();
  __syncthreads();

  for (; f < n; f += gridDim.x) {
    float* xc = xs + buf * 2 * T;
    if (PREFETCH) {
      // Start the next frame's copy into the other buffer, then wait for
      // this frame's (the older group).
      const long long fn = f + gridDim.x;
      if (fn < n && tid < 2 * T / 4)
        cp_async16(xs + (buf ^ 1) * 2 * T + 4 * tid, x + fn * 2 * T + 4 * tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      xc[tid] = x[f * 2 * T + tid];  // THREADS == 2 * T
    }
    __syncthreads();

    // conv1: warp w owns rows 16w .. 16w+15 and all 512 columns.
    {
      const int r0 = warp * 16;
      const uint32_t a0 = conv1_a(xc, r0 + g, tig, inv_sx);
      const uint32_t a1 = conv1_a(xc, r0 + g + 8, tig, inv_sx);
      int8_t* row0 = a1s + (r0 + g) * STRIDE + 2 * tig;
      int8_t* row1 = row0 + 8 * STRIDE;
#pragma unroll 4
      for (int nt = 0; nt < K1 / 8; ++nt) {
        float d[4];
        mma_bf16(d, a0, a1, w1s[(nt * 8 + g) * 4 + tig]);
        int v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = __float2int_rz(fminf(fmaxf(d[e], 0.0f), 127.0f));  // trunc
        *reinterpret_cast<uint16_t*>(row0 + nt * 8) =
            static_cast<uint16_t>(v[0] | (v[1] << 8));
        *reinterpret_cast<uint16_t*>(row1 + nt * 8) =
            static_cast<uint16_t>(v[2] | (v[3] << 8));
      }
    }
    __syncthreads();

    // conv2 with the shift-add in the accumulator: tap k reads rows t+k.
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll 1
    for (int k = 0; k < 3; ++k) {
      const int8_t* arow = a1s + (r2 + k + g) * STRIDE + 4 * tig;
      const int8_t* brow = w2s + (k * C2 + cg * 8 + g) * STRIDE + 4 * tig;
#pragma unroll 2
      for (int kb = 0; kb < K1; kb += 32) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int8_t* p = arow + i * 16 * STRIDE + kb;
          a[i][0] = lds32(p);
          a[i][1] = lds32(p + 8 * STRIDE);
          a[i][2] = lds32(p + 16);
          a[i][3] = lds32(p + 8 * STRIDE + 16);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* p = brow + j * 8 * STRIDE + kb;
          const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
        }
      }
    }

    // rq2 and the compact (124, 80) map; rows 124..127 are dropped.
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = r2 + i * 16 + g + half * 8;
        if (t >= T2) continue;
        int8_t* o = out + (f * T2 + t) * C2 + cg * 8 + 2 * tig;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int v0 = requant(acc[i][j][2 * half], off2[j][0], sh2[j][0]);
          const int v1 = requant(acc[i][j][2 * half + 1], off2[j][1], sh2[j][1]);
          *reinterpret_cast<uint16_t*>(o + j * 8) =
              static_cast<uint16_t>(v0 | (v1 << 8));
        }
      }
    }
    if (PREFETCH) buf ^= 1;
    // The next frame's first __syncthreads keeps its conv1 from
    // overwriting a1s while this frame's conv2 still reads it.
  }
  if (PREFETCH) cp_async_wait<0>();
}

template <bool PREFETCH>
int launch(const void* x, long long n, const void* w1f, const void* w2l,
           const void* m2, const void* o2, float inv_sx, void* out,
           void* stream) {
  return launch_persistent(
      conv_stage_folded_kernel<PREFETCH>, SMEM_BYTES, n, stream,
      static_cast<const float*>(x), n, static_cast<const __nv_bfloat16*>(w1f),
      static_cast<const int8_t*>(w2l), static_cast<const int*>(m2),
      static_cast<const int*>(o2), inv_sx, static_cast<int8_t*>(out));
}

}  // namespace

extern "C" int amc_conv_stage_int8_v9(const void* x, long long n,
                                      const void* w1f, const void* w2l,
                                      const void* m2, const void* o2,
                                      float inv_sx, void* out, void* stream) {
  return launch<false>(x, n, w1f, w2l, m2, o2, inv_sx, out, stream);
}

extern "C" int amc_conv_stage_int8_v10(const void* x, long long n,
                                       const void* w1f, const void* w2l,
                                       const void* m2, const void* o2,
                                       float inv_sx, void* out, void* stream) {
  return launch<true>(x, n, w1f, w2l, m2, o2, inv_sx, out, stream);
}
