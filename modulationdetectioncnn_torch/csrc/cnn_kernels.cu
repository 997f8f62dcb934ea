// The stand-alone conv kernels of the VT-CNN2 topology, for Hopper (sm_90a),
// at widths given at run time (any B, T, C, Cin, Co). Four C entry points:
//
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv1_kernel
//   (ops/cnn_kernels.py:78, reached by pl.pallas_call in conv1_stacked,
//   ops/cnn_kernels.py:111) with amc_conv1_stacked,
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv2_kernel
//   (:129, conv2_stacked, :165) with amc_conv2_stacked,
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv1_int8_kernel
//   (:223, conv1_stacked_int8, :249) with amc_conv1_stacked_int8, and
// Replaces: modulationdetectioncnn_tpu/ops/cnn_kernels.py::_conv2_int8_kernel
//   (:268, conv2_stacked_int8, :300) with amc_conv2_stacked_int8.
//
// Computes (channel n = h*C + c of the stacked layout, t_out = t_in - 2):
//   conv1   x (B, 2, T) f32, w1p (3, C) f32, b1 (C,) f32 -> (B, T-2, 2C) bf16|f32
//           out[b,t,n] = out_t(relu((((0 + x[b,h,t]*w1p[0,c]) + x[b,h,t+1]*w1p[1,c])
//                                    + x[b,h,t+2]*w1p[2,c]) + b1[c]))
//           each product and sum rounded on its own (__fmul_rn, __fadd_rn),
//           in conv1_accumulate's order, so the plain version equals it bit
//           for bit;
//   conv1 int8  x (B, 2, T) int8, w1p (3, C) int8, m/o (2C,) int32
//           out[b,t,n] = clip((acc + o[n]) >> m[n], 0, 127), acc the exact
//           int32 sum of the same three products;
//   conv2   a1s (B, t_in, K) bf16 or f32, w2p (K, 3Co) of the same type,
//           b2 (Co,) f32 -> (B, t_out, Co) bf16|f32
//           out[b,t,co] = out_t(relu(sum_k sum_j a1s[b,t+k,j] * w2p[j,k*Co+co]
//                                    + b2[co]))
//           bf16: tensor cores (mma.sync m16n8k16, f32 sums); f32: FMAs on
//           the CUDA cores (no TF32). The TPU kernel built z = a1s . w2p in
//           VMEM and shift-added its lanes (z0[t] + z1[t+1] + z2[t+2]); here
//           tap k's A rows are t+k, so the shift-add happens in the
//           accumulator and z is never stored: the sums differ from the plain
//           version's only in their order;
//   conv2 int8  a1s (B, t_in, K) int8, w2p (K, 3Co) int8, m/o (Co,) int32
//           -> (B, t_out, Co) int8, the same sum exact in int32
//           (mma.sync m16n8k32), then the requantize of conv1 int8.
//
// Bound on the H100 SXM at B = 4096, T = 128, C = 256, Co = 80 (inputs read
// once, outputs written once; chip_smoke.py recomputes it from each run's
// tensors): conv1 writes 528.5 MB bf16 (0.159 ms at 3.35 TB/s; 1.06 GB, 0.317
// ms, in f32) for 1.6 GFLOP; conv1 int8 265 MB (0.079 ms); conv2 bf16 reads
// 528.5 MB and writes 81 MB (0.182 ms) for 124.8 GFLOP (0.126 ms at 989
// TFLOP/s): all four bound by bytes, except conv2 f32, whose 124.8 GFLOP on
// the CUDA cores (67 TFLOP/s) take 1.86 ms.
//
// Design (simple and right first). conv1: one warp per output row (b, t),
// lanes over channel pairs, so a warp writes 128 contiguous bytes per step
// and the row's six inputs are read once; the pair of two channels is one
// 4-byte (bf16), 8-byte (f32) or 2-byte (int8) store, aligned because 2C is
// even. conv2: one block of 8 warps per (frame, 128 output rows, 80
// channels) tile. K is walked in 64-byte chunks: the tile's 130 input rows
// and the chunk of all three taps' weights, transposed to [k*80 + co][j],
// are staged in shared memory (16-byte loads when the rows allow it, else
// bytes), zero-filled past T, K and Co, so any width fits the tensor-core
// tiles. The weight is read again for every tile, from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C1_WARPS = 8;                  // conv1: rows per block
constexpr int THREADS = 256;                 // 8 warps
constexpr int BM = 128;                      // conv2: output rows per tile
constexpr int A_ROWS = BM + 2;               // input rows a tile reads
constexpr int BN = 80;                       // conv2: channels per tile
constexpr int NB = 3 * BN;                   // weight columns per tile
constexpr int KCB = 64;                      // K chunk, bytes
constexpr int SROW = KCB + 16;               // padded smem row (20 words)
constexpr int NT = BN / 8;                   // mma n-fragments per warp
static_assert(BM == 8 * 16, "conv2: one 16-row m-tile per warp");
static_assert(SROW % 16 == 0, "16-byte staging stores");

enum Mode { BF16_MMA = 0, INT8_MMA = 1, F32_FMA = 2 };

__device__ __forceinline__ int requant(int acc, int offset, int shift) {
  const int v = (acc + offset) >> shift;   // arithmetic shift on signed int32
  return min(max(v, 0), 127);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }

// ------------------------------------------------------------------ conv1

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
conv1_f32_kernel(const float* __restrict__ x, long long rows, int t_in, int c,
                 const float* __restrict__ w1p, const float* __restrict__ b1,
                 OutT* __restrict__ out) {
  const int t_out = t_in - 2, lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * C1_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const long long b = r / t_out;
  const int t = static_cast<int>(r - b * t_out);
  const float* xr = x + b * 2 * t_in + t;
  float xv[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k) xv[h][k] = xr[h * t_in + k];
  OutT* o = out + r * 2 * c;
  for (int q = lane; q < c; q += 32) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * q + e, h = n >= c, cc = n - h * c;
      // Select the plane's inputs, not index by h: keeps xv in registers.
      const float x0 = h ? xv[1][0] : xv[0][0], x1 = h ? xv[1][1] : xv[0][1],
                  x2 = h ? xv[1][2] : xv[0][2];
      float acc = 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(x0, w1p[cc]));
      acc = __fadd_rn(acc, __fmul_rn(x1, w1p[c + cc]));
      acc = __fadd_rn(acc, __fmul_rn(x2, w1p[2 * c + cc]));
      v[e] = fmaxf(__fadd_rn(acc, b1[cc]), 0.0f);
    }
    store2(o + 2 * q, v[0], v[1]);
  }
}

__global__ void __launch_bounds__(THREADS)
conv1_int8_kernel(const int8_t* __restrict__ x, long long rows, int t_in, int c,
                  const int8_t* __restrict__ w1p, const int* __restrict__ m,
                  const int* __restrict__ o, int8_t* __restrict__ out) {
  const int t_out = t_in - 2, lane = threadIdx.x % 32;
  const long long r = static_cast<long long>(blockIdx.x) * C1_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const long long b = r / t_out;
  const int t = static_cast<int>(r - b * t_out);
  const int8_t* xr = x + b * 2 * t_in + t;
  int xv[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k) xv[h][k] = xr[h * t_in + k];
  int8_t* orow = out + r * 2 * c;
  for (int q = lane; q < c; q += 32) {
    int v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * q + e, h = n >= c, cc = n - h * c;
      const int x0 = h ? xv[1][0] : xv[0][0], x1 = h ? xv[1][1] : xv[0][1],
                x2 = h ? xv[1][2] : xv[0][2];
      const int acc = x0 * w1p[cc] + x1 * w1p[c + cc] + x2 * w1p[2 * c + cc];
      v[e] = requant(acc, o[n], m[n]);
    }
    *reinterpret_cast<uint16_t*>(orow + 2 * q) =
        static_cast<uint16_t>(v[0] | (v[1] << 8));
  }
}

// ------------------------------------------------------------------ conv2

// D += A . B, bf16 in, f32 sums, 16 x 8 x 16 (c: the fragment's 4 sums).
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B, int8 in, int32 sums, 16 x 8 x 32.
__device__ __forceinline__ void mma(int* c, const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage bytes [kc, kc + KCB) of the tile's A_ROWS input rows (row t0 + i of
// frame `a`, row_bytes each, t_in rows) into as[i][0..KCB), zeros past the
// frame's rows and the row's bytes. vec: row_bytes and the base are
// multiples of 16, so every 16-byte piece is whole or wholly past the end.
__device__ __forceinline__ void stage_a(const uint8_t* __restrict__ a, int t0,
                                        int t_in, int row_bytes, int kc, int vec,
                                        uint8_t* as) {
  if (vec) {
    for (int i = threadIdx.x; i < A_ROWS * (KCB / 16); i += THREADS) {
      const int row = i / (KCB / 16), q = i % (KCB / 16);
      const int t = t0 + row, byte = kc + q * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t < t_in && byte < row_bytes)
        v = *reinterpret_cast<const uint4*>(a + static_cast<long long>(t) * row_bytes + byte);
      *reinterpret_cast<uint4*>(as + row * SROW + q * 16) = v;
    }
  } else {
    for (int i = threadIdx.x; i < A_ROWS * KCB; i += THREADS) {
      const int row = i / KCB, q = i % KCB;
      const int t = t0 + row, byte = kc + q;
      as[row * SROW + q] = (t < t_in && byte < row_bytes)
                               ? a[static_cast<long long>(t) * row_bytes + byte] : 0;
    }
  }
}

// Stage elements [kc/ES, (kc + KCB)/ES) of the tile's weight columns,
// transposed: ws[k*BN + n][j bytes] = w2p[j, k*co + co0 + n], zeros past K
// and Co. Consecutive threads read consecutive columns of a w2p row.
template <int ES>
__device__ __forceinline__ void stage_w(const uint8_t* __restrict__ w2p, int k_in,
                                        int co, int co0, int kc, uint8_t* ws) {
  constexpr int PER = KCB / ES;             // elements per row per chunk
  for (int i = threadIdx.x; i < NB * PER; i += THREADS) {
    const int jj = i / NB, kn = i % NB, k = kn / BN, n = kn % BN;
    const int j = kc / ES + jj, col = co0 + n;
    uint8_t* dst = ws + kn * SROW + jj * ES;
    const bool ok = j < k_in && col < co;
    const uint8_t* src = w2p + (static_cast<long long>(j) * 3 * co + k * co + col) * ES;
    if constexpr (ES == 1) {
      *dst = ok ? *src : 0;
    } else if constexpr (ES == 2) {
      *reinterpret_cast<uint16_t*>(dst) = ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
    } else {
      *reinterpret_cast<uint32_t*>(dst) = ok ? *reinterpret_cast<const uint32_t*>(src) : 0;
    }
  }
}

// a: (B, t_in, k_in) of the mode's type; w2p: (k_in, 3*co); b2: (co,) f32
// (float modes); m2, o2: (co,) int32 (INT8_MMA); out: (B, t_in-2, co).
// Grid: x = frame * row_tiles + row tile, y = channel tile.
template <int MODE, typename OutT>
__global__ void __launch_bounds__(THREADS)
conv2_kernel(const uint8_t* __restrict__ a, int row_tiles, int t_in, int k_in,
             int co, const uint8_t* __restrict__ w2p, const float* __restrict__ b2,
             const int* __restrict__ m2, const int* __restrict__ o2, int vec,
             OutT* __restrict__ out) {
  constexpr int ES = MODE == BF16_MMA ? 2 : MODE == INT8_MMA ? 1 : 4;
  __shared__ __align__(16) uint8_t as[A_ROWS * SROW];
  __shared__ __align__(16) uint8_t ws[NB * SROW];
  const int t_out = t_in - 2, row_bytes = k_in * ES;
  const long long f = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * BM, co0 = blockIdx.y * BN;
  const uint8_t* af = a + f * static_cast<long long>(t_in) * row_bytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates

  // Tensor cores: warp w owns tile rows 16w..16w+15 and all BN channels.
  // CUDA cores (f32): thread (tr, tc) owns rows 8tr..8tr+7, channels
  // 5tc..5tc+4.
  constexpr int ACC = MODE == F32_FMA ? 8 * 5 : NT * 4;
  using Acc = typename std::conditional<MODE == INT8_MMA, int, float>::type;
  Acc acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  const int tr = tid / 16, tc = tid % 16;

  for (int kc = 0; kc < row_bytes; kc += KCB) {
    __syncthreads();                         // the previous chunk is consumed
    stage_a(af, t0, t_in, row_bytes, kc, vec, as);
    stage_w<ES>(w2p, k_in, co, co0, kc, ws);
    __syncthreads();
    if constexpr (MODE == F32_FMA) {
#pragma unroll 1
      for (int jj = 0; jj < KCB / 4; ++jj) {
        float av[10];
#pragma unroll
        for (int r = 0; r < 10; ++r)
          av[r] = *reinterpret_cast<const float*>(as + (8 * tr + r) * SROW + 4 * jj);
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int cc = 0; cc < 5; ++cc) {
            const float w = *reinterpret_cast<const float*>(
                ws + (k * BN + 5 * tc + cc) * SROW + 4 * jj);
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r * 5 + cc] = fmaf(av[r + k], w, acc[r * 5 + cc]);
          }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint8_t* arow = as + (warp * 16 + k + g) * SROW + 4 * tig;
        const uint8_t* brow = ws + (k * BN + g) * SROW + 4 * tig;
#pragma unroll
        for (int kb = 0; kb < KCB; kb += 32) {
          const uint32_t af4[4] = {lds32(arow + kb), lds32(arow + 8 * SROW + kb),
                                   lds32(arow + kb + 16), lds32(arow + 8 * SROW + kb + 16)};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint8_t* p = brow + j * 8 * SROW + kb;
            mma(acc + 4 * j, af4, lds32(p), lds32(p + 16));   // bf16 or int8 by Acc
          }
        }
      }
    }
  }

  OutT* of = out + f * static_cast<long long>(t_out) * co;
  if constexpr (MODE == F32_FMA) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = t0 + 8 * tr + r;
      if (t >= t_out) continue;
#pragma unroll
      for (int cc = 0; cc < 5; ++cc) {
        const int ch = co0 + 5 * tc + cc;
        if (ch < co)
          store1(of + static_cast<long long>(t) * co + ch,
                 fmaxf(__fadd_rn(acc[r * 5 + cc], b2[ch]), 0.0f));
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + warp * 16 + g + half * 8;
      if (t >= t_out) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = co0 + j * 8 + 2 * tig + e;
          if (ch >= co) continue;
          const Acc v = acc[4 * j + 2 * half + e];
          OutT* dst = of + static_cast<long long>(t) * co + ch;
          if constexpr (MODE == INT8_MMA) {
            *dst = static_cast<int8_t>(requant(v, o2[ch], m2[ch]));
          } else {
            store1(dst, fmaxf(__fadd_rn(v, b2[ch]), 0.0f));
          }
        }
    }
  }
}

template <int MODE, typename OutT>
int launch_conv2(const void* a, long long b, int t_in, int k_in, int co,
                 const void* w2p, const float* b2, const int* m2, const int* o2,
                 int vec, void* out, void* stream) {
  const int t_out = t_in - 2;
  const int row_tiles = (t_out + BM - 1) / BM;
  const long long bx = b * row_tiles;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(bx), (co + BN - 1) / BN);
  conv2_kernel<MODE, OutT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), row_tiles, t_in, k_in, co,
      static_cast<const uint8_t*>(w2p), b2, m2, o2, vec, static_cast<OutT*>(out));
  return static_cast<int>(cudaGetLastError());
}

long long conv1_blocks(long long b, int t_in) {
  return (b * (t_in - 2) + C1_WARPS - 1) / C1_WARPS;
}

}  // namespace

// x (B, 2, t_in) f32, w1p (3, c) f32, b1 (c,) f32 -> out (B, t_in-2, 2c),
// bf16 when out_f32 is 0, else f32.
extern "C" int amc_conv1_stacked(const void* x, long long b, int t_in, int c,
                                 const void* w1p, const void* b1, int out_f32,
                                 void* out, void* stream) {
  const long long blocks = conv1_blocks(b, t_in);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(w1p);
  const auto* bias = static_cast<const float*>(b1);
  if (out_f32)
    conv1_f32_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        xf, b * (t_in - 2), t_in, c, w, bias, static_cast<float*>(out));
  else
    conv1_f32_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        xf, b * (t_in - 2), t_in, c, w, bias, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x (B, 2, t_in) int8, w1p (3, c) int8, m, o (2c,) int32 -> (B, t_in-2, 2c) int8.
extern "C" int amc_conv1_stacked_int8(const void* x, long long b, int t_in, int c,
                                      const void* w1p, const void* m, const void* o,
                                      void* out, void* stream) {
  const long long blocks = conv1_blocks(b, t_in);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  conv1_int8_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), b * (t_in - 2), t_in, c,
      static_cast<const int8_t*>(w1p), static_cast<const int*>(m),
      static_cast<const int*>(o), static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a1s (B, t_in, k_in) and w2p (k_in, 3co), both bf16 (in_f32 0) or both f32
// (in_f32 1); b2 (co,) f32 -> (B, t_in-2, co), bf16 (out_f32 0) or f32.
// vec: k_in * element size and a1s's address are multiples of 16.
extern "C" int amc_conv2_stacked(const void* a1s, long long b, int t_in, int k_in,
                                 int co, const void* w2p, const void* b2, int in_f32,
                                 int out_f32, int vec, void* out, void* stream) {
  const auto* bias = static_cast<const float*>(b2);
  if (in_f32)
    return out_f32 ? launch_conv2<F32_FMA, float>(a1s, b, t_in, k_in, co, w2p, bias,
                                                  nullptr, nullptr, vec, out, stream)
                   : launch_conv2<F32_FMA, __nv_bfloat16>(a1s, b, t_in, k_in, co, w2p,
                                                          bias, nullptr, nullptr, vec,
                                                          out, stream);
  return out_f32 ? launch_conv2<BF16_MMA, float>(a1s, b, t_in, k_in, co, w2p, bias,
                                                 nullptr, nullptr, vec, out, stream)
                 : launch_conv2<BF16_MMA, __nv_bfloat16>(a1s, b, t_in, k_in, co, w2p,
                                                         bias, nullptr, nullptr, vec,
                                                         out, stream);
}

// a1s (B, t_in, k_in) int8, w2p (k_in, 3co) int8, m, o (co,) int32 ->
// (B, t_in-2, co) int8.
extern "C" int amc_conv2_stacked_int8(const void* a1s, long long b, int t_in,
                                      int k_in, int co, const void* w2p, const void* m,
                                      const void* o, int vec, void* out, void* stream) {
  return launch_conv2<INT8_MMA, int8_t>(a1s, b, t_in, k_in, co, w2p, nullptr,
                                        static_cast<const int*>(m),
                                        static_cast<const int*>(o), vec, out, stream);
}
