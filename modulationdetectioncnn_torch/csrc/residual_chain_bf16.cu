// The residual stacks of O'Shea, Roy and Clancy's classifier (IEEE JSTSP 2018,
// arXiv:1712.04578, Table III) in bf16, for Hopper (sm_90a), in one launch.
//
// Replaces: no TPU kernel. The JAX package runs VT-CNN2 only; this kernel
// serves the port's second architecture (models/resnet_rml18.py) at its
// published widths, since no kernel of the port computes a 32 -> 32,
// width-3, same-padded conv chain with skip adds and pooling, and unfused
// every pass of it would read and write a 64 KiB map a frame.
//
// Computes, per frame, x (2, 1024) f32 -> out (16, 32) bf16, position-major
// maps y[t, c]; bf16_rn rounds to nearest even, every sum is f32:
//   stack 0:  xb = bf16_rn(x)
//             y[t, c] = bf16_rn((xb[0,t] * w[0,c] + xb[1,t] * w[1,c]) + b[c])
//   stack s:  y[t, c] = bf16_rn(sum_j x[t, j] * w[c, j] + b[c])     (1x1, 32 -> 32)
//   then twice (a residual unit, convs of width 3, zero "same" padding):
//             h[t, c] = bf16_rn(relu(sum_k sum_j y[t+k-1, j] * wa[k, j, c] + ba[c]))
//             y[t, c] = bf16_rn((sum_k sum_j h[t+k-1, j] * wb[k, j, c] + bb[c]) + y[t, c])
//   then      x'[t, c] = max(y[2t, c], y[2t+1, c])                  (max-pool 2)
// over six stacks (T = 1024, 512, ..., 32), the last pool written out as
// (16, 32) bf16 in t*32 + c order (the head's flatten). Stack 0's products
// are of two bf16 values, exact in f32, so its FMA rounds as the plain
// version's separate add: its map is bit-exact. The other layers sum on the
// tensor cores in their own order, so their maps differ from the plain
// version (ops/residual_chain_bf16.py) by the order of f32 sums alone; the
// order is fixed by the design and does not depend on the batch.
//
// Bound on the H100 SXM at B = 4096: 2 x 25,853,952 operations a frame,
// ~211.8 G bf16 operations, ~0.214 ms at 989 TFLOP/s, against ~37.9 MB
// moved (8 KiB of frame in, 1 KiB of map out a frame, 163,584 bytes of
// weights), ~0.011 ms at 3.35 TB/s: operation-bound.
//
// Design. A persistent block of 8 warps on each SM walks frames (frame =
// blockIdx.x, += gridDim.x) and keeps a frame's whole chain in shared
// memory: two maps of (1 + 1024 + 1) rows x 64 bytes, y and h, each with a
// zero guard row before and after (the "same" padding), and the frame's
// 8 KiB of input, prefetched by cp.async while the previous frame runs. A
// conv is a GEMM with M = positions, N = 32, K = 3 taps x 32 channels on
// mma.sync m16n8k16 bf16 -> f32: a warp takes m-tiles of 16 positions, two
// at a time, and all 32 outputs; the A fragment of tap k is ldmatrix on the
// rows shifted by k - 1 (no im2col); the layer's B fragments (48 registers)
// are loaded once a layer from shared memory, where the wrapper packed them
// in fragment order, by the warps that have an m-tile (the B loads are as
// many bytes as the A loads in the first stacks, so 8 warps, each with more
// tiles, move half the bytes 16 would). Rows are 64 bytes, so 16-byte chunk c of row r is stored
// at chunk c ^ ((r >> 1) & 3): any 8 consecutive rows, as ldmatrix and the
// epilogue's stores touch them, fall in 8 distinct bank groups. The second
// conv of a unit adds its skip in place (each warp reads and writes its own
// rows of y only). One stack's weights (27,264 bytes in the wrapper's
// layout) are double-buffered: stack s + 1's arrive by cp.async while stack
// s computes. Nothing between the frame and the (16, 32) map reaches
// global memory. Shared memory 194,048 bytes, one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T0 = 1024;              // frame length
constexpr int C = 32;                 // filters
constexpr int STACKS = 6;
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int ROW_BYTES = C * 2;      // one position of a bf16 map
constexpr int MAP_BYTES = (T0 + 2) * ROW_BYTES;
constexpr int X_BYTES = 2 * T0 * 4;
// One stack's weights as the wrapper packs them (ops/residual_chain_bf16.py):
// B fragments of m16n8k16 in lane order, one uint2 a lane, [k-step][n-tile].
constexpr int FRAG_BYTES = 32 * 8;
constexpr int OFF_PROJ = 0;                                   // 8 fragments (stack 0: w f32 (2, 32))
constexpr int OFF_PROJ_BIAS = 8 * FRAG_BYTES;                 // 32 f32
constexpr int OFF_CONV = OFF_PROJ_BIAS + C * 4;               // 4 convs x 24 fragments
constexpr int CONV_BYTES = 24 * FRAG_BYTES;
constexpr int OFF_CONV_BIAS = OFF_CONV + 4 * CONV_BYTES;      // 4 x 32 f32
constexpr int STACK_BYTES = OFF_CONV_BIAS + 4 * C * 4;        // 27,264
constexpr int SMEM_BYTES = 2 * STACK_BYTES + 2 * MAP_BYTES + X_BYTES;
static_assert(STACK_BYTES % 16 == 0 && MAP_BYTES % 16 == 0, "16-byte copies");
static_assert(SMEM_BYTES <= 232448, "one block an SM");

enum Mode { RELU = 0, SKIP = 1, LINEAR = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (channels 8c .. 8c+7) of row r.
__device__ __forceinline__ int at(int r, int c) {
  return r * ROW_BYTES + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void load_async(unsigned char* dst, const unsigned char* src,
                                           int bytes) {
  const uint32_t d = smem_u32(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) cp_async16(d + 16 * i, src + 16 * i);
}

// NTILE m-tiles of one conv layer, at rows 16 mt[i] + 1 ..: the A
// fragment of tap k is ldmatrix on the rows shifted by k - 1; the epilogue
// writes dst (RELU: relu; SKIP: adds dst's own value, in place; LINEAR).
template <int TAPS, int MODE, int NTILE>
__device__ __forceinline__ void conv_tiles(uint32_t src, unsigned char* dst, const int (&mt)[NTILE],
                                           const uint32_t (&b)[2 * TAPS][4][2],
                                           const float (&bv)[4][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[NTILE][4][4];
#pragma unroll
  for (int i = 0; i < NTILE; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[i][nt][0] = acc[i][nt][2] = bv[nt][0];
      acc[i][nt][1] = acc[i][nt][3] = bv[nt][1];
    }
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t a[NTILE][4];
#pragma unroll
      for (int i = 0; i < NTILE; ++i) {
        // position t = 16 mt + (lane & 15) shifted by tap - 1, at row t + 1
        const int r = mt[i] * 16 + (lane & 15) + (TAPS == 3 ? tap : 1);
        ldmatrix_x4(a[i], src + at(r, 2 * half + (lane >> 4)));
      }
#pragma unroll
      for (int i = 0; i < NTILE; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[i][nt], a[i], b[2 * tap + half][nt][0], b[2 * tap + half][nt][1]);
    }
#pragma unroll
  for (int i = 0; i < NTILE; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = mt[i] * 16 + g + 8 * hr + 1;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float v0 = acc[i][nt][2 * hr], v1 = acc[i][nt][2 * hr + 1];
        uint32_t* p = reinterpret_cast<uint32_t*>(dst + at(r, nt) + 4 * tq);
        if (MODE == RELU) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        } else if (MODE == SKIP) {
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
          v0 += y.x;
          v1 += y.y;
        }
        *p = pack_bf16(v0, v1);
      }
    }
}

// One conv layer over a T-position map: src rows (physical row t + 1) ->
// dst rows. TAPS 3: width 3, same padding (the guard rows read as zero);
// TAPS 1: the 1x1 projection. A warp with an m-tile loads the layer's B
// fragments and bias once, then takes its m-tiles two at a time (warp,
// warp + NWARPS; then + 2 NWARPS, ...); a warp with none sits the layer out.
template <int TAPS, int MODE>
__device__ __forceinline__ void conv_layer(uint32_t src, unsigned char* dst, int T,
                                           const uint2* frag, const float* bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = T >> 4;
  if (warp >= tiles) return;
  const int tq = lane & 3;
  uint32_t b[2 * TAPS][4][2];
#pragma unroll
  for (int ks = 0; ks < 2 * TAPS; ++ks)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint2 v = frag[(ks * 4 + nt) * 32 + lane];
      b[ks][nt][0] = v.x;
      b[ks][nt][1] = v.y;
    }
  float bv[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bv[nt][0] = bias[nt * 8 + 2 * tq];
    bv[nt][1] = bias[nt * 8 + 2 * tq + 1];
  }
  int mt = warp;
  for (; mt + NWARPS < tiles; mt += 2 * NWARPS) {
    const int two[2] = {mt, mt + NWARPS};
    conv_tiles<TAPS, MODE, 2>(src, dst, two, b, bv);
  }
  if (mt < tiles) {
    const int one[1] = {mt};
    conv_tiles<TAPS, MODE, 1>(src, dst, one, b, bv);
  }
}

// Stack 0's projection, the two I/Q channels to 32, on the FMA pipes: a
// thread a position, its 32 outputs as four 16-byte stores.
__device__ __forceinline__ void project_iq(const float* xs, unsigned char* y, const float* w,
                                           const float* bias) {
  for (int t = threadIdx.x; t < T0; t += THREADS) {
    const float xi = __bfloat162float(__float2bfloat16_rn(xs[t]));
    const float xq = __bfloat162float(__float2bfloat16_rn(xs[T0 + t]));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * c + 2 * j;
        const float a0 = fmaf(xq, w[C + n], xi * w[n]) + bias[n];
        const float a1 = fmaf(xq, w[C + n + 1], xi * w[n + 1]) + bias[n + 1];
        v[j] = pack_bf16(a0, a1);
      }
      *reinterpret_cast<uint4*>(y + at(t + 1, c)) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  __nv_bfloat162 m = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&m);
}

// Max-pool 2 of y's T rows into dst's rows 1 .. T/2, or, for the last
// stack, into the frame's (T/2, 32) output in global memory.
__device__ __forceinline__ void pool2(const unsigned char* y, unsigned char* dst, int T,
                                      __nv_bfloat16* gout) {
  for (int i = threadIdx.x; i < (T / 2) * 4; i += THREADS) {
    const int t = i >> 2, c = i & 3;
    const uint4 a = *reinterpret_cast<const uint4*>(y + at(2 * t + 1, c));
    const uint4 b = *reinterpret_cast<const uint4*>(y + at(2 * t + 2, c));
    const uint4 m = make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z), max2(a.w, b.w));
    if (gout != nullptr)
      *reinterpret_cast<uint4*>(gout + t * C + 8 * c) = m;
    else
      *reinterpret_cast<uint4*>(dst + at(t + 1, c)) = m;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    residual_chain_bf16_kernel(const float* __restrict__ x, long long n,
                               const unsigned char* __restrict__ w,
                               __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wbuf = smem;                        // [2][STACK_BYTES]
  unsigned char* y = smem + 2 * STACK_BYTES;         // the stack's map
  unsigned char* h = y + MAP_BYTES;                  // a unit's inner map; the pooled input
  float* xs = reinterpret_cast<float*>(h + MAP_BYTES);
  const int tid = threadIdx.x;
  long long frame = blockIdx.x;
  if (frame >= n) return;
  if (tid < 16) {   // the guard rows 0 and T0 + 1 of both maps, never written after
    unsigned char* m = (tid & 8) ? h : y;
    *reinterpret_cast<uint4*>(m + ((tid & 4) ? T0 + 1 : 0) * ROW_BYTES + 16 * (tid & 3)) =
        make_uint4(0, 0, 0, 0);
  }
  load_async(wbuf, w, STACK_BYTES);
  load_async(reinterpret_cast<unsigned char*>(xs),
             reinterpret_cast<const unsigned char*>(x + frame * 2 * T0), X_BYTES);
  cp_async_commit();
  for (; frame < n; frame += gridDim.x) {
    const bool more = frame + gridDim.x < n;
    for (int s = 0; s < STACKS; ++s) {
      const int T = T0 >> s;
      cp_async_wait_all();
      __syncthreads();   // stack s's weights (and the frame) are in; the last pass is done
      if (s + 1 < STACKS || more) {   // the next stack's weights, into the buffer stack s-1 used
        const int next = (s + 1) % STACKS;
        load_async(wbuf + (next & 1) * STACK_BYTES, w + next * STACK_BYTES, STACK_BYTES);
        cp_async_commit();
      }
      const unsigned char* ws = wbuf + (s & 1) * STACK_BYTES;
      const float* cb = reinterpret_cast<const float*>(ws + OFF_CONV_BIAS);
      const uint2* cf = reinterpret_cast<const uint2*>(ws + OFF_CONV);
      if (s == 0) {
        project_iq(xs, y, reinterpret_cast<const float*>(ws + OFF_PROJ),
                   reinterpret_cast<const float*>(ws + OFF_PROJ_BIAS));
      } else {
        conv_layer<1, LINEAR>(smem_u32(h), y, T, reinterpret_cast<const uint2*>(ws + OFF_PROJ),
                              reinterpret_cast<const float*>(ws + OFF_PROJ_BIAS));
        if (tid < 8)   // row T + 1 of both maps is this stack's zero padding
          *reinterpret_cast<uint4*>(((tid & 4) ? h : y) + (T + 1) * ROW_BYTES +
                                    16 * (tid & 3)) = make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
      if (s == 0 && more) {   // the frame is read: fetch the next one
        load_async(reinterpret_cast<unsigned char*>(xs),
                   reinterpret_cast<const unsigned char*>(x + (frame + gridDim.x) * 2 * T0),
                   X_BYTES);
        cp_async_commit();
      }
#pragma unroll 1
      for (int u = 0; u < 2; ++u) {
        conv_layer<3, RELU>(smem_u32(y), h, T, cf + (2 * u) * 24 * 32, cb + (2 * u) * C);
        __syncthreads();
        conv_layer<3, SKIP>(smem_u32(h), y, T, cf + (2 * u + 1) * 24 * 32, cb + (2 * u + 1) * C);
        __syncthreads();
      }
      pool2(y, h, T, s + 1 < STACKS ? nullptr : out + frame * (T0 >> STACKS) * C);
    }
  }
}

}  // namespace

extern "C" int amc_residual_chain_bf16(const void* x, long long n, const void* w, void* out,
                                       void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);   // 16-byte copies and stores
  static int sms = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(residual_chain_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n < sms ? n : sms);
  residual_chain_bf16_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<const unsigned char*>(w),
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
