// Fused bf16 dense1 -> ReLU -> dense2 -> class mask [-> argmax] on Hopper's
// bf16 tensor cores (sm_90a). One templated body, two C entry points:
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
// does. Both entries share the logits bit for bit at a given B, so the
// argmax of amc_dense_bf16's logits is amc_dense_argmax_bf16's label.
//
// Bound on the H100 SXM at B = 4096: the map read once, 4096*9920*2 =
// 81.3 MB, plus w3t's 5.1 MB (~0.026 ms at 3.35 TB/s), against 2*B*(9920*256
// + 256*11) ~ 20.8 G bf16 operations (~0.021 ms at 989 TFLOP/s):
// memory-bound, ~0.026 ms.
//
// Design. dense1 is a (B x 9920) . (9920 x 256) bf16 product with a
// per-column epilogue that needs all 256 outputs of a frame in one place.
// A cluster of CS blocks owns 128 frames and all 256 outputs and splits K
// between its blocks (155 rows of 128 bytes, 64 bf16 each). So w3t is read
// from L2 once per 128 frames (163 MB at B = 4096), not once per 32 as the
// earlier body read it (650 MB), and the reduction needs no global
// workspace and no second launch. CS is the largest of 2..8 that keeps the
// grid within one block per SM and every cluster resident at once, else 1
// (tma_wgmma.cuh's cluster_config; the int8 twin takes 2, 4, 8): the body
// is held by the tensor cores of the SMs it runs on, and at B = 4096, where
// 32 clusters of 4 do not fit (30 do), 3 blocks a tile (96 SMs) run 25 %
// faster than 2 (64 SMs). On the H100 SXM: 16 tiles x 6 blocks at
// B = 2048, 32 x 3 at 4096, 64 x 2 at 8192, 128 x 1 at 16384.
// In a block, thread 0 keeps a 4-stage ring of TMA loads in flight (a
// 128 x 128-byte tile of h and the 256 x 128-byte tile of w3t per stage,
// 48 KB, in the 128-byte swizzle, completion counted on an mbarrier per
// stage; rows past n arrive as zeros); two warpgroups each run
// wgmma.m64n256k16 (bf16 x bf16 -> f32, both operands K-major from shared
// memory) on their 64 frames with one product group left in flight, and a
// stage is refilled once both warpgroups are done with it. At the end each
// block writes its f32 partial tile to shared memory; block r of the
// cluster sums rows [r*128/CS, (r+1)*128/CS) over the cluster's blocks
// through distributed shared memory in rank order 0..CS-1, then rounds as
// the plain version does (__fadd_rn with b3, ReLU, __floats2bfloat162_rn),
// runs dense2 (exact bf16 products, f32 sums in d order, w4 staged once
// per block and read as broadcasts) and the argmax (a strict ">" scan).
// Sharing each K slice of w3t between two tiles by TMA multicast (a
// cluster of 2 x CS blocks) was tried, with thread 0 and with a producer
// warp feeding the ring: right, and 1.6-7x slower at B = 2048 to 16384.
// Sum order: a frame's dense1 sums run in the tensor cores' order within a
// block's K range, then over the CS blocks in rank order. That order is
// fixed for a given (B, CS), so a run repeats itself bit for bit, but CS
// follows B, so the same frame's d1 may round to a neighbouring bf16 at
// another batch size (chip_smoke.py holds 2048 frames at B = 2048, 4096 and
// 16384 to labels equal but at near-ties).
// Times at B = 4096 on the H100 (PERF.md, kernel table rows 13 and 16, old,
// new, new, old in one run of chip_smoke.py): 0.042-0.045 ms of device
// time against the earlier body's 0.238-0.256 (mma.sync from scalar shared
// loads, one 32-frame block per SM) and torch.matmul's dense1 0.043.
#include <cuda_bf16.h>
#include <math.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int KD = 124 * 80;               // dense1 reduction length (9920)
constexpr int D = 256;                     // dense1 outputs
constexpr int NC = 11;                     // classes, padded
constexpr int BM = 128;                    // frames per cluster
constexpr int KE = 64;                     // bf16 of K per stage (128 bytes)
constexpr int ROW = KE * 2;                // bytes per staged row
constexpr int NCHUNK = KD / KE;            // 155
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * ROW;          // 16 KB of h
constexpr int STAGE_BYTES = A_BYTES + D * ROW;   // + 32 KB of w3t
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int P_STRIDE = D + 8;            // partial row, f32 words
constexpr int P_BYTES = BM * P_STRIDE * 4;
constexpr int D1_STRIDE = D + 4;           // d1 row, bf16 (rows 2 banks apart)
constexpr int D1_BYTES = BM * D1_STRIDE * 2;
constexpr int LOGITS_OFF = P_BYTES + D1_BYTES;
constexpr int EPI_BYTES = LOGITS_OFF + BM * NC * 4;
constexpr int W4_STRIDE = D + 4;           // w4 staged [c][d] in f32
constexpr int W4_OFF = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
constexpr int BAR_OFF = W4_OFF + NC * W4_STRIDE * 4;
constexpr int SMEM_BYTES = BAR_OFF + STAGES * 8;

static_assert(KD % KE == 0, "128-byte rows tile the reduction");
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "swizzle atoms aligned");
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(THREADS == 256 && BM == 2 * 64, "two warpgroups of 64 frames");

// The end of a block of a CS-block cluster, after every block's partial
// tile is in its shared memory: rows [rank*128/CS, (rank+1)*128/CS) (42 or
// 43 of them at CS = 3) summed over the cluster in rank order (a thread
// keeps 4 columns and their b3), rounded into d1, then dense2 and the
// labels or logits.
template <int CS, bool ARGMAX>
__device__ __forceinline__ void finish(cg::cluster_group& cluster, uint8_t* smem, int rank,
                                       long long f0, long long n,
                                       const float* __restrict__ b3,
                                       const float* __restrict__ b4, int nc,
                                       void* __restrict__ out) {
  constexpr int ROW_STEP = THREADS / (D / 4), RB_MAX = (BM + CS - 1) / CS;
  const int tid = threadIdx.x, r0 = rank * BM / CS, rb = (rank + 1) * BM / CS - r0;
  const float* part = reinterpret_cast<const float*>(smem);
  __nv_bfloat16* d1s = reinterpret_cast<__nv_bfloat16*>(smem + P_BYTES);
  float* logits = reinterpret_cast<float*>(smem + LOGITS_OFF);
  const int col = 4 * (tid % (D / 4));
  const float4 bias = __ldg(reinterpret_cast<const float4*>(b3 + col));
  const float* src[CS];
  cluster_tiles<CS>(cluster, part, rank, src);
#pragma unroll
  for (int i = 0; i < (RB_MAX + ROW_STEP - 1) / ROW_STEP; ++i) {
    const int row = tid / (D / 4) + ROW_STEP * i;
    float s[4];   // rows past rb read row rb - 1 again, so every load can go out at once
    cluster_sum4<CS>(src, (r0 + min(row, rb - 1)) * P_STRIDE + col, s);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(__fadd_rn(s[0], bias.x), 0.0f),
                                                    fmaxf(__fadd_rn(s[1], bias.y), 0.0f));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(__fadd_rn(s[2], bias.z), 0.0f),
                                                    fmaxf(__fadd_rn(s[3], bias.w), 0.0f));
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    if (row < rb) *reinterpret_cast<uint2*>(d1s + row * D1_STRIDE + col) = packed;
  }
  // Done reading the other blocks' tiles; they may exit once all arrive.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // dense2: thread (g, r) takes frames r and r + 64 and classes 3g..3g+2,
  // so a warp's lanes read one w4 row at a time (a broadcast) and their
  // own d1 rows. 256 products each, summed in d order, then b4; the padded
  // classes at -inf. A bf16 x bf16 product is exact in f32 (above its
  // subnormals), so each fused multiply-add rounds as the add alone.
  constexpr int CPG = (NC + THREADS / 64 - 1) / (THREADS / 64);   // 3 classes a thread
  const float* w4s = reinterpret_cast<const float*>(smem + W4_OFF);
  const int g = tid / 64;
  for (int r = tid % 64; r < rb; r += 64) {
    const uint2* a = reinterpret_cast<const uint2*>(d1s + r * D1_STRIDE);
    float s[CPG] = {};
#pragma unroll 4
    for (int q = 0; q < D / 4; ++q) {
      const uint2 av = a[q];
      const float2 a01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.x));
      const float2 a23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.y));
#pragma unroll
      for (int j = 0; j < CPG; ++j) {   // group 3's third class repeats class 10
        const float4 wv = reinterpret_cast<const float4*>(
            w4s + min(CPG * g + j, NC - 1) * W4_STRIDE)[q];
        s[j] = __fmaf_rn(a01.x, wv.x, s[j]);
        s[j] = __fmaf_rn(a01.y, wv.y, s[j]);
        s[j] = __fmaf_rn(a23.x, wv.z, s[j]);
        s[j] = __fmaf_rn(a23.y, wv.w, s[j]);
      }
    }
    const long long f = f0 + r0 + r;
#pragma unroll
    for (int j = 0; j < CPG; ++j) {
      const int c = CPG * g + j;
      if (c >= NC) break;
      const float v = c < nc ? __fadd_rn(s[j], __ldg(b4 + c)) : -INFINITY;
      if constexpr (ARGMAX)
        logits[r * NC + c] = v;
      else if (f < n)
        static_cast<float*>(out)[f * NC + c] = v;
    }
  }
  if constexpr (ARGMAX) {
    __syncthreads();
    const long long f = f0 + r0 + tid;
    if (tid < rb && f < n) {
      int best = 0;
      float bv = logits[tid * NC];
      for (int c = 1; c < NC; ++c) {
        if (logits[tid * NC + c] > bv) {  // strict: ties keep the lowest index
          bv = logits[tid * NC + c];
          best = c;
        }
      }
      static_cast<int*>(out)[f] = best;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ARGMAX: labels (B,) int32 into out; else the logits (B, NC) f32.
template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 1)
dense_argmax_bf16_kernel(const __grid_constant__ CUtensorMap hmap,
                         const __grid_constant__ CUtensorMap wmap, long long n,
                         const float* __restrict__ b3,
                         const __nv_bfloat16* __restrict__ w4,
                         const float* __restrict__ b4, int nc, void* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long f0 = static_cast<long long>(blockIdx.x / cs) * BM;
  const int c_begin = rank * NCHUNK / cs, nch = (rank + 1) * NCHUNK / cs - c_begin;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);

  auto load = [&](int c) {  // thread 0: chunk c of this block's range
    const uint32_t bar = smem_u32(bars + c % STAGES);
    uint8_t* st = smem + (c % STAGES) * STAGE_BYTES;
    const int k = (c_begin + c) * KE;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(st, &hmap, k, static_cast<int>(f0), bar);
    tma_load(st + A_BYTES, &wmap, k, 0, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < STAGES && c < nch; ++c) load(c);
  }
  // w4 transposed into f32 rows [c][d] for dense2.
  float* w4s = reinterpret_cast<float*>(smem + W4_OFF);
  for (int i = tid; i < NC * D; i += THREADS) {
    const int c = i / D, d = i % D;
    w4s[c * W4_STRIDE + d] = __bfloat162float(w4[d * NC + c]);
  }
  __syncthreads();  // the barriers are initialized before anyone waits on them

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    mbar_wait(smem_u32(bars + c % STAGES), (c / STAGES) & 1);
    const uint8_t* st = smem + (c % STAGES) * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KE / 16; ++ks)
      wgmma_bf16(acc, wgmma_desc128(smem_u32(st + wg * 64 * ROW + 32 * ks)),
                 wgmma_desc128(smem_u32(st + A_BYTES + 32 * ks)));
    wgmma_commit();
    wgmma_wait<1>();   // chunk c-1's products are done in this warpgroup
    __syncthreads();   // ... and in the other: its stage may be refilled
    if (tid == 0 && c >= 1 && c - 1 + STAGES < nch) load(c - 1 + STAGES);
  }
  wgmma_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  float* part = reinterpret_cast<float*>(smem);
  {
    const int row = 64 * wg + 16 * (warp % 4) + lane / 4, col = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float* p = part + row * P_STRIDE + 8 * j + col;
      *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * P_STRIDE) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  cluster.sync();  // every block's partial tile is written

  switch (cs) {
    case 1: finish<1, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 2: finish<2, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 3: finish<3, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 4: finish<4, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 5: finish<5, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 6: finish<6, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    case 7: finish<7, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
    default: finish<8, ARGMAX>(cluster, smem, rank, f0, n, b3, b4, nc, out); break;
  }
}

// A (rows, 9920) bf16 row-major matrix read in (box_rows, 64-element) tiles
// in the 128-byte swizzle; rows past the end read as zeros.
bool encode_map(CUtensorMap* map, const void* base, long long rows, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(KD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(KD) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KE), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One cluster of CS blocks per 128 frames (tma_wgmma.cuh's cluster_config);
// returns the launch's cudaGetLastError() code (no launch for n <= 0;
// cudaErrorInvalidValue if a tensor map cannot be made).
template <bool ARGMAX>
int launch(const void* h, long long n, const void* w3t, const void* b3,
           const void* w4, const void* b4, int nc, void* out, void* stream) {
  if (n <= 0) return 0;
  CUtensorMap hmap, wmap;
  if (!encode_map(&hmap, h, n, BM) || !encode_map(&wmap, w3t, D, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dense_argmax_bf16_kernel<ARGMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + BM - 1) / BM;
  static int fit[MAX_CLUSTER + 1] = {};   // clusters of each size the card holds at once
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = cluster_config(kernel, {8, 7, 6, 5, 4, 3, 2}, tiles, THREADS, SMEM_BYTES, stream, fit,
                       &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, hmap, wmap, n, static_cast<const float*>(b3),
                           static_cast<const __nv_bfloat16*>(w4),
                           static_cast<const float*>(b4), nc, out);
  if (err != cudaSuccess) return static_cast<int>(err);
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
