// Fused int8 dense1 -> requantize -> dense2 -> argmax on Hopper's int8
// tensor cores (sm_90a). One templated body, two C entry points:
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
// activations read once (~12.9 us at 3.35 TB/s): memory-bound.
//
// Design. dense1 is a (B x 9920) . (9920 x 256) int8 product with a
// per-column epilogue that needs all 256 outputs of a frame in one place.
// A cluster of CS blocks owns 128 frames and all 256 outputs and splits K
// between its blocks (155 chunks of 64 bytes). CS is the largest of 1, 2,
// 4, 8 that keeps the grid within one block per SM and every cluster
// resident at once (cudaOccupancyMaxActiveClusters; a cluster that waits
// for another to finish doubles the time): on the H100 SXM 16 tiles x 4
// blocks at B = 2048, 32 x 2 at 4096, 128 x 1 at 16384.
// In a block, thread 0 keeps an 8-stage ring of TMA loads in flight (a
// 128 x 64-byte tile of h and the 256 x 64-byte tile of w3t per stage, in
// the 64-byte swizzle, completion counted on an mbarrier per stage; rows
// past n arrive as zeros); two warpgroups each run wgmma.m64n256k32 (s8 x
// s8 -> s32, both operands K-major from shared memory) on their 64 frames
// with one product group left in flight, and a stage is refilled once both
// warpgroups are done with it. At the end each block writes its int32
// partial tile to shared memory; block r of the cluster sums rows
// [r*128/CS, (r+1)*128/CS) over the cluster's blocks through distributed
// shared memory, requantizes them, and runs dense2 (a thread per frame,
// 11 classes of 64 __dp4a against w4 staged transposed) and the argmax.
// Integer sums in any order are exact (|acc| <= 9920 * 127 * 128 < 2^31),
// so the split keeps every label and logit bit for bit.
// Why split K and not share w3t along M: the split grows the grid without
// shrinking the 128-frame tile, so w3t is read from L2 once per 128 frames
// (81 MB at B = 4096, not the old body's 325 MB) and the reduction needs
// no global workspace (the ABI has none) and no second launch. Sharing
// w3t's chunks between two tiles' clusters (TMA multicast, a producer warp,
// each stage released across the blocks) was tried: bit-exact, faster only
// at B = 16384, slower at 2048 to 8192. What bounds this body: L2's rate
// for those 81 MB plus the 41 MB map (more blocks per tile do not run
// faster), then the epilogue.
// Times at B = 4096 (PERF.md, kernel table rows 2, 11): the earlier body
// (__dp4a on the CUDA cores, one 32-frame block per SM) 0.325 ms of device
// time, this one 0.032, old, new, new, old in one run of chip_smoke.py.
#include "conv2_wgmma.cuh"   // requant
#include "tma_wgmma.cuh"

namespace {

constexpr int T2 = 124;                    // conv map rows
constexpr int C2 = 80;                     // conv map channels
constexpr int THREADS = 256;               // two warpgroups
constexpr int KD = T2 * C2;                // dense1 reduction length (9920)
constexpr int D = 256;                     // dense1 outputs
constexpr int NC = 11;                     // classes
constexpr int BM = 128;                    // frames per cluster
constexpr int KC = 64;                     // bytes of K per stage
constexpr int NCHUNK = KD / KC;            // 155
constexpr int STAGES = 8;
constexpr int A_BYTES = BM * KC;
constexpr int STAGE_BYTES = A_BYTES + D * KC;
constexpr int P_STRIDE = D + 8;            // partial row, int32 words
constexpr int P_BYTES = BM * P_STRIDE * 4;
constexpr int A3_STRIDE = D + 16;          // a3 row, bytes
constexpr int EPI_BYTES = P_BYTES + BM * A3_STRIDE;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int W4_OFF = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
constexpr int BAR_OFF = W4_OFF + NC * D;   // w4 staged [c][d]
constexpr int SMEM_BYTES = BAR_OFF + STAGES * 8;

static_assert(KD % KC == 0, "64-byte chunks tile the reduction");
static_assert(STAGE_BYTES % 512 == 0 && A_BYTES % 512 == 0, "swizzle atoms aligned");
static_assert(SMEM_BYTES <= 232448, "fits the 227 KB a block may have");
static_assert(THREADS == 256 && BM == 2 * 64, "two warpgroups of 64 frames");

// The end of a block of a CS-block cluster, after every block's partial
// tile is in its shared memory: rows [rank*128/CS, (rank+1)*128/CS) summed
// over the cluster (distributed shared memory; a thread keeps 4 columns and
// sends all its loads out before it adds), requantized into a3, then dense2
// and the labels or logits.
template <int CS, bool ARGMAX>
__device__ __forceinline__ void finish(cg::cluster_group& cluster, uint8_t* smem, int rank,
                                       long long f0, long long n,
                                       const int* __restrict__ m3, const int* __restrict__ o3,
                                       const float* __restrict__ s4,
                                       const float* __restrict__ b4, void* __restrict__ out) {
  constexpr int RB = BM / CS, ROW_STEP = THREADS / (D / 4);
  static_assert(RB % ROW_STEP == 0, "a block's rows split evenly between its threads");
  const int tid = threadIdx.x, r0 = rank * RB;
  const int* part = reinterpret_cast<const int*>(smem);
  uint8_t* a3 = smem + P_BYTES;
  const int col = 4 * (tid % (D / 4));
  int shift[4], offset[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    shift[e] = __ldg(m3 + col + e);
    offset[e] = __ldg(o3 + col + e);
  }
  const int* src[CS];
  cluster_tiles<CS>(cluster, part, rank, src);
#pragma unroll
  for (int i = 0; i < RB / ROW_STEP; ++i) {
    const int row = tid / (D / 4) + ROW_STEP * i;
    int s[4];
    cluster_sum4<CS>(src, (r0 + row) * P_STRIDE + col, s);
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      packed |= static_cast<uint32_t>(requant(s[e], offset[e], shift[e])) << (8 * e);
    *reinterpret_cast<uint32_t*>(a3 + row * A3_STRIDE + col) = packed;
  }
  // Done reading the other blocks' tiles; they may exit once all arrive.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  const long long f = f0 + r0 + tid;
  if (tid < RB && f < n) {
    uint4 a[D / 16];
#pragma unroll
    for (int q = 0; q < D / 16; ++q)
      a[q] = reinterpret_cast<const uint4*>(a3 + tid * A3_STRIDE)[q];
    const uint4* w4s = reinterpret_cast<const uint4*>(smem + W4_OFF);
    int best = 0;
    float best_v = 0.0f;
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      int s = 0;
#pragma unroll
      for (int q = 0; q < D / 16; ++q) {
        const uint4 w = w4s[c * (D / 16) + q];
        s = __dp4a(static_cast<int>(a[q].x), static_cast<int>(w.x), s);
        s = __dp4a(static_cast<int>(a[q].y), static_cast<int>(w.y), s);
        s = __dp4a(static_cast<int>(a[q].z), static_cast<int>(w.z), s);
        s = __dp4a(static_cast<int>(a[q].w), static_cast<int>(w.w), s);
      }
      const float v = __fadd_rn(__fmul_rn(__int2float_rn(s), __ldg(s4 + c)), __ldg(b4 + c));
      if constexpr (ARGMAX) {
        if (c == 0 || v > best_v) {  // strict: ties keep the lowest index
          best_v = v;
          best = c;
        }
      } else {
        static_cast<float*>(out)[f * NC + c] = v;
      }
    }
    if constexpr (ARGMAX) static_cast<int*>(out)[f] = best;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ARGMAX: labels (B,) int32 into out; else the logits (B, NC) f32.
template <bool ARGMAX>
__global__ void __launch_bounds__(THREADS, 1)
dense_argmax_int8_kernel(const __grid_constant__ CUtensorMap hmap,
                         const __grid_constant__ CUtensorMap wmap, long long n,
                         const int* __restrict__ m3, const int* __restrict__ o3,
                         const int8_t* __restrict__ w4, const float* __restrict__ s4,
                         const float* __restrict__ b4, void* __restrict__ out) {
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
    const int k = (c_begin + c) * KC;
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(st, &hmap, k, static_cast<int>(f0), bar);
    tma_load(st + A_BYTES, &wmap, k, 0, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < STAGES && c < nch; ++c) load(c);
  }
  // w4 transposed into words [c][d/4] for dense2's __dp4a dots.
  uint32_t* w4s = reinterpret_cast<uint32_t*>(smem + W4_OFF);
  for (int i = tid; i < NC * (D / 4); i += THREADS) {
    const int c = i / (D / 4), q = i % (D / 4);
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(w4[(4 * q + e) * NC + c])) << (8 * e);
    w4s[c * (D / 4) + q] = w;
  }
  __syncthreads();  // the barriers are initialized before anyone waits on them

  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    mbar_wait(smem_u32(bars + c % STAGES), (c / STAGES) & 1);
    const uint8_t* st = smem + (c % STAGES) * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      wgmma_s8(acc, wgmma_desc(st + wg * 64 * KC + 32 * ks),
               wgmma_desc(st + A_BYTES + 32 * ks));
    wgmma_commit();
    wgmma_wait<1>();   // chunk c-1's products are done in this warpgroup
    __syncthreads();   // ... and in the other: its stage may be refilled
    if (tid == 0 && c >= 1 && c - 1 + STAGES < nch) load(c - 1 + STAGES);
  }
  wgmma_wait<0>();
  __syncthreads();  // the ring is free: the partial tile takes its place

  int* part = reinterpret_cast<int*>(smem);
  {
    const int row = 64 * wg + 16 * (warp % 4) + lane / 4, col = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      int* p = part + row * P_STRIDE + 8 * j + col;
      *reinterpret_cast<int2*>(p) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(p + 8 * P_STRIDE) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  cluster.sync();  // every block's partial tile is written

  switch (cs) {
    case 1: finish<1, ARGMAX>(cluster, smem, rank, f0, n, m3, o3, s4, b4, out); break;
    case 2: finish<2, ARGMAX>(cluster, smem, rank, f0, n, m3, o3, s4, b4, out); break;
    case 4: finish<4, ARGMAX>(cluster, smem, rank, f0, n, m3, o3, s4, b4, out); break;
    default: finish<8, ARGMAX>(cluster, smem, rank, f0, n, m3, o3, s4, b4, out); break;
  }
}

// A (rows, 9920) int8 row-major matrix read in (box_rows, 64-byte) tiles in
// the 64-byte swizzle; rows past the end read as zeros.
bool encode_map(CUtensorMap* map, const void* base, long long rows, int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(KD), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(KD)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KC), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One cluster of CS blocks per 128 frames, CS one of 8, 4, 2, 1
// (tma_wgmma.cuh's cluster_config); returns the launch's cudaGetLastError()
// code (no launch for n <= 0; cudaErrorInvalidValue if a tensor map cannot
// be made).
template <bool ARGMAX>
int launch(const void* h, long long n, const void* w3t, const void* m3,
           const void* o3, const void* w4, const void* s4, const void* b4,
           void* out, void* stream) {
  if (n <= 0) return 0;
  CUtensorMap hmap, wmap;
  if (!encode_map(&hmap, h, n, BM) || !encode_map(&wmap, w3t, D, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dense_argmax_int8_kernel<ARGMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + BM - 1) / BM;
  static int fit[MAX_CLUSTER + 1] = {};   // clusters of each size the card holds at once
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = cluster_config(kernel, {8, 4, 2}, tiles, THREADS, SMEM_BYTES, stream, fit, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, hmap, wmap, n, static_cast<const int*>(m3),
                           static_cast<const int*>(o3), static_cast<const int8_t*>(w4),
                           static_cast<const float*>(s4), static_cast<const float*>(b4), out);
  if (err != cudaSuccess) return static_cast<int>(err);
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
