// Hopper (sm_90a) pieces shared by the wgmma kernels (dense_argmax_int8.cu,
// dense_argmax_bf16.cu, the conv2 route of cnn_kernels.cu and, through
// conv2_wgmma.cuh, conv_stage_int8.cu and conv_stage_bf16_v4.cu):
// mbarriers, TMA tile loads, bulk stores from shared memory, wgmma
// descriptors, fences and the m64n256 products of the dense stages,
// cuTensorMapEncodeTiled looked up through the runtime (no -lcuda), and
// the K-split cluster of the dense stages: its size and the sum of its
// blocks' partial tiles.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// The box of a 2-D map at (element x, row y) into dst.
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The box of a 3-D map at (x, y, z) into shared address dst.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) from shared address src to
// global dst (both 16-byte aligned), in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma descriptor of a K-major tile of 64-byte rows in the 64-byte swizzle
// (TMA's SWIZZLE_64B): 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ uint64_t wgmma_desc(const uint8_t* p) { return wgmma_desc(smem_u32(p)); }

// The same for 128-byte rows in the 128-byte swizzle (TMA's SWIZZLE_128B):
// 8-row groups 1024 bytes apart. The swizzle follows the address bits, so
// a start moved by whole rows or by 32 bytes inside a row needs no base
// offset (measured on the H100: a base offset of (start >> 7) & 7 reads the
// wrong rows).
__device__ __forceinline__ uint64_t wgmma_desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 accumulator operands of an m64n256 wgmma, as K(d[i]) constraints.
#define AMC_WGMMA_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
  " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
  " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
  " %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71," \
  " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85," \
  " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99," \
  " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110," \
  " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121," \
  " %122, %123, %124, %125, %126, %127}, "
#define AMC_WGMMA_OUT128(K) \
  K(d[0]), K(d[1]), K(d[2]), K(d[3]), K(d[4]), K(d[5]), K(d[6]), K(d[7]), K(d[8]), \
  K(d[9]), K(d[10]), K(d[11]), K(d[12]), K(d[13]), K(d[14]), K(d[15]), K(d[16]), \
  K(d[17]), K(d[18]), K(d[19]), K(d[20]), K(d[21]), K(d[22]), K(d[23]), K(d[24]), \
  K(d[25]), K(d[26]), K(d[27]), K(d[28]), K(d[29]), K(d[30]), K(d[31]), K(d[32]), \
  K(d[33]), K(d[34]), K(d[35]), K(d[36]), K(d[37]), K(d[38]), K(d[39]), K(d[40]), \
  K(d[41]), K(d[42]), K(d[43]), K(d[44]), K(d[45]), K(d[46]), K(d[47]), K(d[48]), \
  K(d[49]), K(d[50]), K(d[51]), K(d[52]), K(d[53]), K(d[54]), K(d[55]), K(d[56]), \
  K(d[57]), K(d[58]), K(d[59]), K(d[60]), K(d[61]), K(d[62]), K(d[63]), K(d[64]), \
  K(d[65]), K(d[66]), K(d[67]), K(d[68]), K(d[69]), K(d[70]), K(d[71]), K(d[72]), \
  K(d[73]), K(d[74]), K(d[75]), K(d[76]), K(d[77]), K(d[78]), K(d[79]), K(d[80]), \
  K(d[81]), K(d[82]), K(d[83]), K(d[84]), K(d[85]), K(d[86]), K(d[87]), K(d[88]), \
  K(d[89]), K(d[90]), K(d[91]), K(d[92]), K(d[93]), K(d[94]), K(d[95]), K(d[96]), \
  K(d[97]), K(d[98]), K(d[99]), K(d[100]), K(d[101]), K(d[102]), K(d[103]), \
  K(d[104]), K(d[105]), K(d[106]), K(d[107]), K(d[108]), K(d[109]), K(d[110]), \
  K(d[111]), K(d[112]), K(d[113]), K(d[114]), K(d[115]), K(d[116]), K(d[117]), \
  K(d[118]), K(d[119]), K(d[120]), K(d[121]), K(d[122]), K(d[123]), K(d[124]), \
  K(d[125]), K(d[126]), K(d[127])

// D += A . B for a warpgroup, both operands K-major from shared memory, D
// 64 x 256 in registers (n8 block j of row 16*warp + g in d[4j], d[4j+1],
// of row 16*warp + g + 8 in d[4j+2], d[4j+3]): int8, A 64 x 32 and B
// 256 x 32, int32 sums ...
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " AMC_WGMMA_D128
      "%128, %129, p;\n}\n"
      : AMC_WGMMA_OUT128("+r")
      : "l"(da), "l"(db), "r"(1));
}

// ... and bf16, A 64 x 16 and B 256 x 16, f32 sums.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " AMC_WGMMA_D128
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : AMC_WGMMA_OUT128("+f")
      : "l"(da), "l"(db), "r"(1));
}

#undef AMC_WGMMA_D128
#undef AMC_WGMMA_OUT128

// The K-split cluster of the dense stages. A cluster of cs blocks owns one
// tile of frames; each block multiplies its share of K into a partial tile
// in its shared memory, and block r sums rows [r*rows/cs, (r+1)*rows/cs) of
// every block's tile.

constexpr int MAX_CLUSTER = 8;

// The partial tiles of the cluster's CS blocks, this block's own included,
// as this block sees them (distributed shared memory).
template <int CS, typename T>
__device__ __forceinline__ void cluster_tiles(cg::cluster_group& cluster, const T* part,
                                              int rank, const T* (&src)[CS]) {
#pragma unroll
  for (int q = 0; q < CS; ++q) src[q] = q == rank ? part : cluster.map_shared_rank(part, q);
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// The 4 elements at off of the CS partial tiles summed in rank order
// 0..CS-1 (a float sum so rounds the same for a given CS); every load is
// sent out before the first add.
template <int CS, typename T>
__device__ __forceinline__ void cluster_sum4(const T* const (&src)[CS], int off, T (&s)[4]) {
  using V = typename Vec4<T>::type;
  V v[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) v[q] = *reinterpret_cast<const V*>(src[q] + off);
  s[0] = v[0].x;
  s[1] = v[0].y;
  s[2] = v[0].z;
  s[3] = v[0].w;
#pragma unroll
  for (int q = 1; q < CS; ++q) {
    s[0] = s[0] + v[q].x;
    s[1] = s[1] + v[q].y;
    s[2] = s[2] + v[q].z;
    s[3] = s[3] + v[q].w;
  }
}

// cudaLaunchKernelEx's configuration for `tiles` clusters of `kernel`,
// which holds one block per SM: cs blocks per cluster, cs the first of
// `sizes` (descending) that keeps the grid within one block per SM and
// every cluster resident at once, else 1 (cudaOccupancyMaxActiveClusters,
// asked once per size and kept in fit; a cluster that waits for another to
// finish doubles the time). cfg points at attr, which the caller keeps
// until the launch.
template <typename Kernel, int N>
cudaError_t cluster_config(Kernel kernel, const int (&sizes)[N], long long tiles, int threads,
                           int smem_bytes, void* stream, int (&fit)[MAX_CLUSTER + 1],
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem_bytes;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int cs = 1;
  for (const int size : sizes) {
    if (size <= 1 || size > MAX_CLUSTER || tiles * size > sms) continue;
    if (fit[size] == 0) {
      attr->val.clusterDim.x = size;
      cfg->gridDim = dim3(size);
      err = cudaOccupancyMaxActiveClusters(&fit[size], kernel, cfg);
      if (err != cudaSuccess) return err;
    }
    if (tiles <= fit[size]) {
      cs = size;
      break;
    }
  }
  attr->val.clusterDim.x = cs;
  cfg->gridDim = dim3(static_cast<unsigned>(tiles * cs));
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime; null
// when the driver has none.
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace
