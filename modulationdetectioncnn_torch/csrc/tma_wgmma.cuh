// Hopper (sm_90a) pieces shared by the TMA-fed wgmma kernels
// (dense_argmax_int8.cu, the conv2 route of cnn_kernels.cu): mbarriers,
// TMA tile loads, wgmma descriptors and fences, and cuTensorMapEncodeTiled
// looked up through the runtime (no -lcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// A (box rows x 64 bytes) tile at (byte x, row y) of a 2-D map into dst.
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
