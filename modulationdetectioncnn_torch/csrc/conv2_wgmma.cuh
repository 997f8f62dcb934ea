// The conv2 consumer on Hopper (sm_90a) that cnn_kernels.cu's Hopper route
// (rows 18 and 20: conv2 alone, the map from a TMA ring) and
// conv_stage_int8.cu (row 1, v7: the map built on the chip by the block
// itself) share:
//
// - the warpgroup products, m64n40k16 bf16 and m64n80k32 s8, and the
//   products of one ring stage: a stage holds 130 rows x 128 bytes of K in
//   the 128-byte swizzle (16-byte segment s of row r at s ^ (r & 7), on a
//   1024-byte-aligned stage); for tap k, A is the stage's tile moved down k
//   rows, a descriptor start k * 128 bytes further, so the shift-add
//   happens in the accumulator (the 128-byte swizzle follows the address
//   bits, so the moved start needs no base offset);
// - the resident weight: 3 taps x NT channels as NB = 3 * NT columns
//   (n = k*NT + c), K-major in 64-byte K tiles in the 64-byte swizzle
//   (wgmma_desc's layout), staged once per block by the 256 consumer
//   threads from w2p (K, 3Co) (a transpose) or from v7's w2t (Co, 3K) (a
//   plain copy: it is K-major per tap already);
// - the int8 epilogue, rq2 with its constants in registers for the launch,
//   4-byte stores (to global memory, or to a tile in shared memory).
#pragma once

#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int WG_CONSUMERS = 256;     // two warpgroups of 64 tile rows each
constexpr int WG_CHUNK = 128;         // bytes of K per ring stage (SWIZZLE_128B rows)
constexpr int WG_ROWS = 130;          // rows a stage holds: 128 tile rows + 2 for the taps
constexpr int WG_STAGE = 17 * 1024;   // a stage, on the swizzle's 1024-byte atom
static_assert(WG_ROWS * WG_CHUNK <= WG_STAGE, "a stage holds its rows");

__device__ __forceinline__ int requant(int acc, int offset, int shift) {
  const int v = (acc + offset) >> shift;   // arithmetic shift on signed int32
  return min(max(v, 0), 127);
}

// D += A . B for a warpgroup, both K-major from shared memory: A 64 x 16
// bf16 (128-byte rows, wgmma_desc128), B 40 x 16 (wgmma_desc), D 64 x 40
// f32 (n8 block j of row 16w + g in d[4j], d[4j+1], of row 16w + g + 8 in
// d[4j+2], d[4j+3], for warp w of the warpgroup).
__device__ __forceinline__ void wgmma_tap(float (&d)[20], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(1));
}

// The same in int8: A 64 x 32, B 80 x 32, D 64 x 80 int32.
__device__ __forceinline__ void wgmma_tap(int (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

// Keeps the compiler from moving reads of the accumulators above the wait.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r) :: "memory"); }

// The products of one ring stage for a warpgroup, committed as one group:
// A the 64 rows of the stage at st (128 bytes of K each), moved down k rows
// for tap k; B the resident weight's two 64-byte K tiles from wc.
template <int NT, typename Acc>
__device__ __forceinline__ void stage_products(Acc (&acc)[NT / 2], uint32_t st, uint32_t wc) {
  constexpr int NB = 3 * NT;
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)        // the chunk's two 64-byte halves: two K tiles
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wgmma_tap(acc, wgmma_desc128(st + k * WG_CHUNK + 64 * h + 32 * ks),
                  wgmma_desc(wc + h * (NB * 64) + k * (NT * 64) + 32 * ks));
  wgmma_commit();
}

// Byte offset, in the resident weight of NB columns, of K byte kb (a
// multiple of 4) of column n: bytes [16q, 16q + 16) of K tile kb / 64 of
// column n at (kb/64)*NB*64 + n*64 + ((q ^ (n/2 % 4)) << 4).
template <int NB>
__device__ __forceinline__ int w_resident_offset(int n, int kb) {
  return kb / 64 * (NB * 64) + n * 64 + (((kb % 64 / 16) ^ ((n >> 1) & 3)) << 4) + kb % 16;
}

// Once per block, by the consumer threads: the 3 * NT columns (tap k,
// channel co0 + c) of w2p (k_in, 3co), element size ES, transposed into
// k_tiles K tiles; zeros past k_in and co. A thread reads a (4/ES) x (4/ES)
// block of w2p as one 32-bit word per K row and writes it as one word per
// column.
template <int ES, int NT>
__device__ __forceinline__ void stage_w2p_resident(const uint8_t* __restrict__ w2p, int k_in,
                                                   int co, int co0, int k_tiles, uint8_t* ws) {
  constexpr int R = 4 / ES, NB = 3 * NT;
  const int units = (k_tiles * 64 / 4) * (NB / R);
#pragma unroll 4
  for (int i = threadIdx.x; i < units; i += WG_CONSUMERS) {
    const int j = i / (NB / R) * R, n = i % (NB / R) * R;   // first K row, first column
    const int c = co0 + n % NT;
    const uint8_t* src = w2p + (static_cast<long long>(j) * 3 * co + n / NT * co + c) * ES;
    uint32_t r[R], col[R];
#pragma unroll
    for (int e = 0; e < R; ++e)
      r[e] = j + e < k_in && c < co
                 ? *reinterpret_cast<const uint32_t*>(src + static_cast<long long>(e) * 3 * co * ES)
                 : 0u;
    if constexpr (R == 2) {
      col[0] = __byte_perm(r[0], r[1], 0x5410);
      col[1] = __byte_perm(r[0], r[1], 0x7632);
    } else {
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
      col[0] = __byte_perm(t0, t2, 0x5410);
      col[1] = __byte_perm(t0, t2, 0x7632);
      col[2] = __byte_perm(t1, t3, 0x5410);
      col[3] = __byte_perm(t1, t3, 0x7632);
    }
#pragma unroll
    for (int e = 0; e < R; ++e)
      *reinterpret_cast<uint32_t*>(ws + w_resident_offset<NB>(n + e, j * ES)) = col[e];
  }
}

// The same from v7's int8 w2t (NT, 3K), [co][k*K + j]: column k*NT + co is
// the w2t row's tap-k slice, so the copy moves 4-byte words (w2t 4-byte
// aligned), 3 * K * NT bytes in all.
template <int NT, int K>
__device__ __forceinline__ void stage_w2t_resident(const int8_t* __restrict__ w2t, uint8_t* ws) {
  constexpr int NB = 3 * NT, ROW_WORDS = 3 * K / 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(w2t);
#pragma unroll 4
  for (int i = threadIdx.x; i < NT * ROW_WORDS; i += WG_CONSUMERS) {
    const int co = i / ROW_WORDS, r = i % ROW_WORDS;
    *reinterpret_cast<uint32_t*>(ws + w_resident_offset<NB>(r / (K / 4) * NT + co,
                                                            r % (K / 4) * 4)) = __ldg(src + i);
  }
}

// This lane's rq2 constants for the launch: shift and offset of channel
// co0 + 8j + 2*(lane % 4) + e, the channels of its accumulators (0 past co).
template <int NT>
__device__ __forceinline__ void load_rq2(const int* __restrict__ m2, const int* __restrict__ o2,
                                         int co0, int co, int (&shift)[NT / 8][2],
                                         int (&offset)[NT / 8][2]) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = co0 + 8 * j + 2 * tq + e;
      shift[j][e] = ch < co ? __ldg(m2 + ch) : 0;
      offset[j][e] = ch < co ? __ldg(o2 + ch) : 0;
    }
}

// The int8 epilogue of one warp's 16 tile rows: rq2 of its accumulators,
// stored into the (t_out, co) map at `of` (global or shared memory) for
// rows r_lo = (the warp's first row) + lane/4 and r_lo + 8 that lie below
// t_out. Lanes 2i and 2i+1 swap halves so that each stores 4 channels (4
// bytes) of one row: the even lane row r_lo, the odd one row r_lo + 8 (co
// a multiple of 4).
template <int NT>
__device__ __forceinline__ void store_rq2(const int (&acc)[NT / 2], const int (&shift)[NT / 8][2],
                                          const int (&offset)[NT / 8][2], int8_t* of, int r_lo,
                                          int co0, int co, int t_out) {
  const int tq = threadIdx.x & 3;
  const bool odd = tq & 1;
  const int row = odd ? r_lo + 8 : r_lo;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int ch = co0 + 8 * j + 2 * tq;      // this lane's two channels
    const uint32_t lo = requant(acc[4 * j], offset[j][0], shift[j][0]) |
                        requant(acc[4 * j + 1], offset[j][1], shift[j][1]) << 8;
    const uint32_t hi = requant(acc[4 * j + 2], offset[j][0], shift[j][0]) |
                        requant(acc[4 * j + 3], offset[j][1], shift[j][1]) << 8;
    const uint32_t other = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
    const int c4 = ch - 2 * odd;
    if (c4 < co && row < t_out)
      *reinterpret_cast<uint32_t*>(of + static_cast<long long>(row) * co + c4) =
          odd ? other | hi << 16 : lo | other << 16;
  }
}

}  // namespace
