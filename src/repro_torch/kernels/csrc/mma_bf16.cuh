// Warp-level bf16 tensor-core building blocks for sm_80+ (used on Hopper,
// sm_90a): 16-byte cp.async copies, ldmatrix, and the
// mma.sync.m16n8k16 bf16 product with f32 accumulators.
//
// Fragment layouts of m16n8k16 (lane l of the warp, g = l / 4, c = l % 4):
//   A (16 x 16, row-major):  a0 = (row g,     k 2c..2c+1)
//                            a1 = (row g + 8, k 2c..2c+1)
//                            a2 = (row g,     k 2c+8..2c+9)
//                            a3 = (row g + 8, k 2c+8..2c+9)
//   B (16 x 8, "col"):       b0 = (k 2c..2c+1,   col g)
//                            b1 = (k 2c+8..2c+9, col g)
//   C/D (16 x 8, f32):       d0, d1 = (row g,     col 2c, 2c+1)
//                            d2, d3 = (row g + 8, col 2c, 2c+1)
// The accumulator of two neighbouring n8 tiles is exactly an A fragment of
// the next product (d0,d1 -> a0; d2,d3 -> a1; the second tile's -> a2, a3),
// so a result can be fed on in registers once it is rounded to bf16.
// Each 32-bit register holds two bf16, the lower k (or column) in its low
// half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest (0: all
// zeros, and `src` is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i in the fragment layout above.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (for an operand stored
// k-major: V in P V, x in scores x).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores: m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest-even bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 as a bf16 pair `hi` plus the bf16 pair `lo` of what rounding
// left over: hi + lo carries about 16 bits of each value's mantissa, so
// one product becomes two mma on the same other operand.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// A bf16 pair scaled in f32 by (s_a, s_b), then split as above.
__device__ __forceinline__ void scale_split_bf16(uint32_t v, float s_a,
                                                 float s_b, uint32_t& hi,
                                                 uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * s_a, f.y * s_b, hi, lo);
}

// Offset (in elements) of column `col` of row `row` in a bf16 tile of
// `pitch` elements a row.  A tile whose rows are a multiple of 64
// elements (128 bytes) keeps no padding and XORs its 16-byte chunk index
// with row % 8 (swz = 7); any other tile is padded to an odd number of
// 16-byte chunks a row (swz = 0).  Either way the eight rows of one
// ldmatrix phase fall in eight different bank groups.
__device__ __forceinline__ int tile_off(int row, int col, int pitch,
                                        int swz) {
  return row * pitch + ((((col >> 3) ^ (row & swz))) << 3) + (col & 7);
}

// Pitch (elements) and swizzle mask of a tile `width` elements wide
// (a multiple of 16).
__host__ __device__ constexpr int tile_pitch(int width) {
  return width % 64 == 0 ? width : width + 8;
}
__host__ __device__ constexpr int tile_swz(int width) {
  return width % 64 == 0 ? 7 : 0;
}

}  // namespace tc
