// Warp-level tensor-core and asynchronous-copy helpers (sm_80 instructions,
// all present on sm_90a): 16-byte cp.async with zero fill, ldmatrix of four
// or two 8x8 bf16 matrices (plain and transposed), the m16n8k16 and m16n8k8
// bf16 MMAs with f32 accumulators, packing two f32 values into a bf16 pair,
// 2^x on the special-function unit, and f32 products on the tensor cores as
// three TF32 products (the TF32 rounding, the split of an f32 value into two
// TF32 values, the m16n8k8 TF32 MMA).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * group + quad):
//   A (16x16, row-major), regs a0..a3: rows group / group + 8, columns
//     2 * quad + {0, 1} (a0, a1) and 8 + 2 * quad + {0, 1} (a2, a3);
//   B (16x8, column-major), regs b0, b1: column group, rows 2 * quad + {0, 1}
//     (b0) and 8 + 2 * quad + {0, 1} (b1);
//   C/D (16x8 f32), c0..c3: row group (c0, c1) and group + 8 (c2, c3),
//     columns 2 * quad + {0, 1}.
// Fragment layouts of mma.m16n8k8 with TF32 inputs (one 32-bit register per
// element; C/D as above):
//   A (16x8, row-major), a0..a3: (group, quad), (group + 8, quad),
//     (group, quad + 4), (group + 8, quad + 4);
//   B (8x8, column-major), b0, b1: column group, rows quad (b0) and
//     quad + 4 (b1).
// ldmatrix (b16) loads these from row-major f32 tiles too: an 8x8 b16
// matrix is 8 rows of 4 f32 words, and a lane receives word lane % 4 of row
// lane / 4.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; when `valid` is false nothing is read and the 16 bytes are
// zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lanes 8i..8i+7 give the row addresses of matrix i; each lane receives
// row lane / 4, columns 2 * (lane % 4) + {0, 1} of every matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// As ldmatrix_x4, each matrix transposed: a lane receives rows
// 2 * (lane % 4) + {0, 1}, column lane / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem)));
}

// As ldmatrix_x4 for two matrices: lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(smem)));
}

// As ldmatrix_x4_trans for two matrices: lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(smem)));
}

// d += a * b for one 16x8x16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b for one 16x8x8 tile, bf16 inputs, f32 accumulators: A (16x8)
// a0 = row group, columns 2 * quad + {0, 1}, a1 the same of row group + 8
// (the C/D layout of those rows, packed to bf16 pairs); B (8x8) b0 = rows
// 2 * quad + {0, 1}, column group.
__device__ __forceinline__ void mma_bf16_1688(float (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// Two f32 values rounded to a bf16 pair, `lo` in the low half (the lower
// column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit in one instruction (ex2.approx.ftz:
// about 2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32 -> TF32 rounded to nearest, ties away from zero, on 10 explicit
// mantissa bits: an f32 bit pattern whose low 13 bits are 0.  Half a TF32
// ulp is added to the magnitude and the low 13 bits cleared, which gives
// cvt.rna.tf32.f32's result for every input but a NaN whose top mantissa
// bits are all set (the canonical 0x7fffffff becomes a zero; split_tf32's
// small part keeps it a NaN).  Two integer operations: cvt.rna for big made
// the f32 flash kernel 14-18% slower on an NVIDIA H100 (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big + small, the split of every operand of a 3xTF32 product
// (CUTLASS's "fast accurate f32"): big = tf32_rna(x), and small = x - big
// (exact in f32) truncated to TF32, one AND.  |small| <= 2^-11 |x|, and the
// pair holds x to within 2^-21 of it; a NaN or infinite x leaves small a
// NaN, so it propagates.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// The four f32 words of a fragment, each split into TF32 big and small.
__device__ __forceinline__ void split_x4(const uint32_t (&x)[4], uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), big[i], small[i]);
}

// d += a * b for one 16x8x8 tile, TF32 inputs, f32 accumulators.  Three of
// these on split operands (big * big + big * small + small * big; the
// dropped small * small is below 2^-22 of |a| |b|, the order of f32
// rounding) take an f32 product to f32 accuracy: CUTLASS's "fast accurate
// f32" scheme.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
