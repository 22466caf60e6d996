// Warp-level tensor-core and asynchronous-copy helpers (sm_80 instructions,
// all present on sm_90a): 16-byte cp.async with zero fill, ldmatrix of four
// 8x8 bf16 matrices (plain and transposed), the m16n8k16 bf16 MMA with f32
// accumulators, packing two f32 values into a bf16 pair, and 2^x on the
// special-function unit.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * group + quad):
//   A (16x16, row-major), regs a0..a3: rows group / group + 8, columns
//     2 * quad + {0, 1} (a0, a1) and 8 + 2 * quad + {0, 1} (a2, a3);
//   B (16x8, column-major), regs b0, b1: column group, rows 2 * quad + {0, 1}
//     (b0) and 8 + 2 * quad + {0, 1} (b1);
//   C/D (16x8 f32), c0..c3: row group (c0, c1) and group + 8 (c2, c3),
//     columns 2 * quad + {0, 1}.
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

// d += a * b for one 16x8x16 tile, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace repro
