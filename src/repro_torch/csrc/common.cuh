// Helpers shared by the port's hand-written Hopper kernels: vector loads
// that widen f32 / bf16 elements to f32 registers, the
// narrowing store back to the element type, the XOR swizzle of staged
// tiles, and the error-string lookup each library exports to its ctypes
// wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

// Element type codes shared with the Python wrappers (kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load N consecutive elements starting at `src` (aligned to N * sizeof(T))
// with one vector load and widen them to f32.  N * sizeof(T) must be 4, 8
// or 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* __restrict__ src, float (&dst)[N]) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4, "4-, 8- or 16-byte loads only");
  using Vec = typename std::conditional<
      kBytes == 16, uint4, typename std::conditional<kBytes == 8, uint2, uint32_t>::type>::type;
  Vec raw = *reinterpret_cast<const Vec*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f32(e[i]);
}

// Physical 16-byte chunk of chunk c of row r in a shared-memory tile of
// CHUNKS 16-byte chunks a row, XOR-swizzled so that the 8 rows r0 .. r0 + 7
// (r0 a multiple of 8) an ldmatrix reads at one chunk land in 8 different
// groups of 4 banks.  A row of whole groups of 8 chunks starts on a 128-byte
// line: every group XORs with r & 7.  A row of 8 n + 4 chunks (bf16 rows of
// 96 or 288 elements) starts half a line after the row before it: chunk c'
// of a whole group lands in bank group (4 r + (c' ^ (r & 7))) mod 8, and
// chunk c' of the 4-chunk tail, which XORs with (r >> 1) & 3, in (4 r + (c'
// ^ ((r >> 1) & 3))) mod 8; each takes 8 values over the 8 rows.  A row of
// 8 n + 2 chunks (bf16 rows of 80 elements) starts a quarter line after the
// row before it: a whole group's chunk c' lands in (2 r + (c' ^ (r & 7)))
// mod 8, and chunk c' of the 2-chunk tail, which XORs with (r >> 2) & 1, in
// (2 r + (c' ^ ((r >> 2) & 1))) mod 8: rows r and r + 4 share 2 r mod 8 and
// part on the low bit.  Each takes 8 values over the 8 rows (checked by
// enumeration of every row width the kernels stage).
template <int CHUNKS>
__device__ __forceinline__ int swizzle_chunk(int r, int c) {
  constexpr int kRem = CHUNKS % 8;
  static_assert(kRem == 0 || kRem == 4 || kRem == 2, "rows of 8 n, 8 n + 4 or 8 n + 2 chunks");
  constexpr int kTail = CHUNKS - kRem;  // first chunk of the tail
  if (kRem == 0 || c < kTail) return c ^ (r & 7);
  if (kRem == 4) return kTail + ((c - kTail) ^ ((r >> 1) & 3));
  return kTail + ((c - kTail) ^ ((r >> 2) & 1));
}

}  // namespace repro

// Every library exports the CUDA error name lookup, so its wrapper can put
// the reason for a non-zero return code into the exception it raises.
#define REPRO_EXPORT_ERROR_STRING                                   \
  extern "C" const char* repro_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
