// Helpers shared by the port's hand-written Hopper kernels: vector loads
// that widen f32 / bf16 elements to f32 registers, the
// narrowing store back to the element type, and the error-string lookup each
// library exports to its ctypes wrapper.
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

}  // namespace repro

// Every library exports the CUDA error name lookup, so its wrapper can put
// the reason for a non-zero return code into the exception it raises.
#define REPRO_EXPORT_ERROR_STRING                                   \
  extern "C" const char* repro_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
