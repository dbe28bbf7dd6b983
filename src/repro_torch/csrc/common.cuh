// Shared helpers of the port's CUDA kernels.
//
// Every kernel library exposes plain C entry points (loaded from Python with
// ctypes by kernels/_build.py).  Each entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() so that a refused
// launch surfaces in the Python wrapper instead of vanishing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Defines the error-string export every library carries.
#define REPRO_DEFINE_ERROR_STRING                                   \
  REPRO_EXPORT const char* repro_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }

namespace repro {

// dtype codes; kernels/_build.py::DTYPE_CODES holds the same table.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: what a value "cast to T" carries.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace repro
