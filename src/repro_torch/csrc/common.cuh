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

// Tensor-core helpers shared by the bf16 GEMM kernels.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way: lane t receives column t/4,
// rows 2*(t%4) and +1, of the stored 8x8 matrix -- the fragment of an
// operand whose shared tile is stored with the other dimension contiguous.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// D(16 x 8, f32) += A(16 x 16, row-major) . B(16 x 8, column-major), bf16.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy to shared memory; `in` false writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The second pass of a deterministic split-k: out = sum over splits of
// ws[s] (mn f32 partials each), added in split order, cast to T.
template <typename T>
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, T* __restrict__ out, size_t mn, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += ws[s * mn + i];
    out[i] = from_float<T>(sum);
  }
}

// splitk_reduce on `programs` blocks of 256 threads (the grid of the
// wrapper's spec, kernels/common.py::splitk_reduce_spec).
template <typename T>
cudaError_t launch_splitk_reduce(const float* ws, T* out, size_t mn, int splits, int programs,
                                 cudaStream_t s) {
  if (programs < 1) return cudaErrorInvalidValue;
  splitk_reduce<T><<<programs, 256, 0, s>>>(ws, out, mn, splits);
  return cudaGetLastError();
}

// The grid a wrapper declared (kernels/gridspec.py), as the dim3 to
// launch; false for one CUDA cannot take (an extent below 1, y or z over
// 65535), and the entry point then returns cudaErrorInvalidValue.  No
// entry point computes a grid of its own or corrects the one it is given.
inline bool declared_grid(int x, int y, int z, dim3& grid) {
  if (x < 1 || y < 1 || z < 1 || y > 65535 || z > 65535) return false;
  grid = dim3(static_cast<unsigned>(x), static_cast<unsigned>(y), static_cast<unsigned>(z));
  return true;
}

// Host-side facts a launch needs on every call, looked up once per device.
constexpr int kMaxDevices = 64;

inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// Lets `Kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB), once per device.
template <auto Kernel>
cudaError_t allow_dynamic_smem(int bytes) {
  static bool done[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

}  // namespace repro
