// Shared helpers of the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace vda {

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and back: the value a T-typed intermediate holds.
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

// Copy one row of `n` elements (n * sizeof(T) a multiple of 16 bytes, both
// pointers 16-byte aligned) with 16-byte vectors; lanes of a thread group
// of `stride` threads starting at `first` share the work.
template <typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int n,
                                         int first, int stride) {
  constexpr int VE = 16 / sizeof(T);
  for (int c = first * VE; c < n; c += stride * VE)
    *reinterpret_cast<uint4*>(dst + c) =
        *reinterpret_cast<const uint4*>(src + c);
}

template <typename T>
__device__ __forceinline__ void zero_row(T* dst, int n, int first,
                                         int stride) {
  constexpr int VE = 16 / sizeof(T);
  for (int c = first * VE; c < n; c += stride * VE)
    *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vda
