// Shared helpers of the kernels in this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>
#include <map>
#include <mutex>
#include <utility>

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

// Streaming multiprocessors of the current device (0 if it cannot be
// read): the size of a persistent grid.  Read once a device.
inline int device_sms() {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not read yet
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kDevices && (sms = known[dev].load()) > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kDevices) known[dev].store(sms);
  return sms;
}

constexpr size_t kSmemPerSm = 228 * 1024;  // an SM's: the carveout's 100%

// Sets the kernel's shared memory and carveout and returns the blocks an
// SM runs: as many as fit, at most `max_blocks` (0: no cap), the carveout
// then just large enough for them.  Both are attributes of the kernel, so
// they are set again only when a launch asks for other values than the
// kernel's last: a kernel launched at one size makes these calls once.
template <class K>
cudaError_t fit_blocks(K kern, int threads, size_t smem, int max_blocks,
                       int* per_sm) {
  struct Fit {
    int threads;
    size_t smem;
    int max_blocks, per_sm;
  };
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, Fit> last;  // (device, kernel)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_pair(dev, reinterpret_cast<const void*>(kern));
  std::lock_guard<std::mutex> lock(mu);
  const auto it = last.find(key);
  if (it != last.end() && it->second.threads == threads &&
      it->second.smem == smem && it->second.max_blocks == max_blocks) {
    *per_sm = it->second.per_sm;
    return cudaSuccess;
  }
  last.erase(key);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutDefault);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidValue;
  if (max_blocks > 0 && *per_sm > max_blocks) {
    *per_sm = max_blocks;
    const size_t want = max_blocks * (smem + 1024);  // 1 KB a block kept
    const int carve = static_cast<int>((want * 100 + kSmemPerSm - 1) /
                                       kSmemPerSm);
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        carve < 100 ? carve : 100);
    if (e != cudaSuccess) return e;
  }
  last[key] = Fit{threads, smem, max_blocks, *per_sm};
  return cudaSuccess;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vda
