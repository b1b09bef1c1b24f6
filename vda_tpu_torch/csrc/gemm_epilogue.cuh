// The epilogues of the K11/K13 GEMM (gemm_sm90.cuh, and the mma.sync loop
// of gemm_sm80.cuh that it replaced).  An epilogue gets the sums of two
// neighbouring columns (col, col + 1; col even) of one output row and
// returns them packed as the output stores them (pair); store_pair writes
// the pair to out (M, N) row-major.
#pragma once

#include "common.cuh"

namespace vda {
namespace gemm {

using bf16 = __nv_bfloat16;

// K11: ((acc * sx[row]) * sw[col]) + b[col] with __fmul_rn / __fadd_rn in
// that order, so nvcc cannot contract it into an FMA: the int32 sums are
// exact, and K11 is bit-identical with its plain twin.
template <typename Out_>
struct Dequant {
  using Out = Out_;
  const float* sx;
  const float* sw;  // sw and b 8-byte aligned: col is even
  const float* b;
  Out* out;
  int n;
  static __device__ __forceinline__ float at(int acc, float s, float w,
                                             float c) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), w), c);
  }
  __device__ __forceinline__ auto pair(int row, int col, int a0,
                                       int a1) const {
    const float s = sx[row];
    const float2 w = *reinterpret_cast<const float2*>(sw + col);
    const float2 c = *reinterpret_cast<const float2*>(b + col);
    if constexpr (sizeof(Out) == 4)
      return make_float2(at(a0, s, w.x, c.x), at(a1, s, w.y, c.y));
    else
      return __floats2bfloat162_rn(at(a0, s, w.x, c.x), at(a1, s, w.y, c.y));
  }
};

// K13: the int32 sums as they are, or the fp32 sums rounded to bf16.
struct StoreI32 {
  using Out = int;
  Out* out;
  int n;
  __device__ __forceinline__ int2 pair(int, int, int a0, int a1) const {
    return make_int2(a0, a1);
  }
};
struct StoreBf16 {
  using Out = bf16;
  Out* out;
  int n;
  __device__ __forceinline__ __nv_bfloat162 pair(int, int, float a0,
                                                 float a1) const {
    return __floats2bfloat162_rn(a0, a1);
  }
};

template <class Epi, typename Acc>
__device__ __forceinline__ void store_pair(const Epi& epi, int row, int col,
                                           Acc a0, Acc a1) {
  auto v = epi.pair(row, col, a0, a1);
  *reinterpret_cast<decltype(v)*>(epi.out + static_cast<size_t>(row) * epi.n +
                                  col) = v;
}

// Shapes the entry points take: k * elem a multiple of 16 bytes (a row of A
// or B is a whole number of 16-byte chunks: TMA's global strides, the old
// loop's cp.async), n a multiple of 8 (pairs of columns are stored
// together, and the TMA store's row stride is 16-byte aligned).
inline bool shape_ok(int m, int n, int k, int elem) {
  return m > 0 && n > 0 && k > 0 && (k * elem) % 16 == 0 && n % 8 == 0;
}

}  // namespace gemm
}  // namespace vda
