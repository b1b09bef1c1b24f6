// The epilogues of the K11/K13 GEMM (gemm_sm90.cuh, and the mma.sync loop
// of gemm_sm80.cuh that it replaced) and of K3/K4's products on it.  An
// epilogue gets the sums of two neighbouring columns (col, col + 1; col
// even) of one output row and returns them packed as the output stores
// them (pair); store_pair writes the pair to out (M, N) row-major.
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

// K3's and K4's products on the Hopper loop (temporal_sm90.cuh) carry the
// kernel they serve as a tag in their epilogue's type, so that a profile
// tells their launches from K13's and from each other
// (utils/profiling.py).  Rounding as the TPU kernel's
// (pallas_temporal.py): each sum plus its bias rounded to bf16 once.
struct TemporalK3 {};
struct TemporalK4 {};

// q | k | v: the sums rounded to bf16 (the projections have no bias).
template <class Tag>
struct QkvStore {
  using Out = bf16;
  Out* out;
  int n;
  __device__ __forceinline__ __nv_bfloat162 pair(int, int, float a0,
                                                 float a1) const {
    return __floats2bfloat162_rn(a0, a1);
  }
};

// out = h + bf16(acc + b[col]), the sum in bf16 (the sub-block's and the
// feed-forward's residual).  h may be out itself: each pair is read before
// it is written, by the thread that writes it.
template <class Tag>
struct Residual {
  using Out = bf16;
  const bf16* h;   // (M, n)
  const float* b;  // (n,), 8-byte aligned: col is even
  Out* out;
  int n;
  // h's 128-byte line at (row, col) into L2 (gemm_sm90.cuh: at the start
  // of a tile, so that the epilogue's reads of h do not wait on DRAM)
  __device__ __forceinline__ void prefetch(int row, int col) const {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        h + static_cast<size_t>(row) * n + col));
  }
  __device__ __forceinline__ __nv_bfloat162 pair(int row, int col, float a0,
                                                 float a1) const {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
        h + static_cast<size_t>(row) * n + col);
    const float2 c = *reinterpret_cast<const float2*>(b + col);
    const float y0 = __bfloat162float(__float2bfloat16_rn(a0 + c.x));
    const float y1 = __bfloat162float(__float2bfloat16_rn(a1 + c.y));
    return __floats2bfloat162_rn(__low2float(x) + y0, __high2float(x) + y1);
  }
};

// tanh by the SFU's approximation (max relative error ~2^-11, under
// half a bf16 ulp): GEGLU's GELU is rounded to bf16 right after, and tanhf
// made the GEGLU product 3x its bound (PERF.md, section 6).
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// GEGLU over the proj product's two halves (a paired epilogue,
// gemm_sm90.cuh): x1 = bf16(acc_x + b[col]), gate = bf16(acc_g + b[n +
// col]), out = bf16(x1 * bf16(gelu_tanh(gate))), n hidden columns.  Its
// roundings are packed conversions of two columns, and x1 * gelu a bf16x2
// product (the exact product of two bf16 values rounded once, as in fp32):
// the epilogue's instructions bound the product at vitl's mm3.
template <class Tag>
struct Geglu {
  static constexpr bool paired = true;
  using Out = bf16;
  const float* b;  // (2n,): x1's biases, then the gate's
  Out* out;
  int n;
  static __device__ __forceinline__ float gelu(float v) {
    return 0.5f * v *
           (1.f + tanh_approx(0.7978845608028654f *
                              (v + 0.044715f * v * v * v)));
  }
  __device__ __forceinline__ __nv_bfloat162 pair(int, int col, float x0,
                                                 float x1, float g0,
                                                 float g1) const {
    const float2 bx = *reinterpret_cast<const float2*>(b + col);
    const float2 bg = *reinterpret_cast<const float2*>(b + n + col);
    const __nv_bfloat162 u = __floats2bfloat162_rn(x0 + bx.x, x1 + bx.y);
    const float2 v =
        __bfloat1622float2(__floats2bfloat162_rn(g0 + bg.x, g1 + bg.y));
    return __hmul2(u, __floats2bfloat162_rn(gelu(v.x), gelu(v.y)));
  }
};

// The packed pair v at (row, col) of out (M, epi.n) row-major.
template <class Epi, typename V>
__device__ __forceinline__ void store_value(const Epi& epi, int row, int col,
                                            V v) {
  *reinterpret_cast<V*>(epi.out + static_cast<size_t>(row) * epi.n + col) = v;
}

template <class Epi, typename Acc>
__device__ __forceinline__ void store_pair(const Epi& epi, int row, int col,
                                           Acc a0, Acc a1) {
  store_value(epi, row, col, epi.pair(row, col, a0, a1));
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
