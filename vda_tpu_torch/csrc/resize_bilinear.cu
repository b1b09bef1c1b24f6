// K10: bf16 NHWC bilinear upsample with align_corners=True.
//
// Replaces vda_tpu/ops/pallas_resize.py resize_bilinear_fused
// (_resize_kernel): the decoder tail's (B, 148, 148, 256) -> (296, 296) and
// (B, 296, 296, 128) -> (518, 518) resizes.
//
// The function, as the TPU kernel computes it: output row i is the fp32
// lerp r0 * (1 - t) + r1 * t of input rows i0 and i1 (t the fp32 weight of
// the row tables, not rounded), rounded to bf16; output column j then sums
// the two taps of that row at columns j0 and j1 weighted by the bf16-rounded
// entries of the (W_out, W_in) interpolation matrix (one tap of weight 1 at
// the clipped edge), accumulated in fp32 and rounded once.  The TPU ran the
// W pass as a dense MXU matmul because that is how a TPU does a 2-tap
// filter; the matrix has two nonzeros a row, so here the two taps are read
// directly.  Both products of the W pass are exact in fp32 (bf16 times
// bf16), so the sum has one rounding whatever its order; every step uses
// __fmul_rn/__fadd_rn, so nvcc contracts nothing into an FMA and the kernel
// is bit-exact with its plain twin.
//
// What bounds it on the H100: bytes (a few operations per element).  Each
// thread owns 8 channels of one output pixel (16-byte loads and stores,
// neighbouring threads on neighbouring channels); the four input vectors it
// reads are shared with its neighbours through L1/L2, and the (B, H_out,
// W_in, C) intermediate of the separable form never exists.  One block owns
// one batch row and one block of output rows, the TPU kernel's grid, and
// reads each output row's two input rows from the row tables.  The input may
// be strided along B, H and W.

#include "common.cuh"

namespace vda {
namespace {

constexpr int NT = 256;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float lerp_row(bf16 a, bf16 b, float s, float t) {
  return round_t<bf16>(
      __fadd_rn(__fmul_rn(to_f(a), s), __fmul_rn(to_f(b), t)));
}

// itab: i0 (oh) | i1 (oh) | j0 (ow) | j1 (ow); ftab: w1 (oh) | m0 (ow) |
// m1 (ow).
__global__ void __launch_bounds__(NT)
    resize_bilinear_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                           const int* __restrict__ itab,
                           const float* __restrict__ ftab, int oh, int ow,
                           int c, int br, long long sb, long long sh,
                           long long sw) {
  const int blk = blockIdx.x, b = blockIdx.y;
  const int* i0 = itab;
  const int* i1 = i0 + oh;
  const int* j0 = i1 + oh;
  const int* j1 = j0 + ow;
  const float* w1 = ftab;
  const float* m0 = w1 + oh;
  const float* m1 = m0 + ow;
  const int cv = c / 8;
  const bf16* xb = x + b * sb;
  for (int rr = 0; rr < br; ++rr) {
    const int row = blk * br + rr;
    const bf16* x0 = xb + i0[row] * sh;
    const bf16* x1 = xb + i1[row] * sh;
    const float t = w1[row], s = __fsub_rn(1.f, t);
    bf16* o = out + (static_cast<size_t>(b) * oh + row) * ow * c;
    for (int i = threadIdx.x; i < ow * cv; i += NT) {
      const int col = i / cv, ch = (i % cv) * 8;
      const long long ca = j0[col] * sw + ch, cb = j1[col] * sw + ch;
      const float ma = m0[col], mb = m1[col];
      const uint4 va0 = __ldg(reinterpret_cast<const uint4*>(x0 + ca));
      const uint4 va1 = __ldg(reinterpret_cast<const uint4*>(x1 + ca));
      const uint4 vb0 = __ldg(reinterpret_cast<const uint4*>(x0 + cb));
      const uint4 vb1 = __ldg(reinterpret_cast<const uint4*>(x1 + cb));
      const bf16* a0 = reinterpret_cast<const bf16*>(&va0);
      const bf16* a1 = reinterpret_cast<const bf16*>(&va1);
      const bf16* b0 = reinterpret_cast<const bf16*>(&vb0);
      const bf16* b1 = reinterpret_cast<const bf16*>(&vb1);
      uint4 res;
      bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ra = lerp_row(a0[e], a1[e], s, t);
        const float rb = lerp_row(b0[e], b1[e], s, t);
        r[e] = from_f<bf16>(__fadd_rn(__fmul_rn(ma, ra), __fmul_rn(mb, rb)));
      }
      *reinterpret_cast<uint4*>(o + static_cast<size_t>(col) * c + ch) = res;
    }
  }
}

}  // namespace
}  // namespace vda

// x: (B, H, W, C) bf16 with element strides sb, sh, sw (each a multiple of
// 8) and unit channel stride, 16-byte aligned; out: contiguous (B, OH, OW,
// C) bf16; C % 8 == 0, OH % br == 0; itab/ftab the tables above, on the
// device.
extern "C" int vda_resize_bilinear(const void* x, void* out, const int* itab,
                                   const float* ftab, int b, int oh, int ow,
                                   int c, int br, long long sb, long long sh,
                                   long long sw, void* stream) {
  if (b <= 0 || c <= 0 || c % 8 || br <= 0 || oh % br || sb % 8 || sh % 8 ||
      sw % 8)
    return cudaErrorInvalidValue;
  const dim3 grid(oh / br, b);
  vda::resize_bilinear_kernel<<<grid, vda::NT, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      itab, ftab, oh, ow, c, br, sb, sh, sw);
  return cudaGetLastError();
}
