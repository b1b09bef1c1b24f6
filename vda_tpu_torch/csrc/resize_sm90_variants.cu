// The design steps of K10's Hopper kernel (resize_sm90.cuh), for the
// measurements of probes/bench_resize_sm90.py.  The operands of
// vda_resize_bilinear; `variant` picks the step:
//   0 old         the kernel resize_sm90.cuh replaced: the TPU kernel's
//                 grid (a block a batch row and a block of output rows), a
//                 thread 8 channels of one output pixel from four 16-byte
//                 input loads, the row lerp redone for each of its taps
//   1 sm90        the Hopper kernel: vda_resize_bilinear's own (a unit an
//                 output row and slice, slices of at most 40 KB, at most 3
//                 blocks an SM)
//   2 loads       1's input loads alone (nothing lerped or written)
//   3 stores      1's output stores alone (zeros, nothing read)
// `keep` is 0 from every caller: the loads step keeps its results alive on
// a branch no run takes.

#include "resize_sm90.cuh"

namespace vda {
namespace {

constexpr int NT = 256;
using bf16 = __nv_bfloat16;

// itab: i0 (oh) | i1 (oh) | j0 (ow) | j1 (ow); ftab: w1 (oh) | m0 (ow) |
// m1 (ow).
__global__ void __launch_bounds__(NT)
    resize_sm80_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                       const int* __restrict__ itab,
                       const float* __restrict__ ftab, int oh, int ow, int c,
                       int br, long long sb, long long sh, long long sw) {
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
        const float ra = resize90::lerp_row(a0[e], a1[e], s, t);
        const float rb = resize90::lerp_row(b0[e], b1[e], s, t);
        r[e] = from_f<bf16>(__fadd_rn(__fmul_rn(ma, ra), __fmul_rn(mb, rb)));
      }
      *reinterpret_cast<uint4*>(o + static_cast<size_t>(col) * c + ch) = res;
    }
  }
}

}  // namespace
}  // namespace vda

using namespace vda::resize90;

// The old kernel's row block: pallas_resize._pick_block, the TPU kernel's.
static int pick_block(int oh) {
  const int blocks[] = {16, 14, 8, 7};
  for (int br : blocks)
    if (oh % br == 0) return br;
  return 0;
}

extern "C" int vda_resize_variant(const void* x, void* out, const int* itab,
                                  const float* ftab, int b, int w, int oh,
                                  int ow, int c, long long sb, long long sh,
                                  long long sw, int keep, int variant,
                                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out), itab,
               ftab, b, w, oh, ow, c, sb, sh, sw, keep};
  switch (variant) {
    case 0: {
      const int br = pick_block(oh);
      if (b <= 0 || c <= 0 || c % 8 || !br || sb % 8 || sh % 8 || sw % 8)
        return cudaErrorInvalidValue;
      vda::resize_sm80_kernel<<<dim3(oh / br, b), vda::NT, 0, st>>>(
          a.x, a.out, itab, ftab, oh, ow, c, br, sb, sh, sw);
      return cudaGetLastError();
    }
    case 1: return launch<kFull>(a, st);
    case 2: return launch<kLoads>(a, st);
    case 3: return launch<kStores>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
