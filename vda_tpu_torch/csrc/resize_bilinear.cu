// K10: bf16 NHWC bilinear upsample with align_corners=True.
//
// Replaces vda_tpu/ops/pallas_resize.py resize_bilinear_fused
// (_resize_kernel): the decoder tail's (B, 148, 148, 256) -> (296, 296) and
// (B, 296, 296, 128) -> (518, 518) resizes.  The kernel, its function and
// its design are in resize_sm90.cuh; the kernel it replaced is step 0 of
// resize_sm90_variants.cu.

#include "resize_sm90.cuh"

// x: (B, H, W, C) bf16 with element strides sb, sh, sw (each a multiple of
// 8) and unit channel stride, 16-byte aligned; out: contiguous (B, OH, OW,
// C) bf16; C % 8 == 0; itab/ftab the tables of resize_sm90.cuh, on the
// device.
extern "C" int vda_resize_bilinear(const void* x, void* out, const int* itab,
                                   const float* ftab, int b, int w, int oh,
                                   int ow, int c, long long sb, long long sh,
                                   long long sw, void* stream) {
  using namespace vda::resize90;
  const Args a{static_cast<const bf16*>(x), static_cast<bf16*>(out), itab,
               ftab, b, w, oh, ow, c, sb, sh, sw, 0};
  return launch<kFull>(a, static_cast<cudaStream_t>(stream));
}
