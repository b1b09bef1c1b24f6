// K8: block-diagonal (varlen) multi-head self-attention over packed
// segments.  Rows are len(segment_lengths) back-to-back sequences; q, k and
// v are (total, H*D) with one row stride, and attention never crosses a
// segment boundary.  Replaces vda_tpu/ops/pallas_attention.py
// segment_attention (_segment_kernel).
//
// The TPU kernel bin-packed the segments into 128-aligned bins of `cap`
// rows, gathered them, held a whole (cap, cap) fp32 score tile per head in
// VMEM with a segment-id mask, and scattered the result back.  None of that
// layout is kept: this is a varlen flash attention over the segments'
// offsets.  The host turns the static lengths into a table of query tiles,
// one int4 {segment start, segment length, first query row, 0} per 64-row
// tile of each segment, copied to the card once per shape; one block of 4
// warps per (tile, head) runs K1's loop (flash_attention.cuh) with the
// segment's first row as its row base and the segment's length as both its
// row count and its key count.  So K/V tiles walk from the segment's start
// to its end, the last one straddling the end is zero-filled and masked,
// query rows past the end are computed from zero queries and never stored,
// and nothing is gathered, padded or scattered.
//
// What bounds it on the H100: at DINOv2's multi-crop shapes (segments of
// 257 and 50 rows) bytes, 4*total*H*D elements in and out; a single long
// segment (1370) is bound by operations, like K1.  A 50-row segment leaves
// 14 of its tile's 64 query rows idle: short segments waste a share of the
// tensor-core work, never of the bytes.

#include "flash_attention.cuh"

namespace vda {
namespace {

using namespace flash;

template <int DP>
__global__ void __launch_bounds__(NT)
    segment_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        const int4* __restrict__ tiles, size_t rs, int heads,
                        int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 tile = tiles[blockIdx.x];
  const int start = tile.x, len = tile.y, q0 = tile.z, h = blockIdx.y;
  const int hd = heads * d;
  const size_t off = static_cast<size_t>(start) * rs + h * d;
  bf16* ob = out + static_cast<size_t>(start) * hd + h * d;
  attend_bf16<DP>(q + off, k + off, v + off, rs, len, d, len, scale, q0,
                  reinterpret_cast<bf16*>(smem),
                  [&](int r, int col, float v0, float v1) {
                    const int row = q0 + r;
                    if (row < len)
                      *reinterpret_cast<__nv_bfloat162*>(
                          ob + static_cast<size_t>(row) * hd + col) =
                          __floats2bfloat162_rn(v0, v1);
                  });
}

template <int DP>
__global__ void __launch_bounds__(NT)
    segment_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       const int4* __restrict__ tiles, size_t rs, int heads,
                       int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4 tile = tiles[blockIdx.x];
  const int start = tile.x, len = tile.y, q0 = tile.z, h = blockIdx.y;
  const int hd = heads * d;
  const size_t off = static_cast<size_t>(start) * rs + h * d;
  float* ob = out + static_cast<size_t>(start) * hd + h * d;
  attend_f32<DP>(q + off, k + off, v + off, rs, len, d, len, scale, q0, smem,
                 [&](int r, int c, float val) {
                   if (q0 + r < len)
                     ob[static_cast<size_t>(q0 + r) * hd + c] = val;
                 });
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int4* tiles, int n_tiles, int heads, int d,
                   size_t rs, float scale, bool bf, cudaStream_t stream) {
  const dim3 grid(n_tiles, heads);
  const size_t bytes = bf ? Bf16Tiles<DP>::bytes : F32Tiles<DP>::bytes;
  cudaError_t e;
  if (bf) {
    auto kern = segment_bf16_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), tiles, rs,
        heads, d, scale);
  } else {
    auto kern = segment_f32_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), tiles, rs,
        heads, d, scale);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace vda

// q, k, v: row 0, 16-byte aligned; row t at x + t * row_stride (a multiple
// of 8 elements, at least H*D).  tiles: n_tiles int4 {start, length, q0, 0}
// on the device, every start + length within the rows.  out: contiguous
// (total, H*D).
extern "C" int vda_segment_attention(const void* q, const void* k,
                                     const void* v, void* out,
                                     const void* tiles, int n_tiles,
                                     int heads, int d, long long row_stride,
                                     float scale, int is_bf16, void* stream) {
  if (n_tiles <= 0 || heads <= 0 || row_stride < 1LL * heads * d ||
      row_stride % 8)
    return cudaErrorInvalidValue;
  const size_t rs = static_cast<size_t>(row_stride);
  const bool bf = is_bf16 != 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tl = static_cast<const int4*>(tiles);
  switch (vda::flash::padded_width(d)) {
    case 16: return vda::launch<16>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 32: return vda::launch<32>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 48: return vda::launch<48>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 64: return vda::launch<64>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 80: return vda::launch<80>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 96: return vda::launch<96>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 112: return vda::launch<112>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 128: return vda::launch<128>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    default: return cudaErrorInvalidValue;
  }
}
