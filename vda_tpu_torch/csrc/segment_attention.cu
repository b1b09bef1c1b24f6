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
// offsets, by one of two codes chosen by head width and dtype
// (vda_segment_loop): bf16 at head width 64 (every main path) the Hopper
// code of segment_sm90.cuh over the host's work table of query-tile
// passes; fp32 and other widths the mma.sync loop below.  For
// the latter the host turns the static lengths into a table of query tiles,
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
#include "segment_sm90.cuh"

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

cudaError_t segment_sm80(const void* q, const void* k, const void* v,
                         void* out, const void* tiles, int n_tiles, int heads,
                         int d, long long row_stride, float scale, bool bf,
                         cudaStream_t st) {
  if (n_tiles <= 0 || heads <= 0 || row_stride < 1LL * heads * d ||
      row_stride % 8)
    return cudaErrorInvalidValue;
  const size_t rs = static_cast<size_t>(row_stride);
  const auto* tl = static_cast<const int4*>(tiles);
  switch (flash::padded_width(d)) {
    case 16: return launch<16>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 32: return launch<32>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 48: return launch<48>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 64: return launch<64>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 80: return launch<80>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 96: return launch<96>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 112: return launch<112>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    case 128: return launch<128>(q, k, v, out, tl, n_tiles, heads, d, rs, scale, bf, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vda

// The code vda_segment_attention runs at this head width: 90 (the Hopper
// code of segment_sm90.cuh: bf16 at head width 64) or 80 (the loop above).
extern "C" int vda_segment_loop(int d, int is_bf16) {
  return is_bf16 && d == vda::seg90::D ? 90 : 80;
}

// q, k, v: row 0, 16-byte aligned; row t at x + t * row_stride (a multiple
// of 8 elements, at least H*D).  tiles: n_tiles int4 {start, length, q0, 0}
// (the loop above's table); items: n_items records of 16 ints (the Hopper
// code's work table, ops/segment_kernel.py work_table) whose longest key
// span is max_span; both on the device, every row they name within the
// `total` rows.  out: contiguous (total,
// H*D).
extern "C" int vda_segment_attention(const void* q, const void* k,
                                     const void* v, void* out,
                                     const void* tiles, int n_tiles,
                                     const void* items, int n_items,
                                     int max_span, int total, int heads,
                                     int d, long long row_stride, float scale,
                                     int is_bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (vda_segment_loop(d, is_bf16) == 90)
    return vda::seg90::launch_for_span(
        q, k, v, out, items, n_items, max_span, total, heads,
        static_cast<size_t>(row_stride), scale, 0, st);
  return vda::segment_sm80(q, k, v, out, tiles, n_tiles, heads, d,
                           row_stride, scale, is_bf16 != 0, st);
}
