// K1 and K9: non-causal multi-head self-attention over head-packed
// (B, N, H*D) q, k and v.
//
// K1 replaces vda_tpu/ops/pallas_attention.py flash_attention_qkv
// (_attn_kernel_packed) and reads q/k/v in place from the fused qkv
// projection (B, N, 3*H*D): q, q + H*D and q + 2*H*D with a row stride of
// 3*H*D.  K9 replaces flash_attention_packed (the same kernel body over three
// separate tensors): the same entry point with three pointers and a row
// stride of H*D.  One entry point, and for each shape one device loop,
// serves both, so K1 and K9 are bit-identical on the same values.
//
// The TPU kernel held a whole head's K and V in VMEM (~350 KB at N=1370); a
// block here may hold 227 KB, so this is a flash attention that walks K/V
// tiles with an online softmax.  The loop is chosen by (dtype, head width)
// alone (vda_attention_loop):
//   * bf16 at head width 64, every encoder the repo has: the Hopper loop of
//     flash_attention_sm90.cuh (TMA, wgmma, a producer warpgroup and three
//     consumer warpgroups of 64 query rows; vda::SM90, defined there, is
//     its tiling);
//   * the other widths K1 takes (multiples of 8 up to 128) and fp32: the
//     mma.sync / scalar loops of flash_attention.cuh, one block of 4 warps
//     per (64-row query tile, head, batch).
// The output (B, N, H*D) is contiguous.

#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace vda {

namespace {

using namespace flash;

template <int DP>
__global__ void __launch_bounds__(NT)
    attention_qkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              bf16* __restrict__ out, size_t rs, int n,
                              int heads, int d, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * d;
  const size_t off = static_cast<size_t>(b) * n * rs + h * d;
  bf16* ob = out + static_cast<size_t>(b) * n * hd + h * d;
  attend_bf16<DP>(q + off, k + off, v + off, rs, n, d, valid_len, scale, q0,
                  reinterpret_cast<bf16*>(smem),
                  [&](int r, int col, float v0, float v1) {
                    const int row = q0 + r;
                    if (row < n)
                      *reinterpret_cast<__nv_bfloat162*>(
                          ob + static_cast<size_t>(row) * hd + col) =
                          __floats2bfloat162_rn(v0, v1);
                  });
}

template <int DP>
__global__ void __launch_bounds__(NT)
    attention_qkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ out, size_t rs, int n,
                             int heads, int d, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hd = heads * d;
  const size_t off = static_cast<size_t>(b) * n * rs + h * d;
  float* ob = out + static_cast<size_t>(b) * n * hd + h * d;
  attend_f32<DP>(q + off, k + off, v + off, rs, n, d, valid_len, scale, q0,
                 smem, [&](int r, int c, float val) {
                   if (q0 + r < n)
                     ob[static_cast<size_t>(q0 + r) * hd + c] = val;
                 });
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int heads, int d, size_t rs, int valid_len,
                   float scale, bool bf, cudaStream_t stream) {
  const dim3 grid((n + BQ - 1) / BQ, heads, b);
  const size_t bytes = bf ? Bf16Tiles<DP>::bytes : F32Tiles<DP>::bytes;
  cudaError_t e;
  if (bf) {
    auto kern = attention_qkv_bf16_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), rs, n, heads, d,
        valid_len, scale);
  } else {
    auto kern = attention_qkv_f32_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), rs, n, heads,
        d, valid_len, scale);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace vda

// The loop vda_attention runs for head width d: 90 (the Hopper loop) for
// bf16 at d = 64, 80 (the mma.sync or fp32 loop) otherwise.
extern "C" int vda_attention_loop(int d, int is_bf16) {
  return is_bf16 && d == vda::sm90::D ? 90 : 80;
}

// q, k, v: row 0 of batch 0, 16-byte aligned; token t of batch b at
// x + (b * n + t) * row_stride (a multiple of 8 elements).  out: contiguous
// (B, N, H*D).  The Hopper loop needs scale > 0.
extern "C" int vda_attention(const void* q, const void* k, const void* v,
                             void* out, int b, int n, int heads, int d,
                             long long row_stride, int valid_len, float scale,
                             int is_bf16, void* stream) {
  if (valid_len <= 0 || valid_len > n || row_stride < 1LL * heads * d ||
      row_stride % 8)
    return cudaErrorInvalidValue;
  const size_t rs = static_cast<size_t>(row_stride);
  const bool bf = is_bf16 != 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (vda_attention_loop(d, is_bf16) == 90)
    return vda::sm90::launch<vda::SM90>(q, k, v, out, b, n, heads, rs,
                                        valid_len, scale, st);
  switch (vda::flash::padded_width(d)) {
    case 16: return vda::launch<16>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 32: return vda::launch<32>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 48: return vda::launch<48>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 64: return vda::launch<64>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 80: return vda::launch<80>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 96: return vda::launch<96>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 112: return vda::launch<112>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    case 128: return vda::launch<128>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, bf, st);
    default: return cudaErrorInvalidValue;
  }
}
