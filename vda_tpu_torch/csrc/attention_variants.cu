// K12: K1's attention with one piece ablated or its tiling changed, for
// measuring where K1's time goes.
//
// Replaces scripts/bench_attn_variants.py attn (its pallas_call runs
// `kernel` with a `mode`, an `exp_dtype` and a block geometry), over
// head-packed q, k and v read in place (K1's entry, bf16 only).  `variant`:
//   0 full      K1's function and tiling
//   1 matmul    no softmax: P = bf16(S * scale), no normalisation
//   2 nomask    no key compare; the caller passes the padded key count as
//               valid_len and the padded keys take part as zero rows
//   3 fp32exp   accurate fp32 exp, the sum of unrounded values
//   4 bf16sm    max and exp in bf16 (ex2.approx.bf16x2)
//   5 exp2      the scale folded into log2 e: one FMA and ex2 a score
//   6 bq128     128 query rows a block
//   7 bk32      K/V tiles of 32 keys
//   8 bk128     K/V tiles of 128 keys
//   9 heads2    two heads a block
//  10 mma_sync  the old loop's full: K1's function on flash_attention.cuh
//
// The device loop is chosen by (head width, variant) alone
// (vda_attention_variant_loop):
//   * head width 64, variants 0-9: configurations of K1's Hopper loop
//     (flash_attention_sm90.cuh; heads2 on attention_heads_sm90.cuh).
//     full is K1's own configuration (vda::SM90), so bit-identical with
//     K1; matmul is kMatmul without the row sums (nothing normalises);
//     nomask, fp32exp and bf16sm are modes of the loop (fp32exp sums the
//     unrounded values in registers, since the tensor core's row sums read
//     the bf16 P; the others keep the tensor core's sums); exp2 is full's
//     configuration, since the loop's full already takes the max over
//     unscaled scores and one FMA and ex2.approx a score: nothing differs.
//     The geometry: bq128 two consumers (128 query rows) where full has
//     three (192); bk32 tiles of 32 keys in a ring of 8 stages (the 256
//     keys in flight of full's 2 stages of 128); bk128 tiles of 128 keys,
//     which is full's own tile, so full's configuration; heads2 two
//     consumers of 64 rows on two heads, each with its own Q and K/V ring
//     (the attention half of K7's kernel, without its projection);
//   * other head widths (the function variants to 128, the geometry ones to
//     64) and mma_sync: instantiations of the mma.sync loop of
//     flash_attention.cuh (attend_bf16 with a Variant): 4 warps a block of
//     64 query rows of one head, K/V tiles of 64 keys; bq128 8 warps,
//     bk32 / bk128 tiles of 32 / 128 keys, heads2 two groups of 4 warps on
//     two heads.
// What bounds them is what bounds K1: the operations of the two products,
// since the scores never leave registers.

#include "attention_heads_sm90.cuh"
#include "flash_attention.cuh"
#include "flash_attention_sm90.cuh"

namespace vda {
namespace {

using namespace flash;

using Matmul = Variant<Fn::kMatmul>;
using NoMask = Variant<Fn::kNoMask>;
using Fp32Exp = Variant<Fn::kFp32Exp>;
using Bf16Softmax = Variant<Fn::kBf16Softmax>;
using Exp2 = Variant<Fn::kExp2>;
using Bq128 = Variant<Fn::kFull, 128, 64, 1>;
using Bk32 = Variant<Fn::kFull, 64, 32, 1>;
using Bk128 = Variant<Fn::kFull, 64, 128, 1>;
using Heads2 = Variant<Fn::kFull, 64, 64, 2>;

template <int DP, class V>
__global__ void __launch_bounds__(V::nt * V::heads)
    attention_variant_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ out, size_t rs, int n,
                             int heads, int d, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int group = V::heads == 1 ? 0 : static_cast<int>(threadIdx.x) / V::nt;
  // a group past the last head repeats the last head's work and stores
  // nothing: it must still meet the block's barriers
  const int h_raw = blockIdx.y * V::heads + group;
  const bool live = h_raw < heads;
  const int h = live ? h_raw : heads - 1;
  const int q0 = blockIdx.x * V::bq, b = blockIdx.z;
  const int hd = heads * d;
  const size_t off = static_cast<size_t>(b) * n * rs + h * d;
  bf16* ob = out + static_cast<size_t>(b) * n * hd + h * d;
  bf16* tiles = reinterpret_cast<bf16*>(smem) +
                group * (Bf16Tiles<DP, V>::bytes / sizeof(bf16));
  attend_bf16<DP, V>(q + off, k + off, v + off, rs, n, d, valid_len, scale,
                     q0, tiles, [&](int r, int col, float v0, float v1) {
                       const int row = q0 + r;
                       if (live && row < n)
                         *reinterpret_cast<__nv_bfloat162*>(
                             ob + static_cast<size_t>(row) * hd + col) =
                             __floats2bfloat162_rn(v0, v1);
                     });
}

template <int DP, class V>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int heads, int d, size_t rs, int valid_len,
                   float scale, cudaStream_t stream) {
  const dim3 grid((n + V::bq - 1) / V::bq, (heads + V::heads - 1) / V::heads,
                  b);
  const size_t bytes = V::heads * Bf16Tiles<DP, V>::bytes;
  auto kern = attention_variant_kernel<DP, V>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kern<<<grid, V::nt * V::heads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), rs, n, heads, d,
      valid_len, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_variant(int variant, const void* q, const void* k,
                           const void* v, void* out, int b, int n, int heads,
                           int d, size_t rs, int valid_len, float scale,
                           cudaStream_t st) {
#define VDA_VARIANT(i, V)                                                  \
  case i:                                                                  \
    return launch<DP, V>(q, k, v, out, b, n, heads, d, rs, valid_len, scale, \
                         st)
  switch (variant) {
    VDA_VARIANT(0, Default);
    VDA_VARIANT(1, Matmul);
    VDA_VARIANT(2, NoMask);
    VDA_VARIANT(3, Fp32Exp);
    VDA_VARIANT(4, Bf16Softmax);
    VDA_VARIANT(5, Exp2);
    default:
      break;
  }
  if constexpr (DP == 64) {
    switch (variant) {
      VDA_VARIANT(6, Bq128);
      VDA_VARIANT(7, Bk32);
      VDA_VARIANT(8, Bk128);
      VDA_VARIANT(9, Heads2);
      default:
        break;
    }
  }
#undef VDA_VARIANT
  return cudaErrorInvalidValue;
}

// The Hopper loop's configurations of the variants: a type of internal
// linkage each, so that no kernel here shares its symbol with K1's
// (vda::SM90) or K7's.
template <class C>
struct Local : C {};

using sm90::Config;
using sm90::Mode;
using Full90 = Local<SM90>;
using Matmul90 = Local<Config<128, 3, 2, false, false, Mode::kMatmul>>;
using NoMask90 = Local<Config<128, 3, 2, false, false, Mode::kNoMask, 0, true>>;
using Fp32Exp90 = Local<Config<128, 3, 2, false, false, Mode::kFp32Exp>>;
using Bf16Softmax90 =
    Local<Config<128, 3, 2, false, false, Mode::kBf16Softmax, 0, true>>;
using Bq128_90 = Local<Config<128, 2, 2, false, false, Mode::kFull, 0, true>>;
using Bk32_90 = Local<Config<32, 3, 8, false, false, Mode::kFull, 0, true>>;
using Heads2_90 =
    Local<sm90::HeadsConfig<2, 128, 2, true, 128, 2, sm90::Phases::kHeads>>;

cudaError_t launch_sm90(int variant, const void* q, const void* k,
                        const void* v, void* out, int b, int n, int heads,
                        size_t rs, int valid_len, float scale,
                        cudaStream_t st) {
#define VDA_SM90(i, C)                                                       \
  case i:                                                                    \
    return sm90::launch<C>(q, k, v, out, b, n, heads, rs, valid_len, scale, \
                           st)
  switch (variant) {
    VDA_SM90(0, Full90);
    VDA_SM90(1, Matmul90);
    VDA_SM90(2, NoMask90);
    VDA_SM90(3, Fp32Exp90);
    VDA_SM90(4, Bf16Softmax90);
    VDA_SM90(5, Full90);  // exp2: see the header
    VDA_SM90(6, Bq128_90);
    VDA_SM90(7, Bk32_90);
    VDA_SM90(8, Full90);  // bk128: full's own tile
    case 9:
      return sm90::launch_heads<Heads2_90>(q, k, v, nullptr, nullptr,
                                           nullptr, out, b, n, heads, rs,
                                           valid_len, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
#undef VDA_SM90
}

}  // namespace
}  // namespace vda

constexpr int kMmaSync = 10;  // the old loop's full

// The loop vda_attention_variant runs variant `variant` on at head width d:
// 90 (the Hopper loop) at d = 64 for every variant but mma_sync, 80 (the
// mma.sync loop) otherwise.
extern "C" int vda_attention_variant_loop(int d, int variant) {
  return d == vda::sm90::D && variant != kMmaSync ? 90 : 80;
}

// q, k, v: row 0 of batch 0 of bf16 tensors, 16-byte aligned; token t of
// batch b at x + (b * n + t) * row_stride (a multiple of 8 elements).  out:
// contiguous bf16 (B, N, H*D).  variant: 0-10 as above.  nomask (2) takes
// valid_len >= n, a multiple of 64: the keys it runs over.  The Hopper loop
// needs scale > 0.
extern "C" int vda_attention_variant(const void* q, const void* k,
                                     const void* v, void* out, int b, int n,
                                     int heads, int d, long long row_stride,
                                     int valid_len, float scale, int variant,
                                     void* stream) {
  const bool nomask = variant == 2;
  if (b <= 0 || n <= 0 || heads <= 0 || valid_len <= 0 ||
      (nomask ? valid_len < n || valid_len % 64 : valid_len > n) ||
      row_stride < 1LL * heads * d || row_stride % 8)
    return cudaErrorInvalidValue;
  const size_t rs = static_cast<size_t>(row_stride);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vda_attention_variant_loop(d, variant) == 90)
    return vda::launch_sm90(variant, q, k, v, out, b, n, heads, rs,
                            valid_len, scale, st);
  if (variant == kMmaSync) variant = 0;  // the old loop's Default
  const int dp = vda::flash::padded_width(d);
  if (dp == 0) return cudaErrorInvalidValue;
  if (dp <= 64)
    return vda::launch_variant<64>(variant, q, k, v, out, b, n, heads, d, rs,
                                   valid_len, scale, st);
  return vda::launch_variant<128>(variant, q, k, v, out, b, n, heads, d, rs,
                                  valid_len, scale, st);
}
