// The design steps of K7's Hopper kernel (attention_heads_sm90.cuh), each a
// compile-time configuration of it, for the measurements of
// probes/bench_attn_proj_sm90.py.  The same function and entry layout as
// vda_attention_proj's bf16 head-width-64 path (qkv (B, N, 3C), w (C, C)
// (out, in), gamma_bias (2, C) fp32, x and out (B, N, C)); `variant` picks
// the configuration:
//   0 attn_only  2's attention phase alone: the heads into the
//                head-output tile, no projection (out = x + gamma * bias)
//   1 proj_only  2's projection alone, over a zeroed head-output tile
//                (out = x + gamma * bias)
//   2 c2_bk64    one block a tile: two consumers on two heads at a time,
//                K/V tiles of 64 keys in rings of 2 stages, the row sums by
//                the tensor core, projection chunks of 128 columns, W rings
//                of 2 stages
//   3 sums_add   2 with the row sums by adds in the softmax
//   4 bk128_s1   2 with K/V tiles of 128 keys, rings of 1 stage
//   5 bk32_s4    2 with K/V tiles of 32 keys, rings of 4 stages
//   6 c3_bk32    three consumers, K/V tiles of 32 keys in rings of 2
//                stages, W rings of 1 stage
//   7 c3_bk64_s1 three consumers, K/V tiles of 64 keys in rings of 1
//                stage, W rings of 1 stage
//   8 pn256      2 with projection chunks of 256 columns, W rings of 1
//                stage
//   9 pn64_w4    2 with projection chunks of 64 columns, W rings of 4
//                stages
//  10 mma_sync   not a configuration: the mma.sync kernel that K7 ran in
//                bf16 at head width 64 before (attention_proj.cu), for
//                comparison in the same run
//  11 split2     a cluster pair on each 64-row tile: each block attends to
//                half of the heads with two consumers, K/V tiles of 128
//                keys in rings of 2 stages, into half a head-output tile
//                (64 KB at C = 1024); the halves are swapped by a copy
//                between the blocks' shared memory, and each block projects
//                half of the output chunks (128 columns, W rings of 2
//                stages)
//  12 split2_attn 11's attention phase and the swap alone (out = x +
//                gamma * bias)
//  13 split2_proj 11's swap and projection alone, over zeroed halves
//                (out = x + gamma * bias)
//  14 split2_c3  11 with three consumers, K/V tiles of 64 keys in rings of
//                2 stages, W rings of 1 stage
//  15 split2_c3_s1 11 with three consumers, rings of 1 stage, W rings of 1
//                stage
//  16 split2_bk64_s3 11 with K/V tiles of 64 keys in rings of 3 stages, W
//                rings of 1 stage
//  17 split2_q2  11 with two Q buffers a consumer: the next head's Q loads
//                while this head runs
//  18 split2_ov  11 with K1's overlapped schedule: the next tile's Q K^T
//                and this tile's P V in flight during the next softmax
//  19 split2_q2_ov 17 and 18 together
//  20 split2_c3_s1_q2 15 with two Q buffers a consumer
//  21 split2_c3_pn64 15 with projection chunks of 64 columns, W rings of 2
//                stages (8 chunks a block for three consumers, not 4)
//  22 split2_c3_pn64_q2 21 with two Q buffers a consumer
//  23 split2_c3_pn64_w3 21 with W rings of 3 stages
//  24 split2_c3_pn64_w4 21 with W rings of 4 stages
//  25 split2_pn64    11 with projection chunks of 64 columns, W rings of 4
//                stages
//  26 split2_c3_pn64_v16 21 with the epilogue's x, gamma, bias and out as
//                16-byte accesses (a transpose of the sums within quads):
//                the default (vda::K7SM90)
//  27 split2_c3_pn32_v16 26 with projection chunks of 32 columns, W rings
//                of 4 stages (16 chunks a block: 6, 5, 5 a consumer)
//  28 split2_c3_bk64_v16 26 with K/V tiles of 64 keys in rings of 2 stages
// Every configuration keeps the (128 * (NC + 1))-thread block, one block
// (split: one cluster pair) per (64-row query tile, batch), the TMA maps
// and the epilogue, and fits a C = 1024 head-output tile (128 KB, split:
// 64 KB) in a block.

#include "attention_heads_sm90.cuh"

namespace vda {
cudaError_t attention_proj_mma_sync(const void* qkv, const void* w,
                                    const float* gb, const void* x,
                                    void* out, int b, int n, int heads,
                                    int valid_len, float scale,
                                    cudaStream_t stream);
}  // namespace vda

namespace {

using vda::sm90::HeadsConfig;
using vda::sm90::Phases;

// A configuration of this file: a type of internal linkage, so that no
// kernel here shares its symbol with the library's default (vda::K7SM90).
template <class C>
struct Local : C {};

template <class C>
int run(const void* qkv, const void* w, const float* gb, const void* x,
        void* out, int b, int n, int heads, int valid_len, float scale,
        cudaStream_t st) {
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const int c = heads * vda::sm90::D;
  return vda::sm90::launch_heads<Local<C>>(q, q + c, q + 2 * c, w, gb, x,
                                           out, b, n, heads, 3 * c,
                                           valid_len, scale, st);
}

}  // namespace

// qkv, w, x, out: contiguous bf16, 16-byte aligned; gb (2, C) fp32; C =
// heads * 64 <= 1024; scale > 0.
extern "C" int vda_attention_proj_sm90_variant(
    const void* qkv, const void* w, const float* gb, const void* x,
    void* out, int b, int n, int heads, int valid_len, float scale,
    int variant, void* stream) {
  if (b <= 0 || n <= 0 || heads <= 0 || heads > 16 || valid_len <= 0 ||
      valid_len > n)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define VDA_RUN(...) \
  run<__VA_ARGS__>(qkv, w, gb, x, out, b, n, heads, valid_len, scale, st)
  switch (variant) {
    case 0: return VDA_RUN(HeadsConfig<2, 64, 2, true, 128, 2, Phases::kAttention>);
    case 1: return VDA_RUN(HeadsConfig<2, 64, 2, true, 128, 2, Phases::kProjection>);
    case 2: return VDA_RUN(HeadsConfig<2, 64, 2, true, 128, 2>);
    case 3: return VDA_RUN(HeadsConfig<2, 64, 2, false, 128, 2>);
    case 4: return VDA_RUN(HeadsConfig<2, 128, 1, true, 128, 2>);
    case 5: return VDA_RUN(HeadsConfig<2, 32, 4, true, 128, 2>);
    case 6: return VDA_RUN(HeadsConfig<3, 32, 2, true, 128, 1>);
    case 7: return VDA_RUN(HeadsConfig<3, 64, 1, true, 128, 1>);
    case 8: return VDA_RUN(HeadsConfig<2, 64, 2, true, 256, 1>);
    case 9: return VDA_RUN(HeadsConfig<2, 64, 2, true, 64, 4>);
    case 10:
      return vda::attention_proj_mma_sync(qkv, w, gb, x, out, b, n, heads,
                                          valid_len, scale, st);
    case 11: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kBoth, 2>);
    case 12: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kAttention, 2>);
    case 13: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kProjection, 2>);
    case 14: return VDA_RUN(HeadsConfig<3, 64, 2, true, 128, 1, Phases::kBoth, 2>);
    case 15: return VDA_RUN(HeadsConfig<3, 128, 1, true, 128, 1, Phases::kBoth, 2>);
    case 16: return VDA_RUN(HeadsConfig<2, 64, 3, true, 128, 1, Phases::kBoth, 2>);
    case 17: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kBoth, 2, 2>);
    case 18: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kBoth, 2, 1, true>);
    case 19: return VDA_RUN(HeadsConfig<2, 128, 2, true, 128, 2, Phases::kBoth, 2, 2, true>);
    case 20: return VDA_RUN(HeadsConfig<3, 128, 1, true, 128, 1, Phases::kBoth, 2, 2>);
    case 21: return VDA_RUN(HeadsConfig<3, 128, 1, true, 64, 2, Phases::kBoth, 2>);
    case 22: return VDA_RUN(HeadsConfig<3, 128, 1, true, 64, 2, Phases::kBoth, 2, 2>);
    case 23: return VDA_RUN(HeadsConfig<3, 128, 1, true, 64, 3, Phases::kBoth, 2>);
    case 24: return VDA_RUN(HeadsConfig<3, 128, 1, true, 64, 4, Phases::kBoth, 2>);
    case 25: return VDA_RUN(HeadsConfig<2, 128, 2, true, 64, 4, Phases::kBoth, 2>);
    case 26: return VDA_RUN(vda::K7SM90);
    case 27: return VDA_RUN(HeadsConfig<3, 128, 1, true, 32, 4, Phases::kBoth, 2, 1, false, true>);
    case 28: return VDA_RUN(HeadsConfig<3, 64, 2, true, 64, 2, Phases::kBoth, 2, 1, false, true>);
    default: return cudaErrorInvalidValue;
  }
#undef VDA_RUN
}
