// The design steps of K1's Hopper loop (flash_attention_sm90.cuh), each a
// compile-time configuration of it, for the measurements of
// probes/bench_attn_sm90.py.  The same function and entry layout as
// vda_attention's bf16 head-width-64 path (q, k, v, row stride, valid_len,
// scale); `variant` picks the configuration:
//   0 loads       the TMA ring alone: tiles waited for and released, no
//                 products (output zero)
//   1 products    Q K^T and P V with P = bf16(S): no softmax (wgmma alone),
//                 as 6
//   2 serial      the function, each product waited for before the softmax
//   3 serial_pp   2 with the two consumers taking turns to issue
//   4 serial_p2   2 with half of the exponentials of an unmasked tile by
//                 ex2_poly on the FMA pipe
//   5 overlap2    the next tile's Q K^T issued with this tile's P V before
//                 this tile's softmax, a ring of 2 stages
//   6 overlap3    5 with 3 stages
//   7 overlap4    5 with 4 stages
//   8 pingpong    6 with the consumers taking turns
//   9 bk64        6 with K/V tiles of 64 keys (4 stages)
//  10 bk176       6 with K/V tiles of 176 keys
//  11 rows192     6 with three consumers (192 query rows a block)
//  12 rows192s    2 with three consumers
//  13 poly1       6 with a quarter of the exponentials by ex2_poly
//  14 poly2       6 with half of them by ex2_poly
//  15 rows192p2   11 with half of them by ex2_poly
//  16 sum_serial  2 with the row sums of P by the tensor core (P times a
//                 block of ones) in place of adds in the softmax
//  17 sum_overlap 6 with the row sums by the tensor core
//  18 sum_pp      8 with the row sums by the tensor core
//  19 sum_bk176   10 with the row sums by the tensor core
//  20 sum_rows192 11 with the row sums by the tensor core
//  21 sum_rows192s 12 with the row sums by the tensor core
//  22 sum_r192s_2 21 with 2 stages (the default)
//  23 sum_r192s_4 21 with 4 stages
//  24 sum_r192s_bk64 21 with K/V tiles of 64 keys (4 stages)
//  25 sum_r192s_p1 21 with a quarter of the exponentials by ex2_poly
//  26 sum_r192_bk64 20 with K/V tiles of 64 keys (4 stages): fewer
//                 registers in flight
//  27 sum_r192_bk96 20 with K/V tiles of 96 keys
//  28 sum_r192s_bk96 22 with K/V tiles of 96 keys
//  29 r192_bk64   11 with K/V tiles of 64 keys (4 stages)
//  30 bk96        6 with K/V tiles of 96 keys
// Each has K/V tiles of 128 keys, two consumers and 3 stages unless named.
// The library's default (vda::SM90, flash_attention_sm90.cuh) is one of them.
// Every configuration keeps the (128 * (NC + 1))-thread block, the TMA maps
// and the epilogue of the default.

#include "flash_attention_sm90.cuh"

namespace {

using vda::sm90::Config;
using vda::sm90::Mode;

// A configuration of this file: a type of internal linkage, so that no
// kernel here shares its symbol with the library's default (vda::SM90).
template <class C>
struct Local : C {};

template <class C>
int run(const void* q, const void* k, const void* v, void* out, int b, int n,
        int heads, size_t rs, int valid_len, float scale, cudaStream_t st) {
  return vda::sm90::launch<Local<C>>(q, k, v, out, b, n, heads, rs, valid_len, scale,
                              st);
}

}  // namespace

extern "C" int vda_attention_sm90_variant(const void* q, const void* k,
                                          const void* v, void* out, int b,
                                          int n, int heads, long long row_stride,
                                          int valid_len, float scale,
                                          int variant, void* stream) {
  if (valid_len <= 0 || valid_len > n || row_stride < 64LL * heads ||
      row_stride % 8)
    return cudaErrorInvalidValue;
  const size_t rs = static_cast<size_t>(row_stride);
  const auto st = static_cast<cudaStream_t>(stream);
#define VDA_RUN(...) \
  run<__VA_ARGS__>(q, k, v, out, b, n, heads, rs, valid_len, scale, st)
  switch (variant) {
    case 0: return VDA_RUN(Config<128, 2, 3, false, false, Mode::kLoads>);
    case 1: return VDA_RUN(Config<128, 2, 3, true, false, Mode::kProducts>);
    case 2: return VDA_RUN(Config<128, 2, 3, false, false>);
    case 3: return VDA_RUN(Config<128, 2, 3, false, true>);
    case 4: return VDA_RUN(Config<128, 2, 3, false, false, Mode::kFull, 2>);
    case 5: return VDA_RUN(Config<128, 2, 2, true, false>);
    case 6: return VDA_RUN(Config<128, 2, 3, true, false>);
    case 7: return VDA_RUN(Config<128, 2, 4, true, false>);
    case 8: return VDA_RUN(Config<128, 2, 3, true, true>);
    case 9: return VDA_RUN(Config<64, 2, 4, true, false>);
    case 10: return VDA_RUN(Config<176, 2, 3, true, false>);
    case 11: return VDA_RUN(Config<128, 3, 3, true, false>);
    case 12: return VDA_RUN(Config<128, 3, 3, false, false>);
    case 13: return VDA_RUN(Config<128, 2, 3, true, false, Mode::kFull, 1>);
    case 14: return VDA_RUN(Config<128, 2, 3, true, false, Mode::kFull, 2>);
    case 15: return VDA_RUN(Config<128, 3, 3, true, false, Mode::kFull, 2>);
    case 16: return VDA_RUN(Config<128, 2, 3, false, false, Mode::kFull, 0, true>);
    case 17: return VDA_RUN(Config<128, 2, 3, true, false, Mode::kFull, 0, true>);
    case 18: return VDA_RUN(Config<128, 2, 3, true, true, Mode::kFull, 0, true>);
    case 19: return VDA_RUN(Config<176, 2, 3, true, false, Mode::kFull, 0, true>);
    case 20: return VDA_RUN(Config<128, 3, 3, true, false, Mode::kFull, 0, true>);
    case 21: return VDA_RUN(Config<128, 3, 3, false, false, Mode::kFull, 0, true>);
    case 22: return VDA_RUN(Config<128, 3, 2, false, false, Mode::kFull, 0, true>);
    case 23: return VDA_RUN(Config<128, 3, 4, false, false, Mode::kFull, 0, true>);
    case 24: return VDA_RUN(Config<64, 3, 4, false, false, Mode::kFull, 0, true>);
    case 25: return VDA_RUN(Config<128, 3, 3, false, false, Mode::kFull, 1, true>);
    case 26: return VDA_RUN(Config<64, 3, 4, true, false, Mode::kFull, 0, true>);
    case 27: return VDA_RUN(Config<96, 3, 3, true, false, Mode::kFull, 0, true>);
    case 28: return VDA_RUN(Config<96, 3, 2, false, false, Mode::kFull, 0, true>);
    case 29: return VDA_RUN(Config<64, 3, 4, true, false>);
    case 30: return VDA_RUN(Config<96, 2, 3, true, false>);
    default: return cudaErrorInvalidValue;
  }
#undef VDA_RUN
}
