// The design steps of K11/K13's Hopper GEMM mainloop (gemm_sm90.cuh), each
// a compile-time configuration of it, and the mma.sync loop it replaced
// (gemm_sm80.cuh), for the measurements of probes/bench_gemm_sm90.py and
// chip_smoke.py.  The function of the entry points of int8_matmul.cu,
// picked by `kind`:
//   0 K13 int8: a (M, K) x bt (N, K) int8 -> out (M, N) int32
//   1 K13 bf16: a (M, K) x bt (N, K) bf16 -> out (M, N) bf16 (fp32 sums)
//   2 K11: xq (M, K) x wt (N, K) int8 dequantised by sx, sw, b -> bf16
// (k in elements of a; sx, sw and b are read by kind 2 only), and
// `variant` the loop:
//   0 mma_sync    the old loop: mma.sync, cp.async, one block a 128 x 128
//                 tile
//   1 loads       the TMA ring alone: stages waited for and released, no
//                 products, nothing written
//   2 products    the wgmma products alone: no epilogue, nothing written
//   3 t128x128    128 x 128 tiles (wgmma m64n128), 4 stages
//   4 t128x256_s3 128 x 256 tiles (wgmma m64n256), 3 stages
//   5 t128x256    128 x 256 tiles, 4 stages
//   6 t256x128    256 x 128 tiles (two m64n128 a consumer), 4 stages
//   7 grid        9 with one block a tile instead of a persistent grid
//   8 ts2_s3      5 with the epilogue staged in shared memory and written
//                 by TMA stores, groups of 2 boxes a consumer, 3 stages
//   9 ts2         the same, 4 stages
//  10 ts4_s3      groups of 4 boxes, 3 stages
//  11 ts8_s2      groups of 8 boxes, 2 stages
//  12 t256x128_ts4 6 with groups of 4 boxes, 3 stages
//  13 t128x128_ts4 3 with groups of 4 boxes
//  14 c2_loads    1 in clusters of 2 blocks, each loading its A and half of
//                 the shared B^T tile, multicast into both
//  15 c2_products 2 in clusters of 2
//  16 c2_ts2      9 in clusters of 2 (the library's default)
//  17 c2_ts2_s3   8 in clusters of 2
//  18 c2_ts4_s3   10 in clusters of 2
//  19 c2_stage    16's epilogue up to its TMA stores, which are not issued
//                 (nothing written)
//  20 c2_storeonly 16's TMA stores alone, of staging zeroed once (the
//                 output is zero)
//  21 c2_grid     16 with one cluster a pair of tiles instead of a
//                 persistent grid
// Each variant but 0 is persistent (one block an SM) and stores from
// registers unless named; 1 and 2 run 5's tiling.  A box is 64 rows x 128
// bytes of the output (32 int32 or 64 bf16 columns).

#include <type_traits>

#include "gemm_sm80.cuh"
#include "gemm_sm90.cuh"

namespace {

using vda::gemm90::Config;
using vda::gemm90::Mode;

// A configuration of this file: a type of internal linkage, so that no
// kernel here shares its symbol with the library's default (vda::GEMM90).
template <class C>
struct Local : C {};

// bf16 operands for K13's bf16 store, int8 for the others
template <class Epi>
constexpr bool is_bf16 = std::is_same_v<Epi, vda::gemm::StoreBf16>;

template <class C, class Epi>
int run(const void* a, const void* bt, int m, int n, int kb, Epi epi,
        cudaStream_t st) {
  using T = std::conditional_t<is_bf16<Epi>, vda::gemm90::BF16,
                               vda::gemm90::S8>;
  return vda::gemm90::launch<Local<C>, T>(a, bt, m, n, kb, epi, st);
}

template <class Epi>
int run_old(const void* a, const void* bt, int m, int n, int kb, Epi epi,
            cudaStream_t st) {
  using T = std::conditional_t<is_bf16<Epi>, vda::gemm80::BF16,
                               vda::gemm80::S8>;
  return vda::gemm80::launch<T>(a, bt, m, n, kb, epi, st);
}

template <class Epi>
int run_variant(int variant, const void* a, const void* bt, int m, int n,
                int kb, Epi epi, cudaStream_t st) {
#define VDA_RUN(...) run<__VA_ARGS__>(a, bt, m, n, kb, epi, st)
  switch (variant) {
    case 0: return run_old(a, bt, m, n, kb, epi, st);
    case 1: return VDA_RUN(Config<128, 256, 4, true, 0, Mode::kLoads>);
    case 2: return VDA_RUN(Config<128, 256, 4, true, 0, Mode::kProducts>);
    case 3: return VDA_RUN(Config<128, 128, 4>);
    case 4: return VDA_RUN(Config<128, 256, 3>);
    case 5: return VDA_RUN(Config<128, 256, 4>);
    case 6: return VDA_RUN(Config<256, 128, 4>);
    case 7: return VDA_RUN(Config<128, 256, 4, false, 2>);
    case 8: return VDA_RUN(Config<128, 256, 3, true, 2>);
    case 9: return VDA_RUN(Config<128, 256, 4, true, 2>);
    case 10: return VDA_RUN(Config<128, 256, 3, true, 4>);
    case 11: return VDA_RUN(Config<128, 256, 2, true, 8>);
    case 12: return VDA_RUN(Config<256, 128, 3, true, 4>);
    case 13: return VDA_RUN(Config<128, 128, 4, true, 4>);
    case 14: return VDA_RUN(Config<128, 256, 4, true, 0, Mode::kLoads, 2>);
    case 15: return VDA_RUN(Config<128, 256, 4, true, 0, Mode::kProducts, 2>);
    case 16: return VDA_RUN(Config<128, 256, 4, true, 2, Mode::kFull, 2>);
    case 17: return VDA_RUN(Config<128, 256, 3, true, 2, Mode::kFull, 2>);
    case 18: return VDA_RUN(Config<128, 256, 3, true, 4, Mode::kFull, 2>);
    case 19: return VDA_RUN(Config<128, 256, 4, true, 2, Mode::kStage, 2>);
    case 20:
      return VDA_RUN(Config<128, 256, 4, true, 2, Mode::kStoreOnly, 2>);
    case 21: return VDA_RUN(Config<128, 256, 4, false, 2, Mode::kFull, 2>);
    default: return cudaErrorInvalidValue;
  }
#undef VDA_RUN
}

}  // namespace

// a, bt: (M, K) and (N, K) row-major, 16-byte aligned; out (M, N); sx (M,),
// sw and b (N,) fp32 for kind 2.  Shapes as int8_matmul.cu's entry points
// take them (and N % 128 for kind 2, K11's contract).
extern "C" int vda_gemm_sm90_variant(const void* a, const void* bt,
                                     const void* sx, const void* sw,
                                     const void* b, void* out, int m, int n,
                                     int k, int kind, int variant,
                                     void* stream) {
  using namespace vda::gemm;
  const int elem = kind == 1 ? 2 : 1;
  if (kind < 0 || kind > 2 || !shape_ok(m, n, k, elem) ||
      (kind == 2 && n % 128))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fsx = static_cast<const float*>(sx);
  const auto* fsw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(b);
  const int kb = k * elem;
  if (kind == 0)
    return run_variant(variant, a, bt, m, n, kb,
                       StoreI32{static_cast<int*>(out), n}, st);
  if (kind == 1)
    return run_variant(variant, a, bt, m, n, kb,
                       StoreBf16{static_cast<bf16*>(out), n}, st);
  return run_variant(variant, a, bt, m, n, kb,
                     Dequant<bf16>{fsx, fsw, fb, static_cast<bf16*>(out), n},
                     st);
}
