// K11: the W8A8 linear's int8 matrix product with its dequantising epilogue,
// and K13: the rate probe's plain products (int8 -> int32, bf16 -> bf16).
//
// K11 replaces vda_tpu/ops/quant.py _int8_matmul (its pallas_call runs
// _kernel): out = ((float(xq @ wq) * sx[row]) * sw[col]) + b[col], cast to
// the activation's dtype, with xq (M, K) and wq (K, N) int8, int32 sums.
// K13 replaces scripts/bench_int8_pallas.py matmul (its kernel): a tiled
// product, int8 x int8 -> int32 or bf16 x bf16 -> fp32 sums -> bf16.
//
// What bounds them on the H100: at the encoder's qkv shape, (43840, 1024) x
// (1024, 3072), the operations (2.8e11 at 1979 TOP/s int8, 0.14 ms) against
// ~0.32 GB of bytes (0.095 ms); K13's int8 product writes int32, 0.55 GB,
// so the bytes bind it.  Both run the Hopper GEMM mainloop of gemm_sm90.cuh
// (TMA, wgmma, a producer and two consumer warpgroups, a persistent grid;
// the header says why each piece is there), with the epilogues of
// gemm_epilogue.cuh.  B is taken as (N, K) row-major: 8-bit wgmma operands
// must be K-major, so the wrapper keeps one transposed copy of each weight
// tensor (the weights are constant from call to call, so the transpose is
// made once).  The mma.sync loop these entry points ran before
// (gemm_sm80.cuh) is reachable only from gemm_sm90_variants.cu.
//
// The epilogue multiplies and adds with __fmul_rn / __fadd_rn in the order
// ((acc * sx) * sw) + b, so nvcc cannot contract it into an FMA: the int32
// sums are exact, and K11 is bit-identical with its plain twin.

#include "gemm_sm90.cuh"

namespace vda {

// The tiling of the Hopper loop, the fastest of the steps that
// probes/bench_gemm_sm90.py times (gemm_sm90_variants.cu, "c2_ts2"): 128 x
// 256 output tiles (two consumers of 64 rows, wgmma m64n256), a ring of 4
// stages of 128 bytes of k, a persistent grid of clusters of two blocks
// that share each B^T tile by multicast, the epilogue through shared
// memory and TMA stores in groups of 2 boxes a consumer.
using GEMM90 =
    gemm90::Config<128, 256, 4, true, 2, gemm90::Mode::kFull, 2>;

}  // namespace vda

// The loop the two entry points below run: 90, the Hopper loop.
extern "C" int vda_gemm_loop() { return 90; }

// K11.  xq (M, K) int8, wt (N, K) int8 (the weight transposed), sx (M,)
// fp32, sw and b (N,) fp32; out (M, N) bf16 (out_bf16) or fp32.  All
// contiguous, 16-byte aligned.
extern "C" int vda_int8_linear(const void* xq, const void* wt, const void* sx,
                               const void* sw, const void* b, void* out, int m,
                               int n, int k, int out_bf16, void* stream) {
  using namespace vda::gemm;
  if (!shape_ok(m, n, k, 1)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* fsx = static_cast<const float*>(sx);
  const auto* fsw = static_cast<const float*>(sw);
  const auto* fb = static_cast<const float*>(b);
  if (out_bf16)
    return vda::gemm90::launch<vda::GEMM90, vda::gemm90::S8>(
        xq, wt, m, n, k,
        Dequant<bf16>{fsx, fsw, fb, static_cast<bf16*>(out), n}, st);
  return vda::gemm90::launch<vda::GEMM90, vda::gemm90::S8>(
      xq, wt, m, n, k,
      Dequant<float>{fsx, fsw, fb, static_cast<float*>(out), n}, st);
}

// K13.  a (M, K) and bt (N, K), both int8 (out int32) or both bf16 (out
// bf16); out (M, N).  All contiguous, 16-byte aligned.
extern "C" int vda_matmul_probe(const void* a, const void* bt, void* out,
                                int m, int n, int k, int is_bf16,
                                void* stream) {
  using namespace vda::gemm;
  const int elem = is_bf16 ? 2 : 1;
  if (!shape_ok(m, n, k, elem)) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vda::gemm90::launch<vda::GEMM90, vda::gemm90::BF16>(
        a, bt, m, n, k * 2, StoreBf16{static_cast<bf16*>(out), n}, st);
  return vda::gemm90::launch<vda::GEMM90, vda::gemm90::S8>(
      a, bt, m, n, k, StoreI32{static_cast<int*>(out), n}, st);
}
