// The design steps of K3's and K4's Hopper chain (temporal_sm90.cuh), for
// the measurements of probes/bench_temporal_sm90.py.  The same operands as
// vda_temporal_block (K4, full = 0: the first sub-block's alone), bf16;
// `variant` picks the step:
//   0 sm80        the kernels of temporal_block.cu that the chain replaced
//                 (a block owns whole sequences and keeps every
//                 intermediate in shared memory; the weights stream from
//                 L2 through cp.async stages into wmma products)
//   1 chain       the chain with its products on vda::TB90 (128 x 256
//                 tiles, cluster pairs sharing each weight tile by
//                 multicast): the default, vda_temporal_block's own
//   2 chain_cl1   1 with blocks alone: each loads its own weight tiles
//   3 chain_bm256 1 with 256 x 128 tiles (two consumers of 128 rows)
//   4 fused       K3 as one kernel (temporal_fused_sm90.cuh: 64-row tiles
//                 in shared memory, the weights streamed by TMA through 3
//                 slots of 32 KB that both consumers read, cluster pairs
//                 sharing them by multicast): vda_temporal_block's own at
//                 C = 256, 8 heads, T = 32, the only shape the fused steps
//                 take
//   5 fused_cl1   4 with blocks alone: each loads every weight box itself
//   6 fused_products  4's weight stream and products alone (no norm,
//                 attention, epilogue or store: the output is not written)
//   7 fused_loads  4's weight stream alone
//   8 fused_split  4 with a ring of 3 slots of 16 KB for each consumer,
//                 each slot holding that consumer's rows alone
//   9 fused_no_norm   4 without its norms (and no store, as 6)
//  10 fused_no_attn   4 without its attentions
//  11 fused_no_geglu  4 without its GEGLU epilogues
//  12 fused_no_resid  4 without its residual epilogues
//  13 fused_lag   4 with consumer 1's qkv products half a product behind
//                 consumer 0's (each one's attention under the other's
//                 products)
// Each stage of the chain alone runs through vda_temporal_stage, below.

#include "temporal_fused_sm90.cuh"

namespace {

using namespace vda;
namespace skip = vda::temporal_fused::skip;
using CL1 = gemm90::Config<128, 256, 4, true, 2, gemm90::Mode::kFull, 1>;
using BM256 = gemm90::Config<256, 128, 4, true, 2, gemm90::Mode::kFull, 2>;

template <class G>
cudaError_t chain(const temporal::Args& a, bool full, cudaStream_t st) {
  return full ? temporal::temporal_block<G>(a, st)
              : temporal::attention_block<G>(a, st);
}

template <class F>
cudaError_t fused(const temporal::Args& a, bool full, cudaStream_t st) {
  return full ? temporal_fused::launch<F>(a, st) : cudaErrorInvalidValue;
}

}  // namespace

// Bytes of workspace step `variant` needs at this shape.
extern "C" int vda_temporal_variant_workspace(int bd, int seq, int c,
                                              int heads, int full,
                                              int variant,
                                              unsigned long long* bytes) {
  if (bd < 1 || variant < 0 || variant > 13) return cudaErrorInvalidValue;
  if (variant >= 4) {  // no workspace: the intermediates stay on the SM
    if (!full || !vda::temporal_fused::takes(c, heads, seq))
      return cudaErrorInvalidValue;
    *bytes = 0;
    return cudaSuccess;
  }
  if (variant == 0)
    return vda::temporal_sm80_workspace(bd, seq, c, heads, 1, full != 0,
                                        bytes)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (!vda::temporal::takes(c, heads, seq)) return cudaErrorInvalidValue;
  *bytes = vda::temporal::workspace_bytes(bd, seq, c, full != 0);
  return cudaSuccess;
}

extern "C" int vda_temporal_variant(
    const void* h, void* out, const float* pe, const float* ln0_w,
    const float* ln0_b, const void* wqkv0, const void* wout0,
    const float* bout0, const float* ln1_w, const float* ln1_b,
    const void* wqkv1, const void* wout1, const float* bout1,
    const float* ffn_w, const float* ffn_b, const void* wproj,
    const float* bproj, const void* wffo, const float* bffo, void* ws,
    unsigned long long ws_bytes, int bd, int seq, int c, int heads, int full,
    int variant, void* stream) {
  vda::temporal::Args a{};
  a.h = h;
  a.out = out;
  a.pe = pe;
  a.attn[0] = {ln0_w, ln0_b, wqkv0, wout0, bout0};
  a.attn[1] = {ln1_w, ln1_b, wqkv1, wout1, bout1};
  a.ffn_w = ffn_w;
  a.ffn_b = ffn_b;
  a.wproj = wproj;
  a.bproj = bproj;
  a.wffo = wffo;
  a.bffo = bffo;
  a.ws = ws;
  a.ws_bytes = ws_bytes;
  a.bd = bd;
  a.seq = seq;
  a.c = c;
  a.heads = heads;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool f = full != 0;
  switch (variant) {
    case 0: return vda::temporal_sm80(a, f, 1, st);
    case 1: return chain<vda::TB90>(a, f, st);
    case 2: return chain<CL1>(a, f, st);
    case 3: return chain<BM256>(a, f, st);
    case 4: return fused<vda::TF90>(a, f, st);
    case 5: return fused<vda::TF90_CL1>(a, f, st);
    case 6: return fused<vda::TF90_SKIP<skip::kProducts>>(a, f, st);
    case 7: return fused<vda::TF90_SKIP<skip::kLoads>>(a, f, st);
    case 8: return fused<vda::TF90_SPLIT>(a, f, st);
    case 9: return fused<vda::TF90_SKIP<skip::kNorm>>(a, f, st);
    case 10: return fused<vda::TF90_SKIP<skip::kAttention>>(a, f, st);
    case 11: return fused<vda::TF90_SKIP<skip::kGeglu>>(a, f, st);
    case 12: return fused<vda::TF90_SKIP<skip::kResidual>>(a, f, st);
    case 13: return fused<vda::TF90_LAG>(a, f, st);
    default: return cudaErrorInvalidValue;
  }
}

// One stage of the Hopper chain alone, for the tests and
// probes/bench_temporal_sm90.py; bf16 operands, full = 1 tags it K3's.
//   0 ln       out (m, n) = LN(a) (+ pe[row % seq] if pe), w and b the
//              norm's (fp32)
//   1 qkv      out (m, n) = a (m, k) x w (n, k)^T
//   2 attn     out (m, n) = attention(a): a (m, 3n) = [q | k | v] of
//              m / seq sequences, `heads` heads
//   3 residual out (m, n) = h + (a x w^T + b)
//   4 geglu    out (m, n / 2) = x1 * gelu(gate), [x1 | gate] = a x w^T + b
extern "C" int vda_temporal_stage(int stage, int full, const void* a,
                                  const void* w, const float* b,
                                  const void* h, const float* pe, void* out,
                                  int m, int n, int k, int seq, int heads,
                                  void* stream) {
  using namespace vda::temporal;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const bf16*>(a);
  auto* y = static_cast<bf16*>(out);
  auto go = [&](auto tag) -> cudaError_t {
    using Tag = decltype(tag);
    switch (stage) {
      case 0:
        return launch_ln<Tag>(x, y, static_cast<const float*>(w), b, pe, m,
                              n, seq, st);
      case 1:
        return product<vda::TB90>(a, w, m, n, k,
                                  vda::gemm::QkvStore<Tag>{y, n}, st);
      case 2:
        if (seq <= 0 || m % seq) return cudaErrorInvalidValue;
        return launch_attention<Tag>(x, y, m / seq, seq, n, heads, st);
      case 3:
        return product<vda::TB90>(
            a, w, m, n, k,
            vda::gemm::Residual<Tag>{static_cast<const bf16*>(h), b, y, n},
            st);
      case 4:
        return product<vda::TB90>(a, w, m, n, k,
                                  vda::gemm::Geglu<Tag>{b, y, n / 2}, st);
      default:
        return cudaErrorInvalidValue;
    }
  };
  return full ? go(TemporalK3{}) : go(TemporalK4{});
}
