// The design steps of K5's Hopper code (tiny_seq_sm90.cuh), for the
// measurements of probes/bench_short_attn_sm90.py.  The operands of
// vda_tiny_seq_attention, bf16; `variant` picks the step:
//   0 old       the kernel the Hopper code replaced (tiny_seq_attention.cu:
//               a block a sequence and a head group, q and k staged in
//               shared memory as fp32, the products on the fp32 pipe)
//   1 sm90      the Hopper code: vda_tiny_seq_attention's own (T >= 2 the
//               mma path, T == 1 the row path)
//   2 loads     1's loads alone: the mma path's TMA ring waited for, or the
//               row path's 16-byte loads (nothing computed or written)
//   3 products  the mma path's products, softmax and output tiles alone, on
//               whatever the stages hold (no loads, nothing written; T >= 2
//               only)
//   4 floor     an empty kernel on 1's grid: the launch alone
// (The steps that lost are deleted: blocks of 4 warps, the softmax a score
// at a time, the accurate expf; at head width 192 a warp a whole head and
// slabs of 96 columns; their times are in PERF.md.)
// `keep` is 0 from every caller: the steps that write nothing keep their
// results alive on a branch no run takes.

#include "tiny_seq_sm90.cuh"

extern "C" int vda_tiny_seq_variant(const void* q, const void* k,
                                    const void* v, void* o, int bd, int t,
                                    int c, int heads, long long seq_stride,
                                    long long row_stride, float scale,
                                    int keep, int variant, void* stream) {
  using vda::tiny90::Mode;
  using vda::tiny90::launch;
  const auto st = static_cast<cudaStream_t>(stream);
  if (bd <= 0 || t <= 0 || t > 64 || heads <= 0 || c % heads ||
      (c / heads) % 8 || seq_stride % 8 || row_stride % 8)
    return cudaErrorInvalidValue;
  switch (variant) {
    case 0: return vda::tiny_seq_sm80(q, k, v, o, bd, t, c, heads, seq_stride,
                                      row_stride, scale, true, st);
    case 1: return launch<Mode::kFull>(q, k, v, o, bd, t, c, heads,
                                       seq_stride, row_stride, scale, keep,
                                       st);
    case 2: return launch<Mode::kLoads>(q, k, v, o, bd, t, c, heads,
                                        seq_stride, row_stride, scale, keep,
                                        st);
    case 3: return launch<Mode::kProducts>(q, k, v, o, bd, t, c, heads,
                                           seq_stride, row_stride, scale,
                                           keep, st);
    case 4: return launch<Mode::kEmpty>(q, k, v, o, bd, t, c, heads,
                                        seq_stride, row_stride, scale, keep,
                                        st);
    default: return cudaErrorInvalidValue;
  }
}
