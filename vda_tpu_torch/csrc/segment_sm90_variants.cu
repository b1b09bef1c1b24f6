// The design steps of K8's Hopper code (segment_sm90.cuh), for the
// measurements of probes/bench_short_attn_sm90.py.  The operands of
// vda_segment_attention, bf16 at head width 64; `variant` picks the step:
//   0 old       the loop the Hopper code replaced (segment_attention.cu: a
//               4-warp mma.sync block per (64-row query tile, head))
//   1 sm90      the Hopper code: vda_segment_attention's own (key tiles
//               of 64 rows in a ring of six stages where the longest key
//               span is at most 1024, else of 128 rows in two; the row sums
//               by the tensor core)
//   2 bk128     key tiles of 128 rows in two stages at every span
//   3 bk64      key tiles of 64 rows in six stages at every span
//   4 loads     1's loads alone: the ring turned and every Q tile waited
//               for, nothing computed or written
//   5 products  1's products and softmax alone, on whatever the tiles hold
//               (no loads, nothing written)
// (The row sums by adds in the softmax lost and are deleted; their times are
// in PERF.md.)
// `keep` is 0 from every caller: the steps that write nothing keep their
// results alive on a branch no run takes.

#include "segment_sm90.cuh"

extern "C" int vda_segment_variant(const void* q, const void* k,
                                   const void* v, void* out,
                                   const void* tiles, int n_tiles,
                                   const void* items, int n_items,
                                   int max_span, int total, int heads, int d,
                                   long long row_stride, float scale,
                                   int keep, int variant, void* stream) {
  using vda::seg90::Config;
  using vda::seg90::Mode;
  using vda::seg90::launch;
  using vda::seg90::launch_for_span;
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t rs = static_cast<size_t>(row_stride);
  if (variant != 0 && d != vda::seg90::D) return cudaErrorInvalidValue;
  switch (variant) {
    case 0: return vda::segment_sm80(q, k, v, out, tiles, n_tiles, heads, d,
                                     row_stride, scale, true, st);
    case 1: return launch_for_span(q, k, v, out, items, n_items, max_span,
                                   total, heads, rs, scale, keep, st);
    case 2: return launch<Config<128, 2>>(q, k, v, out, items, n_items,
                                          total, heads, rs, scale, keep, st);
    case 3: return launch<Config<64, 6>>(q, k, v, out, items, n_items, total,
                                         heads, rs, scale, keep, st);
    case 4: return launch_for_span<Mode::kLoads>(
        q, k, v, out, items, n_items, max_span, total, heads, rs, scale, keep,
        st);
    case 5: return launch_for_span<Mode::kProducts>(
        q, k, v, out, items, n_items, max_span, total, heads, rs, scale, keep,
        st);
    default: return cudaErrorInvalidValue;
  }
}
