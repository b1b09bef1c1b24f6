// K8 on Hopper (sm_90a): block-diagonal self-attention over packed
// segments, bf16 at head width 64 (segment_attention.cu's vda_segment_loop
// says which shapes; fp32 and other widths keep flash_attention.cuh's
// mma.sync loop there).
//
// Replaces vda_tpu/ops/pallas_attention.py segment_attention
// (_segment_kernel).  q, k and v are (total, H * 64) rows of back-to-back
// segments, one row stride (3 H 64 when they are column slices of one fused
// projection); the output is a contiguous (total, H * 64).
//
// What bounds it on the H100: bytes at DINOv2's multi-crop shapes (64
// segments of 257 rows and 256 of 50, 16 heads: 240 MB, 0.072 ms at 3.35
// TB/s, against 20 GFLOP, 0.020 ms at 989 TFLOP/s); a long segment (1370)
// is bound by operations, as K1.  The kernel it replaces ran a 4-warp
// mma.sync block per (64-row query tile, head): 9,216 blocks, each walking
// its segment's K/V again (a 257-row segment's five times, its fifth tile
// one valid row of 64).  Here the pieces of K1's Hopper loop
// (flash_attention_sm90.cuh) run over a work table the host makes once per
// length tuple (ops/segment_kernel.py work_table):
//
//   * an item is a pass of up to three 64-row query tiles, one a consumer
//     warpgroup, against one contiguous key span: the tiles of one long
//     segment in threes (a 257-row segment: two passes, its K/V read twice,
//     not five times), or one tile each of up to three consecutive short
//     segments (<= 64 rows), whose keys lie side by side in the span, each
//     consumer masking the keys outside its own segment (the TPU's bins at
//     the size of one wgmma tile: no consumer idles on a 50-row segment);
//   * a persistent grid of one block an SM (a producer warpgroup and three
//     consumers) walks (item, head) works; one producer thread issues every
//     load by TMA over 2-D maps of the packed rows (columns, total rows)
//     with the caller's row stride: each consumer's Q tile into one of its
//     two slots, so the next work's queries arrive under this one's
//     products, and the span's K/V tiles through a ring of stages with
//     full and empty mbarriers, the next work's tiles in flight while this
//     one's run.  A box past a segment's end reads the next segment's rows
//     (masked as keys, never stored as queries); past the tensor's end TMA
//     gives zeros;
//   * a consumer runs K1's loop on its tile: S = Q K^T by wgmma (both in
//     shared memory, 128-byte swizzle), the online softmax in registers with
//     the keys outside [ks, ke) masked, P rounded to bf16 once, the row sums
//     of the rounded P by the tensor core (P times ones), O += P V by wgmma
//     with P from registers.  A K/V tile with no key of its segment is
//     released untouched; one whose keys lie in its first 16 rows runs
//     16-key products; rows past the segment are not stored;
//   * key tiles of 64 rows in a ring of six stages where the table's
//     longest span is at most 1024 keys (multi-crop), else K1's 128 rows in
//     two; items of single-tile segments load one key tile at each
//     segment's start.
//
// Rounding: K1's (fp32 scores and sums, exp2 of the scaled shifted score
// rounded to bf16, the row sums of the rounded values, one division).
#pragma once

#include <type_traits>

#include "flash_attention_sm90.cuh"  // the Hopper pieces of K1's loop

namespace vda {
namespace sm90 {

// S of a tile of 16 keys (wgmma m64n16k16, both operands in shared memory):
// a segment's last key tile when its keys lie in the first 16 rows.
template <>
struct WgmmaSS<16> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, %10, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "n"(SD));
  }
};

}  // namespace sm90

// The mma.sync loop the Hopper code replaced (segment_attention.cu), at
// every head width vda_segment_attention admits, bf16 or fp32: the fp32
// path, the widths the Hopper code refuses, and step 0 of the design's
// measurements.  tiles: n_tiles int4 {start, length, q0, 0} on the device.
cudaError_t segment_sm80(const void* q, const void* k, const void* v,
                         void* out, const void* tiles, int n_tiles, int heads,
                         int d, long long row_stride, float scale, bool bf,
                         cudaStream_t st);

namespace seg90 {

using sm90::bf16;
using sm90::D;
using sm90::Q_BYTES;
using sm90::Q_ROWS;
using sm90::ROW_BYTES;

constexpr int NC = 3;          // consumer warpgroups: one Q tile each
// an item: {k0, nk, own, n_own}, then {q0, qn, ks, ke} x NC (own: a key
// tile at each of the n_own consumers' segment starts, for segments of at
// most one tile)
constexpr int kItemInts = 16;

// What the consumers compute: the function, or for the design's
// measurements its loads alone (the ring turned, nothing computed or
// written) or its products alone (on whatever the tiles hold: no loads,
// nothing written).
enum class Mode { kFull, kLoads, kProducts };

template <int BK_, int STAGES_, Mode MODE_ = Mode::kFull>
struct Config {
  static_assert(BK_ % 64 == 0 && BK_ <= 256, "key tile");
  static constexpr int bk = BK_, stages = STAGES_;
  static constexpr Mode mode = MODE_;
  static constexpr int threads = 128 * (NC + 1);
  static constexpr int kv_bytes = BK_ * ROW_BYTES;
  static constexpr int k_off = 2 * NC * Q_BYTES;  // two Q slots a consumer
  static constexpr int v_off = k_off + STAGES_ * kv_bytes;
  static constexpr int bar_off = v_off + STAGES_ * kv_bytes;
  static constexpr int n_bars = 4 * STAGES_ + 4 * NC;
  // the ones block of the row sums: P times a 16 x 8 block of ones, as in
  // K1's configuration (adds in the softmax were 3-10% slower, PERF.md)
  static constexpr int ones_off = (bar_off + 8 * n_bars + 127) / 128 * 128;
  // + 1024: the base is aligned up to the 1024-byte swizzle period
  static constexpr int smem_bytes = ones_off + 1024 + 1024;
  static constexpr int producer_regs = 32;
  static constexpr int consumer_regs = 160;
  static_assert(smem_bytes <= 232448, "shared memory of a block");
};

// softmax_tile (flash_attention_sm90.cuh) with the keys of the tile outside
// [lo, hi) masked when MASKED (at least one key inside); the row sums are
// the caller's (by the tensor core).
template <int BK, bool MASKED>
__device__ __forceinline__ void softmax_range(const float (&s)[BK / 2],
                                              uint32_t (&p)[BK / 16][4],
                                              float (&m)[2],
                                              float (&alpha)[2], float sl2,
                                              int lo, int hi, int t) {
  auto out = [&](int key) { return MASKED && (key < lo || key >= hi); };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1] = fmaxf(mx[e >> 1],
                         out(j * 8 + 2 * t + (e & 1)) ? -INFINITY
                                                       : s[4 * j + e]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: a key is inside
    alpha[r] = sm90::ex2((m[r] - m_new) * sl2);  // 0 on the first tile
    m[r] = m_new;
    mb[r] = m_new * sl2;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x0 = out(j * 8 + 2 * t) ? -INFINITY
                                          : fmaf(s[4 * j + 2 * r], sl2, -mb[r]);
      const float x1 = out(j * 8 + 2 * t + 1)
                           ? -INFINITY
                           : fmaf(s[4 * j + 2 * r + 1], sl2, -mb[r]);
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(sm90::ex2(x0), sm90::ex2(x1));
      p[j / 2][2 * (j % 2) + r] = *reinterpret_cast<const uint32_t*>(&v);
    }
}

// tmq/tmk/tmv: 2-D maps (columns, total rows) with boxes of 64 columns by
// 64 (q) or BK (k, v) rows; items: n_items records of kItemInts ints;
// works: n_items * heads, work w = item w / heads, head w % heads.
template <class C>
__global__ void __launch_bounds__(C::threads, 1)
    segment90_kernel(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     bf16* __restrict__ out, const int4* __restrict__ items,
                     int n_works, int heads, float scale, int keep) {
  using namespace sm90;
  constexpr int BK = C::bk, S = C::stages;
  constexpr bool kLoad = C::mode != Mode::kProducts;
  constexpr bool kCompute = C::mode != Mode::kLoads;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base + C::k_off, v_s = base + C::v_off;
  auto q_s = [&](int c, int slot) {
    return base + (2 * c + slot) * Q_BYTES;
  };
  // mbarriers: full_k, full_v, empty_k, empty_v of each stage, then
  // q_full and q_empty of each consumer's two slots
  const uint32_t bars = base + C::bar_off;
  auto full_k = [&](int kt) { return bars + 8 * (kt % S); };
  auto full_v = [&](int kt) { return bars + 8 * (S + kt % S); };
  auto empty_k = [&](int kt) { return bars + 8 * (2 * S + kt % S); };
  auto empty_v = [&](int kt) { return bars + 8 * (3 * S + kt % S); };
  auto q_full = [&](int c, int slot) {
    return bars + 8 * (4 * S + 2 * c + slot);
  };
  auto q_empty = [&](int c, int slot) {
    return bars + 8 * (4 * S + 2 * NC + 2 * c + slot);
  };
  auto parity = [&](int kt) { return static_cast<uint32_t>((kt / S) & 1); };
  // an item's key tiles: BK-row tiles from k0 over its span (own 0), or
  // one at each consumer's segment start (own 1: segments of at most one
  // tile each; the header's last field counts them)
  auto n_tiles = [&](const int4 hdr) {
    return hdr.z ? hdr.w : (hdr.y + BK - 1) / BK;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * NC);
      mbar_init(empty_v(s), 4 * NC);
    }
    for (int c = 0; c < NC; ++c)
      for (int slot = 0; slot < 2; ++slot) {
        mbar_init(q_full(c, slot), 1);
        mbar_init(q_empty(c, slot), 4);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    // the ones block of the row sums, for the tensor core's (async) proxy
    if (threadIdx.x < 256)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + C::ones_off +
                                                      4 * threadIdx.x),
                   "r"(0x3f803f80u)
                   : "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<C::producer_regs>();
    if (kLoad && threadIdx.x == 0) {
      tma_prefetch(&tmq);
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
      int kt = 0;                  // K/V tiles issued
      int nq[NC] = {0, 0, 0};      // Q tiles issued to each consumer
      for (int w = blockIdx.x; w < n_works; w += gridDim.x) {
        const int4* rec = items + (w / heads) * (kItemInts / 4);
        const int h = w % heads;
        const int4 hdr = rec[0];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int4 cr = rec[1 + c];
          if (cr.y <= 0) continue;
          const int slot = nq[c] & 1;
          mbar_wait(q_empty(c, slot), ((nq[c] >> 1) & 1) ^ 1);
          mbar_expect_tx(q_full(c, slot), Q_BYTES);
          tma_load_2d(q_s(c, slot), &tmq, h * D, cr.x, q_full(c, slot));
          ++nq[c];
        }
        const int nkt = n_tiles(hdr);
        for (int j = 0; j < nkt; ++j, ++kt) {
          // a BK-row tile of the span, or consumer j's segment's own tile
          const int row = hdr.z ? rec[1 + j].z : hdr.x + j * BK;
          // a stage is free once the consumers released its previous tile
          mbar_wait(empty_k(kt), parity(kt) ^ 1);
          mbar_expect_tx(full_k(kt), C::kv_bytes);
          tma_load_2d(k_s + (kt % S) * C::kv_bytes, &tmk, h * D, row,
                      full_k(kt));
          mbar_wait(empty_v(kt), parity(kt) ^ 1);
          mbar_expect_tx(full_v(kt), C::kv_bytes);
          tma_load_2d(v_s + (kt % S) * C::kv_bytes, &tmv, h * D, row,
                      full_v(kt));
        }
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<C::consumer_regs>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float sl2 = scale * 1.4426950408889634f;
  const int hd = heads * D;
  auto release = [&](uint32_t bar) {
    if (kLoad && lane == 0) mbar_arrive(bar);
  };
  auto wait = [&](uint32_t bar, uint32_t par) {
    if (kLoad) mbar_wait(bar, par);
  };
  int kt = 0, nq = 0;
  // the next work's header and this consumer's record, loaded ahead
  int4 next_hdr, next_cr;
  auto fetch = [&](int w) {
    if (w < n_works) {
      const int4* rec = items + (w / heads) * (kItemInts / 4);
      next_hdr = rec[0];
      next_cr = rec[1 + c];
    }
  };
  fetch(blockIdx.x);
  for (int w = blockIdx.x; w < n_works; w += gridDim.x) {
    const int4 hdr = next_hdr, cr = next_cr;
    fetch(w + gridDim.x);
    const int h = w % heads;
    const int nkt = n_tiles(hdr);
    if (cr.y <= 0 || !kCompute) {  // no tile here: keep the ring turning
      for (int j = 0; j < nkt; ++j, ++kt) {
        wait(full_k(kt), parity(kt));
        release(empty_k(kt));
        wait(full_v(kt), parity(kt));
        release(empty_v(kt));
      }
      if (cr.y > 0) {  // kLoads: the Q tile arrived and is given back
        wait(q_full(c, nq & 1), (nq >> 1) & 1);
        release(q_empty(c, nq & 1));
        ++nq;
      }
      continue;
    }
    const int slot = nq & 1;
    wait(q_full(c, slot), (nq >> 1) & 1);
    const uint64_t dq = desc_sw128(q_s(c, slot));
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, alpha[2];
    float ls[4] = {0.f, 0.f, 0.f, 0.f};  // row sums by the tensor core
    // the ones block: B of the row sums, 16 x 8, any layout reads ones
    const uint64_t ones = static_cast<uint64_t>(
                              ((base + C::ones_off) & 0x3FFFF) >> 4) |
                          static_cast<uint64_t>(128 >> 4) << 16 |
                          static_cast<uint64_t>(256 >> 4) << 32;
    // One K/V tile, its keys [lo, hi) of this consumer's segment, by
    // products N keys wide: BK, or 16 where the keys all lie in the tile's
    // first 16 rows (a segment's last key tile holding one row, 257 = 4 x
    // 64 + 1: a quarter of the products, softmax and value product)
    uint64_t da[D / 16], dk[D / 16], dv[BK / 16], d1[1];
    auto tile = [&](auto width, int kt, int lo, int hi) {
      constexpr int N = decltype(width)::value;
      float sn[N / 2];  // written whole by the first k-step (scale-d 0)
      uint32_t pn[N / 16][4];
      const uint64_t dkt = desc_sw128(k_s + (kt % S) * C::kv_bytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        da[kk] = dq + 2 * kk;
        dk[kk] = dkt + 2 * kk;
      }
      pin(da);
      pin(dk);
      fence_regs(sn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        if (kk == 0)
          WgmmaSS<N>::template run<0>(sn, da[kk], dk[kk]);
        else
          WgmmaSS<N>::template run<1>(sn, da[kk], dk[kk]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sn);
      release(empty_k(kt));
      if (lo > 0 || hi < N)
        softmax_range<N, true>(sn, pn, m, alpha, sl2, lo, hi, t);
      else
        softmax_range<N, false>(sn, pn, m, alpha, sl2, 0, N, t);
      rescale(o, alpha);
      rescale(ls, alpha);
      wait(full_v(kt), parity(kt));
      const uint64_t dvt = desc_sw128(v_s + (kt % S) * C::kv_bytes);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) dv[kk] = dvt + 128 * kk;
      d1[0] = ones;
      pin(dv);
      pin(d1);
      fence_regs(o);
      fence_regs(ls);
      fence_regs<N / 16>(pn);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        WgmmaRS<D>::template run<1>(o, pn[kk], dv[kk]);
        WgmmaRS<8>::template run<1>(ls, pn[kk], d1[0]);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ls);
      release(empty_v(kt));
    };
    for (int j = 0; j < nkt; ++j, ++kt) {
      // the tile's keys of this consumer's segment: [lo, hi); with a tile
      // for each consumer, its own tile alone
      const bool mine = hdr.z == 0 || j == c;
      const int tile0 = hdr.z ? cr.z : hdr.x + j * BK;
      const int lo = max(cr.z - tile0, 0);
      const int hi = mine ? min(cr.w - tile0, BK) : 0;
      wait(full_k(kt), parity(kt));
      if (hi <= lo) {  // no key of this segment in the tile
        release(empty_k(kt));
        wait(full_v(kt), parity(kt));
        release(empty_v(kt));
      } else if (BK == 64 && lo == 0 && hi <= 16) {
        // (the 64-row configuration alone: the 128-row one is at ptxas's
        // register cap already)
        if constexpr (BK == 64)
          tile(std::integral_constant<int, 16>{}, kt, lo, hi);
      } else {
        tile(std::integral_constant<int, BK>{}, kt, lo, hi);
      }
    }
    release(q_empty(c, slot));  // every product that read Q is done
    ++nq;
    // every column of the (64, 8) sums is the row sum
    const float l[2] = {ls[0], ls[2]};
    if (C::mode == Mode::kProducts && !keep) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      if (row >= cr.y) continue;
      bf16* dst = out + static_cast<size_t>(cr.x + row) * hd + h * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
            __floats2bfloat162_rn(o[4 * jj + 2 * r] / l[r],
                                  o[4 * jj + 2 * r + 1] / l[r]);
    }
  }
}

// ---- host side ----

// A map over the packed rows of one operand: `cols` (H * 64) columns of
// `rows` rows `rs` elements apart; boxes of 64 columns by `box_rows` rows
// in the 128-byte swizzle, zero outside the tensor.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols,
                            int rows, size_t rs, int box_rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {rs * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(D),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k, v: 16-byte aligned, row r at x + r * rs (rs a multiple of 8, at
// least H * 64); items: n_items records on the device (the host checked
// them: every key span and query tile inside the rows); out: contiguous
// (total, H * 64); scale > 0.
template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const void* items, int n_items, int total, int heads,
                   size_t rs, float scale, int keep, cudaStream_t stream) {
  if (!(scale > 0.f) || n_items <= 0 || total <= 0 || heads <= 0 ||
      rs % 8 || rs < static_cast<size_t>(heads) * D ||
      static_cast<long long>(n_items) * heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e = make_map(&mq, q, heads * D, total, rs, Q_ROWS);
  if (e == cudaSuccess) e = make_map(&mk, k, heads * D, total, rs, C::bk);
  if (e == cudaSuccess) e = make_map(&mv, v, heads * D, total, rs, C::bk);
  if (e != cudaSuccess) return e;
  auto kern = segment90_kernel<C>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::smem_bytes);
  if (e != cudaSuccess) return e;
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInvalidValue;
  const int works = n_items * heads;
  kern<<<works < sms ? works : sms, C::threads, C::smem_bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<const int4*>(items),
      works, heads, scale, keep);
  return cudaGetLastError();
}

// The configuration for a table whose longest key span is max_span: key
// tiles of 64 rows in a ring of six stages up to kShortSpan keys (less
// padding past a short segment's end, a mixed pass's later tiles loaded
// early), else K1's 128 rows in two.
constexpr int kShortSpan = 1024;
template <Mode M = Mode::kFull>
cudaError_t launch_for_span(const void* q, const void* k, const void* v,
                            void* out, const void* items, int n_items,
                            int max_span, int total, int heads, size_t rs,
                            float scale, int keep, cudaStream_t st) {
  if (max_span <= kShortSpan)
    return launch<Config<64, 6, M>>(q, k, v, out, items, n_items, total,
                                    heads, rs, scale, keep, st);
  return launch<Config<128, 2, M>>(q, k, v, out, items, n_items, total,
                                   heads, rs, scale, keep, st);
}

}  // namespace seg90
}  // namespace vda
