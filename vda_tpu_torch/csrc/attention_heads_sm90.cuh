// Several heads of the same 64 query rows in one block, on the Hopper loop
// of flash_attention_sm90.cuh (TMA, mbarriers, wgmma, its softmax): K7's
// attention + out-projection + LayerScale + residual (attention_proj.cu,
// bf16 at head width 64) and K12's "heads2" geometry (attention_variants.cu).
//
// K7 computes, over the fused qkv projection (B, N, 3C), C = H * 64,
//
//   out = x + gamma * (attn(q, k, v) @ W^T + bias)
//
// and the out-projection contracts over every head, so a block (or a
// cluster pair of blocks) owns one batch row and one 64-row query tile
// across all heads.  What bounds it on the H100 is the tensor cores (vitl:
// 4 B N^2 C of attention and 2 B N C^2 of projection, 0.342 ms at 989
// TFLOP/s); what the fusion saves is the (B, N, C) attention output's trip
// through device memory and the two elementwise passes of the LayerScale
// and the residual.  What a block may hold shapes the design: the tile's
// head outputs are 64 x C bf16, 128 KB of the 227 KB at C = 1024.  The
// design:
//
//   * a block of NC + 1 warpgroups.  Warpgroup 0 is the producer: warp c
//     (lane 0) issues every TMA load of consumer c, so the consumers never
//     wait on one another's loads.  Consumer c (warpgroup c + 1) runs heads
//     c, c + NC, c + 2 NC, ... of the block's heads, one after another;
//   * consumer c's region of shared memory holds its Q tile (64 x 64, 8 KB)
//     and its ring of STAGES K and V tiles of BK keys, guarded as in K1's
//     loop (full barriers with expect_tx, empty barriers the consumer's
//     warps arrive on).  The producer loads a head's Q after the head's
//     first K/V tile and once the consumer released the previous head's Q
//     (right after that head's last Q K^T, so the load runs under the last
//     tile's softmax and P V); with QBUF 2 a consumer has two Q buffers and
//     the next head's Q loads while this head runs;
//   * a head is K1's loop: S = Q K^T by wgmma from shared memory,
//     softmax_tile in registers (the scale folded into one exp2 FMA, P
//     rounded to bf16 once), O += P V with P from registers and, with
//     SUM_MMA, the row sums by the tensor core (P times a block of ones);
//     each product waited for before the softmax, or with OVERLAP K1's
//     overlapped schedule (the next tile's Q K^T and this tile's P V in
//     flight during the next softmax);
//   * the head's normalised output, rounded to bf16 as the TPU kernel and
//     the twin round it, goes into the head-output tile: one 64 x 64 block
//     of 8 KB a head, written in the 128-byte swizzle that TMA gives Q
//     (16-byte chunk j of row r at chunk j ^ (r % 8): the 8 rows a warp's
//     store touches fall in 8 different chunks, no bank conflict), so the
//     tile is at once the A operand of the projection;
//   * SPLIT 1: one block a tile holds the whole head-output tile, so its
//     rings are small (64-key tiles), and they are what a consumer waits
//     on: the loads from L2 are not hidden.  SPLIT 2 (the default): a
//     cluster of two blocks on the same 64 rows, each attending to half of
//     the heads into half a tile (64 KB at C = 1024), which leaves room
//     for 128-key tiles and three consumers, and doubles the blocks (1408
//     at vitl's window: 10.7 waves in place of 5.3).  Once a block's
//     consumers are past their heads (a fence to the async proxy and a
//     named barrier), it tells the other block, which then copies its half
//     into this block's freed rings (cp.async.bulk from shared memory to
//     the other block's, completing on this block's mbarrier), and this
//     block its half there;
//   * the projection: each block takes its half of the output chunks of PN
//     columns (SPLIT 1: all), consumer c chunks c, c + NC, ... of them.
//     For each chunk the producer streams W's (PN x 64) tiles, rows of W
//     (out, in) being K-major B as they are stored, by TMA through a ring
//     of WSTAGES in the freed attention rings (SPLIT 2: and past them,
//     where the rings need more room).  W (2 MB at vitl) stays in
//     L2 across blocks.  acc (64 x PN) += O_h (64 x 64) W_h^T by wgmma,
//     both operands in shared memory, over every head;
//   * the epilogue x + gamma * (acc + bias) in fp32 with one rounding, from
//     registers to device memory, rows < N and columns < C; with VEC the
//     accumulator's column pairs are first transposed within each quad of
//     threads (two xor shuffles), so that x, gamma, bias and out move as
//     16-byte accesses, whole 32-byte sectors.
//
// K7's default is K7SM90 at the end of this file; its measured
// alternatives are configurations in attention_proj_sm90_variants.cu
// (probes/bench_attn_proj_sm90.py).  heads2 (PHASES kHeads) runs the
// attention half alone, NC heads a block, each head's output stored as K1
// stores it.
//
// Keys at or beyond valid_len are masked in the last tile only.  The
// scale must be positive (the max is taken over unscaled scores).
#pragma once

#include "flash_attention_sm90.cuh"

namespace vda {
namespace sm90 {

// What a block runs: K7's two phases (kBoth); for K7's design measurements
// the attention alone (kAttention: the epilogue adds x + gamma * bias, no
// projection) or the projection alone (kProjection: over a zeroed
// head-output tile); or K12's heads2 (kHeads: NC heads a block, stored
// without a projection).
enum class Phases { kBoth, kAttention, kProjection, kHeads };

template <int NC_, int BK_, int STAGES_, bool SUM_MMA_, int PN_ = 128,
          int WSTAGES_ = 2, Phases PHASES_ = Phases::kBoth, int SPLIT_ = 1,
          int QBUF_ = 1, bool OVERLAP_ = false, bool VEC_ = false>
struct HeadsConfig {
  static_assert(NC_ >= 1 && NC_ <= 3, "consumer warpgroups");
  static_assert(BK_ % 16 == 0 && BK_ <= 128, "wgmma n and TMA box rows");
  static_assert(PN_ == 32 || PN_ == 64 || PN_ == 128 || PN_ == 256,
                "projection chunk");
  static_assert(SPLIT_ == 1 || (SPLIT_ == 2 && PHASES_ != Phases::kHeads),
                "a cluster pair splits the heads of a projection");
  static_assert(QBUF_ == 1 || QBUF_ == 2, "Q buffers of a consumer");
  static constexpr int nc = NC_, bk = BK_, stages = STAGES_;
  static constexpr int pn = PN_, wstages = WSTAGES_, split = SPLIT_;
  // QBUF 2: the next head's Q loads while this head runs
  static constexpr int qbuf = QBUF_;
  // K1's OVERLAP: the next tile's Q K^T issued with this tile's P V before
  // this tile's softmax
  static constexpr bool overlap = OVERLAP_;
  // VEC: the epilogue's x, gamma, bias and out as 16-byte accesses, after
  // a transpose of the accumulator within each quad of threads
  static constexpr bool vec = VEC_;
  static constexpr bool sum_mma = SUM_MMA_;
  static constexpr Phases phases = PHASES_;
  // the head-output tile and the projection's W ring exist
  static constexpr bool proj = PHASES_ != Phases::kHeads;
  static constexpr int threads = 128 * (NC_ + 1);
  static constexpr int kv_bytes = BK_ * ROW_BYTES;
  static constexpr int w_bytes = PN_ * ROW_BYTES;  // a W tile: PN rows of 64
  // a consumer's region: its Q buffers, then its K ring and its V ring;
  // later (SPLIT 1) its W ring
  static constexpr int region = QBUF_ * Q_BYTES + 2 * STAGES_ * kv_bytes;
  // SPLIT 2, the projection: the partner's half of the head-output tile
  // (at most 8 heads) at the base, then the consumers' W rings, over the
  // attention rings and, where they need more, past them
  static constexpr int recv_bytes = 8 * Q_BYTES;
  static constexpr int w_off = SPLIT_ == 2 ? recv_bytes : 0;
  static constexpr int w_ring = WSTAGES_ * w_bytes;
  static_assert(!proj || SPLIT_ == 2 || w_ring <= region,
                "SPLIT 1: a W ring in its consumer's freed region");
  static constexpr int rings = SPLIT_ == 2 && w_off + NC_ * w_ring >
                                                 NC_ * region
                                   ? w_off + NC_ * w_ring
                                   : NC_ * region;
  static constexpr int o_off = rings;  // the head-output tile
  // mbarriers of a consumer: q_full and q_empty of each Q buffer, full_k,
  // full_v, empty_k and empty_v of each stage, w_full and w_empty of each W
  // stage; then (SPLIT 2) the block's attn_done, peer_ready and o_recv
  static constexpr int n_bars = 2 * QBUF_ + 4 * STAGES_ + 2 * WSTAGES_;
  static constexpr int n_block_bars = SPLIT_ == 2 ? 3 : 0;
  // registers a thread after setmaxnreg, as K1's loop sets them
  static constexpr int producer_regs = NC_ == 3 ? 32 : 24;
  static constexpr int consumer_regs = NC_ == 3 ? 160 : NC_ == 2 ? 240 : 256;
};

// Shared memory of a block of C for `heads` heads (a head-output block of
// 8 KB a head with the projection); + 1024: the base is aligned up to the
// 1024-byte swizzle period.
template <class C>
constexpr int heads_smem_bytes(int heads) {
  return (C::o_off + (C::proj ? (heads + C::split - 1) / C::split * Q_BYTES
                              : 0) +
          8 * (C::nc * C::n_bars + C::n_block_bars) + 127) /
             128 * 128 +
         (C::sum_mma ? 1024 : 0) + 1024;
}

template <int NT>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// Every thread of both blocks of the cluster arrives, then waits for all
// (not .aligned: a warp may reach it diverged).
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// The address of the shared-memory offset addr in block cta of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(cta));
  return r;
}

// bytes of this block's shared memory at src into another block's at the
// cluster address dst, completing on the mbarrier at the cluster address
// bar (in the destination block).
__device__ __forceinline__ void bulk_copy_to_peer(uint32_t dst, uint32_t src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One 64-row query tile of batch blockIdx.z: blockIdx.x (SPLIT 1) or
// blockIdx.x / 2 (SPLIT 2, a cluster pair).  SPLIT 1: with the projection
// every head, else heads blockIdx.y * NC .. + NC - 1.  SPLIT 2: the
// cluster's block of rank r attends to its half of the heads (rank 0 the
// first ceil(H / 2)) and projects its half of the output chunks.
// tmq/tmk/tmv: 3-D maps (columns, tokens, batch) of q, k and v, boxes of 64
// columns by 64 (q) or BK (k, v) rows; tmw: a map of W (C, C) (out, in),
// boxes of 64 inputs by PN outputs; gb: (2, C) fp32 [gamma; bias]; x and
// out: contiguous (B, N, C) (kHeads: out (B, N, H * 64), x and gb unused).
template <class C>
__global__ void __launch_bounds__(C::threads, 1)
    attention_heads_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                                const __grid_constant__ CUtensorMap tmk,
                                const __grid_constant__ CUtensorMap tmv,
                                const __grid_constant__ CUtensorMap tmw,
                                bf16* __restrict__ out,
                                const bf16* __restrict__ x,
                                const float* __restrict__ gb, int n,
                                int heads, int valid_len, float scale) {
  constexpr int BK = C::bk, S = C::stages, WS = C::wstages, NC = C::nc;
  constexpr int PN = C::pn, SUB = PN < 128 ? PN : 128, NB = PN / SUB;
  constexpr int SPLIT = C::split, QB = C::qbuf;
  constexpr Phases PH = C::phases;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t o_s = base + C::o_off;
  const int split_heads = (heads + SPLIT - 1) / SPLIT;  // rank 0's share
  const uint32_t bar0 = o_s + (C::proj ? split_heads * Q_BYTES : 0);
  const uint32_t ones_s =
      (bar0 + 8 * (NC * C::n_bars + C::n_block_bars) + 127) & ~127u;
  const uint32_t rank = SPLIT == 2 ? cluster_ctarank() : 0;
  const int q0 = (blockIdx.x / SPLIT) * Q_ROWS, b = blockIdx.z;
  const int n_tiles = (valid_len + BK - 1) / BK;
  const int cd = heads * D;  // C
  const int wg = threadIdx.x / 128;
  // this block's heads [h_lo, h_hi) and the partner's [p_lo, p_hi) (SPLIT
  // 2); output chunks [ch_lo, ch_hi) of PN columns
  const int h_lo = rank == 0 ? 0 : split_heads;
  const int h_hi = SPLIT == 1 || rank == 1 ? heads : split_heads;
  const int p_lo = rank == 0 ? split_heads : 0;
  const int p_hi = rank == 0 ? heads : split_heads;
  const int n_chunks = (cd + PN - 1) / PN;
  const int ch_lo = rank == 0 ? 0 : (n_chunks + 1) / 2;
  const int ch_hi = SPLIT == 1 || rank == 1 ? n_chunks : (n_chunks + 1) / 2;
  const int n_k = heads;  // k-tiles of the projection: one a head

  // the heads of consumer c: K7 h_lo + c, h_lo + c + NC, ...; heads2
  // blockIdx.y NC + c
  auto n_heads_of = [&](int c) {
    return C::proj ? (h_hi - h_lo - c + NC - 1) / NC
                   : (static_cast<int>(blockIdx.y) * NC + c < heads ? 1 : 0);
  };
  auto head_of = [&](int c, int i) {
    return C::proj ? h_lo + c + i * NC
                   : static_cast<int>(blockIdx.y) * NC + c;
  };
  // consumer c's region and barriers
  auto region = [&](int c) { return base + c * C::region; };
  auto bar = [&](int c, int i) { return bar0 + 8 * (c * C::n_bars + i); };
  // consumer c's Q buffer of its head i and the buffer's barriers
  auto q_buf = [&](int c, int i) { return region(c) + (i % QB) * Q_BYTES; };
  auto q_full = [&](int c, int i) { return bar(c, i % QB); };
  auto q_empty = [&](int c, int i) { return bar(c, QB + i % QB); };
  constexpr int KV0 = 2 * QB;  // the first ring barrier
  auto full_k = [&](int c, int j) { return bar(c, KV0 + j % S); };
  auto full_v = [&](int c, int j) { return bar(c, KV0 + S + j % S); };
  auto empty_k = [&](int c, int j) { return bar(c, KV0 + 2 * S + j % S); };
  auto empty_v = [&](int c, int j) { return bar(c, KV0 + 3 * S + j % S); };
  auto w_full = [&](int c, int u) { return bar(c, KV0 + 4 * S + u % WS); };
  auto w_empty = [&](int c, int u) {
    return bar(c, KV0 + 4 * S + WS + u % WS);
  };
  // SPLIT 2: the block's consumers are past their heads (for the
  // producer), the partner's are (its rings are free, its half of the tile
  // written), the partner's half has landed here
  const uint32_t attn_done = bar0 + 8 * NC * C::n_bars;
  const uint32_t peer_ready = attn_done + 8, o_recv = attn_done + 16;
  // consumer c's W ring
  auto w_ring = [&](int c) {
    return SPLIT == 1 ? region(c) : base + C::w_off + c * C::w_ring;
  };
  // the phase of a ring's barriers that use j of an R-stage ring waits for
  auto parity = [](int j, int r) { return static_cast<uint32_t>((j / r) & 1); };

  if (threadIdx.x == 0) {
    for (int c = 0; c < NC; ++c) {
      for (int i = 0; i < QB; ++i) {
        mbar_init(q_full(c, i), 1);
        mbar_init(q_empty(c, i), 4);
      }
      for (int s = 0; s < S; ++s) {
        mbar_init(full_k(c, s), 1);
        mbar_init(full_v(c, s), 1);
        mbar_init(empty_k(c, s), 4);
        mbar_init(empty_v(c, s), 4);
      }
      for (int s = 0; s < WS; ++s) {
        mbar_init(w_full(c, s), 1);
        mbar_init(w_empty(c, s), 4);
      }
    }
    if constexpr (SPLIT == 2) {
      mbar_init(attn_done, 1);
      mbar_init(peer_ready, 1);
      mbar_init(o_recv, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::sum_mma) {
    // the ones block of the row sums, for the tensor core's (async) proxy
    if (threadIdx.x < 256)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ones_s +
                                                      4 * threadIdx.x),
                   "r"(0x3f803f80u)
                   : "memory");
    fence_proxy_async();
  }
  if constexpr (SPLIT == 2)
    cluster_sync_all();  // the partner's barriers exist before any arrival
  else
    __syncthreads();

  if (wg == 0) {  // producer: warp c serves consumer c
    setmaxnreg_dec<C::producer_regs>();
    const int c = threadIdx.x / 32;
    if (c < NC && threadIdx.x % 32 == 0) {
      tma_prefetch(&tmq);
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
      const uint32_t k_s = region(c) + QB * Q_BYTES;
      const uint32_t v_s = k_s + S * C::kv_bytes;
      const int nh = PH == Phases::kProjection ? 0 : n_heads_of(c);
      auto load = [&](int j, uint32_t tiles, const CUtensorMap* map,
                      uint32_t full, uint32_t empty, int h, int kt) {
        mbar_wait(empty, parity(j, S) ^ 1);  // the first round passes
        mbar_expect_tx(full, C::kv_bytes);
        tma_load(tiles + (j % S) * C::kv_bytes, map, h * D, kt * BK, b,
                 full);
      };
      // Q of head i once its buffer's previous head released it
      auto load_q = [&](int i) {
        if (i >= QB) mbar_wait(q_empty(c, i), parity(i - QB, QB));
        mbar_expect_tx(q_full(c, i), Q_BYTES);
        tma_load(q_buf(c, i), &tmq, head_of(c, i) * D, q0, b, q_full(c, i));
      };
      for (int i = 0; i < nh; ++i) {
        const int h = head_of(c, i);
        for (int kt = 0; kt < n_tiles; ++kt) {
          const int j = i * n_tiles + kt;
          load(j, k_s, &tmk, full_k(c, j), empty_k(c, j), h, kt);
          load(j, v_s, &tmv, full_v(c, j), empty_v(c, j), h, kt);
          // after the head's first K/V tile: its Q (QBUF 1), or the next
          // head's (QBUF 2)
          if (kt == 0 && QB == 1) load_q(i);
          if (kt == 0 && QB == 2) {
            if (i == 0) load_q(0);
            if (i + 1 < nh) load_q(i + 1);
          }
        }
      }
      if constexpr (C::proj && PH != Phases::kAttention) {
        tma_prefetch(&tmw);
        if constexpr (SPLIT == 1) {
          // the region is free once its last tiles and last Q are released
          const int last = nh * n_tiles;
          for (int j = last > S ? last - S : 0; j < last; ++j) {
            mbar_wait(empty_k(c, j), parity(j, S));
            mbar_wait(empty_v(c, j), parity(j, S));
          }
          for (int i = nh > QB ? nh - QB : 0; i < nh; ++i)
            mbar_wait(q_empty(c, i), parity(i, QB));
        } else {
          mbar_wait(attn_done, 0);  // every consumer's rings are free
        }
        int u = 0;
        for (int ch = ch_lo + c; ch < ch_hi; ch += NC)
          for (int kk = 0; kk < n_k; ++kk, ++u) {
            mbar_wait(w_empty(c, u), parity(u, WS) ^ 1);
            mbar_expect_tx(w_full(c, u), C::w_bytes);
            tma_load(w_ring(c) + (u % WS) * C::w_bytes, &tmw, kk * D,
                     ch * PN, 0, w_full(c, u));
          }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<C::consumer_regs>();
    const int c = wg - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const float sl2 = scale * 1.4426950408889634f;
    auto release = [&](uint32_t empty) {
      if (lane == 0) mbar_arrive(empty);
    };
    const uint32_t k_s = region(c) + QB * Q_BYTES;
    const uint32_t v_s = k_s + S * C::kv_bytes;

    if constexpr (PH != Phases::kProjection) {
      const int nh = n_heads_of(c);
      // the ones block: B of the row sums, 16 x 8, any layout reads ones
      const uint64_t ones = static_cast<uint64_t>((ones_s & 0x3FFFF) >> 4) |
                            static_cast<uint64_t>(128 >> 4) << 16 |
                            static_cast<uint64_t>(256 >> 4) << 32;
      for (int i = 0; i < nh; ++i) {
        const uint64_t dq = desc_sw128(q_buf(c, i));
        const int h = head_of(c, i);
        float o[D / 2], ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
        float s[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
        // P: two buffers with OVERLAP, one read by the P V in flight while
        // the softmax writes the other (K1's loop says why not one)
        uint32_t pa[BK / 16][4], pb[BK / 16][4];
        uint64_t da[D / 16], dk[D / 16], dv[BK / 16], d1[1];
        mbar_wait(q_full(c, i), parity(i, QB));
        const int j0 = i * n_tiles;  // the ring's use of tile 0
        // the descriptors of a batch's wgmmas, made and pinned before its
        // fence
        auto desc_k = [&](int j) {
          const uint64_t d = desc_sw128(k_s + (j % S) * C::kv_bytes);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            da[kk] = dq + 2 * kk;
            dk[kk] = d + 2 * kk;
          }
          pin(da);
          pin(dk);
        };
        auto desc_v = [&](int j) {
          const uint64_t d = desc_sw128(v_s + (j % S) * C::kv_bytes);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) dv[kk] = d + 128 * kk;
          d1[0] = ones;
          pin(dv);
          if constexpr (C::sum_mma) pin(d1);
        };
        auto issue_s = [&]() {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            if (kk == 0)
              WgmmaSS<BK>::template run<0>(s, da[kk], dk[kk]);
            else
              WgmmaSS<BK>::template run<1>(s, da[kk], dk[kk]);
        };
        auto issue_pv = [&](const uint32_t (&p)[BK / 16][4]) {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            WgmmaRS<D>::template run<1>(o, p[kk], dv[kk]);
            if constexpr (C::sum_mma)
              WgmmaRS<8>::template run<1>(ls, p[kk], d1[0]);
          }
        };
        // the K tile of use j is read: release it (and, the head's last,
        // its Q)
        auto release_k = [&](int kt) {
          release(empty_k(c, j0 + kt));
          if (kt == n_tiles - 1) release(q_empty(c, i));
        };
        auto softmax = [&](int kt, uint32_t (&pn)[BK / 16][4]) {
          if (kt == n_tiles - 1)
            softmax_tile<BK, true, 0, !C::sum_mma>(s, pn, m, l, alpha, sl2,
                                                   valid_len - kt * BK, t);
          else
            softmax_tile<BK, false, 0, !C::sum_mma>(s, pn, m, l, alpha, sl2,
                                                    BK, t);
        };
        if constexpr (C::overlap) {
          // K1's overlapped schedule: the products of tile kt (Q K^T) and
          // of tile kt - 1 (P V) are issued together before tile kt's
          // softmax, which runs while they execute
          mbar_wait(full_k(c, j0), parity(j0, S));
          desc_k(j0);
          fence_regs(s);
          wgmma_fence();
          issue_s();
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          release_k(0);
          softmax(0, pa);
          auto batch = [&](int kt, uint32_t (&pc)[BK / 16][4],
                           uint32_t (&pn)[BK / 16][4]) {
            const int j = j0 + kt;
            mbar_wait(full_k(c, j), parity(j, S));
            mbar_wait(full_v(c, j - 1), parity(j - 1, S));
            desc_k(j);
            desc_v(j - 1);
            fence_regs(s);
            fence_regs(o);
            fence_regs(ls);
            fence_regs<BK / 16>(pc);
            wgmma_fence();
            issue_s();
            wgmma_commit();
            issue_pv(pc);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(s);
            release_k(kt);
            softmax(kt, pn);
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(ls);
            fence_regs<BK / 16>(pc);
            release(empty_v(c, j - 1));
            rescale(o, alpha);
            rescale(ls, alpha);
          };
          auto last = [&](uint32_t (&pc)[BK / 16][4]) {
            const int j = j0 + n_tiles - 1;
            mbar_wait(full_v(c, j), parity(j, S));
            desc_v(j);
            fence_regs(o);
            fence_regs(ls);
            fence_regs<BK / 16>(pc);
            wgmma_fence();
            issue_pv(pc);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(ls);
            release(empty_v(c, j));
          };
          int kt = 1;
          for (; kt + 1 < n_tiles; kt += 2) {
            batch(kt, pa, pb);
            batch(kt + 1, pb, pa);
          }
          if (kt < n_tiles) {
            batch(kt, pa, pb);
            last(pb);
          } else {
            last(pa);
          }
        } else {
          for (int kt = 0; kt < n_tiles; ++kt) {
            const int j = j0 + kt;
            mbar_wait(full_k(c, j), parity(j, S));
            desc_k(j);
            fence_regs(s);
            wgmma_fence();
            issue_s();
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(s);
            release_k(kt);
            softmax(kt, pa);
            rescale(o, alpha);
            rescale(ls, alpha);
            mbar_wait(full_v(c, j), parity(j, S));
            desc_v(j);
            fence_regs(o);
            fence_regs(ls);
            fence_regs<BK / 16>(pa);
            wgmma_fence();
            issue_pv(pa);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(ls);
            release(empty_v(c, j));
          }
        }
        if constexpr (C::sum_mma) {
          l[0] = ls[0];  // every column of the (64, 8) sums is the row sum
          l[1] = ls[2];
        } else {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;  // row % 8 == g
          if constexpr (C::proj) {
            // head h's block of this block's head-output tile, 128-byte
            // swizzled
            const uint32_t dst =
                o_s + (h - h_lo) * Q_BYTES + row * ROW_BYTES + 4 * t;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                               dst + 16 * (j ^ g)),
                           "r"(pack_bf16(o[4 * j + 2 * r] / l[r],
                                         o[4 * j + 2 * r + 1] / l[r]))
                           : "memory");
          } else if (q0 + row < n) {
            bf16* dst = out + (static_cast<size_t>(b) * n + q0 + row) * cd +
                        h * D + 2 * t;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                  __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                        o[4 * j + 2 * r + 1] / l[r]);
          }
        }
      }
    } else {
      // the projection alone: over a zeroed head-output tile
      for (int i = threadIdx.x - 128; i < (h_hi - h_lo) * Q_BYTES / 16;
           i += NC * 128)
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                         o_s + 16 * i),
                     "r"(0u)
                     : "memory");
    }

    if constexpr (C::proj) {
      // every head of the block's tile is written and every ring is free:
      // the projection may read the tile, the W rings may be filled
      fence_proxy_async();
      consumers_sync<NC * 128>();
      const uint32_t recv_s = base;
      if constexpr (SPLIT == 2) {
        if (threadIdx.x == 128) {
          // the partner pushes its half here once this block is ready for
          // it, and this block its half there
          mbar_expect_tx(o_recv, (p_hi - p_lo) * Q_BYTES);
          mbar_arrive(attn_done);
          mbar_arrive_cluster(peer_ready, rank ^ 1);
          mbar_wait(peer_ready, 0);
          if (h_hi > h_lo)
            bulk_copy_to_peer(cluster_addr(recv_s, rank ^ 1), o_s,
                              (h_hi - h_lo) * Q_BYTES,
                              cluster_addr(o_recv, rank ^ 1));
        }
        mbar_wait(o_recv, 0);
      }
      // the A operand of k-tile (head) kk: in this block's tile or in the
      // partner's half received
      auto o_head = [&](int kk) {
        return kk >= h_lo && kk < h_hi ? o_s + (kk - h_lo) * Q_BYTES
                                       : recv_s + (kk - p_lo) * Q_BYTES;
      };
      int u = 0;
      for (int ch = ch_lo + c; ch < ch_hi; ch += NC) {
        float acc[NB][SUB / 2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < SUB / 2; ++e) acc[nb][e] = 0.f;
        if constexpr (PH != Phases::kAttention) {
          for (int kk = 0; kk < n_k; ++kk, ++u) {
            mbar_wait(w_full(c, u), parity(u, WS));
            uint64_t da[D / 16], dw[NB][D / 16];
            {
              const uint64_t a = desc_sw128(o_head(kk));
              const uint32_t w_s = w_ring(c) + (u % WS) * C::w_bytes;
#pragma unroll
              for (int k4 = 0; k4 < D / 16; ++k4) {
                da[k4] = a + 2 * k4;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb)
                  dw[nb][k4] =
                      desc_sw128(w_s + nb * SUB * ROW_BYTES) + 2 * k4;
              }
              pin(da);
#pragma unroll
              for (int nb = 0; nb < NB; ++nb) pin(dw[nb]);
            }
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
            wgmma_fence();
#pragma unroll
            for (int k4 = 0; k4 < D / 16; ++k4)
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
                WgmmaSS<SUB>::template run<1>(acc[nb], da[k4], dw[nb][k4]);
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
            release(w_empty(c, u));
          }
        }
        // epilogue: rows g and g + 8 of this warp
        auto store8 = [&](int col, int r, const float (&v)[8]) {
          // columns col .. col + 7 of row g + 8r: 16-byte accesses
          const int row = q0 + warp * 16 + g + 8 * r;
          if (row >= n) return;
          const size_t at = (static_cast<size_t>(b) * n + row) * cd + col;
          const uint4 xr = *reinterpret_cast<const uint4*>(x + at);
          const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
          uint32_t yw[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 gm =
                *reinterpret_cast<const float2*>(gb + col + 2 * i);
            const float2 bs =
                *reinterpret_cast<const float2*>(gb + cd + col + 2 * i);
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xw[i]));
            yw[i] = pack_bf16(
                __fadd_rn(xv.x, __fmul_rn(gm.x, __fadd_rn(v[2 * i], bs.x))),
                __fadd_rn(xv.y,
                          __fmul_rn(gm.y, __fadd_rn(v[2 * i + 1], bs.y))));
          }
          *reinterpret_cast<uint4*>(out + at) =
              make_uint4(yw[0], yw[1], yw[2], yw[3]);
        };
        if constexpr (C::vec) {
          // per 32 columns: thread t holds pairs (columns 2t, 2t + 1) of the
          // four 8-column groups; a 4 x 4 transpose of the pairs within the
          // quad (two xor shuffles) gives it group t's 8 columns
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int q = 0; q < SUB / 32; ++q) {
              float a[4][4];  // [group][row g pair, row g + 8 pair]
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  a[k][e] = acc[nb][4 * (4 * q + k) + e];
#pragma unroll
              for (int m = 1; m <= 2; m <<= 1) {
                float sh[4][4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    sh[k][e] = __shfl_xor_sync(0xffffffffu, a[k ^ m][e], m);
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  if ((t ^ k) & m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) a[k][e] = sh[k][e];
              }
              // a[k] now holds columns 2k, 2k + 1 of group 4q + t
              const int col = ch * PN + nb * SUB + 8 * (4 * q + t);
              if (col >= cd) continue;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float v[8];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  v[2 * k] = a[k][2 * r];
                  v[2 * k + 1] = a[k][2 * r + 1];
                }
                store8(col, r, v);
              }
            }
        } else {
          // columns 8j + 2t (+1), as the accumulator holds them
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j) {
              const int col = ch * PN + nb * SUB + j * 8 + 2 * t;
              if (col >= cd) continue;
              const float g0 = gb[col], g1 = gb[col + 1];
              const float b0 = gb[cd + col], b1 = gb[cd + col + 1];
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = q0 + warp * 16 + g + 8 * r;
                if (row >= n) continue;
                const size_t at =
                    (static_cast<size_t>(b) * n + row) * cd + col;
                const float2 xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(x + at));
                const float y0 = __fadd_rn(
                    xv.x, __fmul_rn(g0, __fadd_rn(acc[nb][4 * j + 2 * r], b0)));
                const float y1 = __fadd_rn(
                    xv.y,
                    __fmul_rn(g1, __fadd_rn(acc[nb][4 * j + 2 * r + 1], b1)));
                *reinterpret_cast<__nv_bfloat162*>(out + at) =
                    __floats2bfloat162_rn(y0, y1);
              }
            }
        }
      }
    }
  }
  // SPLIT 2: neither block leaves while the other may still push into or
  // arrive on its shared memory
  if constexpr (SPLIT == 2) {
    __syncwarp();
    cluster_sync_all();
  }
}

// ---- host side ----

// q, k, v: 16-byte aligned, token t of batch b at x + (b * n + t) * rs (rs
// a multiple of 8); with the projection w (C, C) (out, in), gb (2, C) fp32,
// x and out contiguous (B, N, C), C = heads * 64 <= 1024; kHeads: out
// contiguous (B, N, heads * 64), w, gb and x unused.  scale > 0.
template <class C>
cudaError_t launch_heads(const void* q, const void* k, const void* v,
                         const void* w, const float* gb, const void* x,
                         void* out, int b, int n, int heads, size_t rs,
                         int valid_len, float scale, cudaStream_t stream) {
  static_assert(heads_smem_bytes<C>(16) <= 232448,
                "shared memory of a block at C = 1024");
  if (!(scale > 0.f) || (C::proj && heads > 16))
    return cudaErrorInvalidValue;
  const int cd = heads * D;
  CUtensorMap mq, mk, mv, mw;
  cudaError_t e = make_map(&mq, q, cd, n, b, rs, Q_ROWS);
  if (e == cudaSuccess) e = make_map(&mk, k, cd, n, b, rs, C::bk);
  if (e == cudaSuccess) e = make_map(&mv, v, cd, n, b, rs, C::bk);
  // W as one batch of C tokens of C columns, boxes of 64 inputs by PN rows
  mw = mq;
  if (e == cudaSuccess && C::proj) e = make_map(&mw, w, cd, cd, 1, cd, C::pn);
  if (e != cudaSuccess) return e;
  const int smem = heads_smem_bytes<C>(heads);
  auto kern = attention_heads_sm90_kernel<C>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + Q_ROWS - 1) / Q_ROWS * C::split,
                  C::proj ? 1 : (heads + C::nc - 1) / C::nc, b);
  auto* typed_out = static_cast<bf16*>(out);
  const auto* typed_x = static_cast<const bf16*>(x);
  if constexpr (C::split == 1) {
    kern<<<grid, C::threads, smem, stream>>>(mq, mk, mv, mw, typed_out,
                                             typed_x, gb, n, heads, valid_len,
                                             scale);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C::split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(C::threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kern, mq, mk, mv, mw, typed_out, typed_x, gb,
                           n, heads, valid_len, scale);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace sm90

// K7's configuration of the kernel (attention_proj.cu), the fastest of the
// steps that probes/bench_attn_proj_sm90.py times
// (attention_proj_sm90_variants.cu): a cluster pair on each 64-row tile,
// each block's three consumers on three of its half of the heads at a
// time, K/V tiles of 128 keys in rings of 1 stage, the row sums by the
// tensor core, projection chunks of 64 columns (8 a block at C = 1024, so
// that three consumers share them evenly) through W rings of 2 stages, and
// the epilogue's accesses of 16 bytes.
using K7SM90 = sm90::HeadsConfig<3, 128, 1, true, 64, 2, sm90::Phases::kBoth,
                                 2, 1, false, true>;

}  // namespace vda
