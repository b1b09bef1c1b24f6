// K3 on Hopper (sm_90a) as one fused kernel: the whole temporal-transformer
// block of vda_tpu/ops/pallas_temporal.py temporal_block_fused
// (_block_kernel) at vitl's width, C = 256, 8 heads of 32, T = 32, bf16:
// two LN -> +APE -> qkv -> per-sequence attention -> out-proj -> residual
// sub-blocks, then LN -> GEGLU feed-forward -> residual, with every
// intermediate in shared memory, as on the TPU.  The chain of
// temporal_sm90.cuh computes the same function from stage kernels whose
// intermediates (~3.5 GB at vitl's mm3) go through device memory; this is
// the design that keeps them on the SM.
//
// What bounds it: the products, 2.6 MFLOP a row (0.47 ms at mm3 at the
// bf16 peak), and the weights (2.6 MB in bf16), which every tile of rows
// streams from L2.  The design:
//
//   * a tile is 64 rows, two sequences: its residual h, the LN output hn
//     and the head outputs o (each 64 x 256 bf16, 32 KB) stay in shared
//     memory in the 128-byte swizzle, so each is a wgmma A operand as it
//     stands.  A 128-row tile would need 192 KB for the three, leaving no
//     room for the weight ring; an fp32 feed-forward sum in shared memory
//     (64 KB at 64 rows) does not fit either, so the sums live in registers,
//     their columns split between the two consumers;
//   * a block of three warpgroups: a producer (one thread issues every TMA
//     load of the weights) and two consumers.  The weights stream through
//     96 KB of slots in one order for every tile (the producer's loop); a
//     slot holds 128-byte-deep boxes of 32 weight rows, and its full
//     mbarrier completes on their bytes.  TF90 cuts them into one ring of 3
//     slots of 32 KB that both consumers read, in step; TF90_SPLIT gives
//     each consumer a ring of 3 slots of 16 KB of its own rows, filled in
//     turn (Config: split), so that neither waits on the other between two
//     barriers: measured slower, since the producer fills the rings in one
//     order and a slot that waits on the other block's release holds up
//     both;
//   * (CLUSTER 2) two blocks on row-adjacent tiles share every slot: each
//     producer loads half of its boxes and multicasts them into both blocks,
//     so L2 serves each weight byte once for 128 rows instead of 64.  A slot
//     is free once the consumer warps of both blocks have released it;
//   * the attention sub-block: consumer c runs heads c * 4 .. c * 4 + 3,
//     each a wgmma m64n96 (q | k | v of the head) from hn, then k and v
//     through a small padded tile in shared memory and the per-sequence
//     attention by mma.sync m16n8k16 (a warp's 16 query rows against the 32
//     keys of its sequence; q's A fragments come straight from the wgmma
//     sums), written into o at the head's columns.  The out-projection is a
//     wgmma m64n128 a consumer (its half of the output columns) from o, its
//     epilogue adding bias and residual into h in place;
//   * the GEGLU feed-forward in 16 chunks of 64 hidden columns: consumer c
//     forms x1 and the gate of 32 of them in one m64n64 product (the slot
//     lays out their weight rows side by side, so a thread holds both sums
//     of a column), writes g = x1 * gelu(gate) into a 64 x 64 tile (double
//     buffered in o's space), and both consumers add g's contribution to
//     their m64n128 half of the feed-forward sum, which stays in registers
//     across the chunks (64 a thread beside the chunk's 32);
//   * h comes in and goes out by TMA (boxes of 64 rows x 128 bytes, clipped
//     at the last row); a persistent grid walks the tiles, the producer
//     running ahead into the next tile's weights while the consumers finish
//     a tile, and each tile prefetches the next one's rows into L2.
//
// Rounding is the chain's, the TPU kernel's (temporal_sm90.cuh header).
// Each consumer keeps one wgmma batch in flight across every product: a
// batch is issued, the one before it waited for and its slot released.
#pragma once

#include "temporal_sm90.cuh"

namespace vda {
namespace temporal_fused {

using namespace sm90;
using bf16 = __nv_bfloat16;
using flash::ldmatrix_x4;
using flash::load_b;
using flash::mma_bf16;
using flash::pack;

constexpr int C = 256, HEADS = 8, DH = 32, T = 32;
constexpr int ROWS = 64;                 // a tile: two sequences
constexpr int HIDDEN = 4 * C;            // the GEGLU's hidden columns
constexpr int HC = 64;                   // hidden columns a chunk
constexpr int CHUNKS = HIDDEN / HC;
constexpr int PANEL = ROWS * 128;        // 64 rows x 128 bytes: 8 KB
constexpr int TILE = C / 64 * PANEL;     // a (64, 256) bf16 tile: 32 KB
constexpr int BOX_ROWS = 32, BOX = BOX_ROWS * 128;  // a weight box: 4 KB
constexpr int KV_LD = DH + 8;  // padded k / v rows: ldmatrix conflict-free
constexpr int KV_BYTES = ROWS * KV_LD * 2;

// What the consumers leave out, for the design's measurements (0: the
// block): a mask of the norms, the attentions (with their k and v
// stores), the GEGLU epilogues and the residual epilogues; with any of
// them the output is not written.  kProducts leaves out all four (the
// weight stream and every wgmma with its waits and barriers remain);
// kLoads computes nothing (each slot waited for and released; h still
// comes in).
namespace skip {
constexpr int kNorm = 1, kAttention = 2, kGeglu = 4, kResidual = 8;
constexpr int kProducts = 15, kLoads = 16;
}  // namespace skip

// How the weight stream is cut into slots (the producer's loop):
//   shared (SPLIT false): one ring of slots of 32 KB, each read by both
//     consumers (a k-panel of both heads' q | k | v rows, of all 256
//     out-projection or feed-forward rows, two k-panels of both consumers'
//     x1 and gate rows), 88 a tile, both consumers in step;
//   split (SPLIT true): a ring of slots of 16 KB for each consumer, each
//     slot its own (a k-panel of its head's 96 q | k | v rows or of its 128
//     output rows, two k-panels of its 64 x1 and gate rows), 88 a tile a
//     consumer, the producer filling the two rings in turn: a consumer
//     waits on no slot of the other's between two barriers.  (One ring
//     whose slots belong to one consumer each would let a consumer wait on
//     a slot's barrier two phases behind, where its parity reads as done.)
template <int STAGES_, int CLUSTER_, bool SPLIT_, int SKIP_ = 0,
          bool LAG_ = false>
struct Config {
  static_assert(CLUSTER_ == 1 || CLUSTER_ == 2, "blocks sharing the weights");
  static constexpr int stages = STAGES_, cluster = CLUSTER_;
  static constexpr bool split = SPLIT_;
  static constexpr int skip = SKIP_;
  // consumer 1's qkv products half a product behind consumer 0's (shared
  // ring alone: the lag is two of its three slots)
  static constexpr bool lag = LAG_;
  static_assert(!(LAG_ && SPLIT_), "a lag within one ring");
  static constexpr int slot_bytes = SPLIT_ ? 16384 : 32768;
  static constexpr int rings = SPLIT_ ? 2 : 1;       // a consumer's own
  static constexpr int depth = STAGES_ / rings;      // slots a ring
  static constexpr int per_tile = 88;                // a ring's slots a tile
  static constexpr int readers = SPLIT_ ? 1 : 2;     // consumers a slot
  static_assert(STAGES_ % rings == 0, "rings of equal depth");
  static constexpr int threads = 384;
  static constexpr int h_off = 0, hn_off = TILE, o_off = 2 * TILE;
  static constexpr int kv_off = 3 * TILE;  // k and v, a pair a consumer
  // the biases, fp32: the GEGLU's (2 HIDDEN), the out-projections' (2 C),
  // the feed-forward's (C)
  static constexpr int bias_off = kv_off + 4 * KV_BYTES;
  static constexpr int ring_off = bias_off + (2 * HIDDEN + 3 * C) * 4;
  static constexpr int bar_off = ring_off + STAGES_ * slot_bytes;
  // full and empty per slot, h's load; + 1024: the base aligned up to the
  // 1024-byte swizzle period
  static constexpr int smem_bytes = bar_off + 8 * (2 * STAGES_ + 1) + 1024;
  static constexpr int producer_regs = 40, consumer_regs = 232;
  static_assert(ring_off % 1024 == 0, "slots on the swizzle period");
  static_assert(smem_bytes <= 232448, "shared memory of a block");
};

// The operands past the tensor maps: fp32 vectors (C,) unless said.
struct Params {
  const float* ln_w[3];  // the two sub-blocks' norms and the feed-forward's
  const float* ln_b[3];
  const float* bout[2];
  const float* pe;     // (T, C)
  const float* bproj;  // (2 HIDDEN,): x1's biases, then the gate's
  const float* bffo;
  int m;  // rows, BD * T
};

// The weights' tensor maps (boxes of 64 columns x 32 rows) and h's (64 x
// 64): in and out.
struct Maps {
  CUtensorMap h, out, wqkv[2], wout[2], wproj, wffo;
};

// wgmma m64nNk16, bf16 from shared memory, fp32 sums: N / 2 a thread.
template <int N>
struct Wg;
template <>
struct Wg<128> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    gemm90::Wgmma<gemm90::BF16, 128>::run<SD>(d, a, b);
  }
};
template <>
struct Wg<64> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, %34, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "n"(SD));
  }
};
template <>
struct Wg<96> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[48], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, %50, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "n"(SD));
  }
};

// A box of a 2-D tensor map into L2 (the next tile's rows).
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// Both consumers (256 threads), or consumer c alone.
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}
__device__ __forceinline__ void sync_consumer(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}
// Consumer 1 starts a head's qkv product once consumer 0 has issued half of
// its own (barrier 4): the lag puts each one's attention under the other's
// products.
__device__ __forceinline__ void lag_signal() {
  asm volatile("bar.arrive 4, 256;\n" ::: "memory");
}
__device__ __forceinline__ void lag_wait() {
  asm volatile("bar.sync 4, 256;\n" ::: "memory");
}

// Byte offset of the 4-byte pair at (row, col), col even, in a tile of
// 64-column panels in the 128-byte swizzle (TMA's and wgmma's layout).
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * PANEL + row * 128 +
         ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// h (+)= the residual of one consumer's m64n128 sums at columns c0 + 8j +
// 2t: h = h + bf16(acc + b), the sum in bf16 (gemm::Residual's rounding);
// b in shared memory.
__device__ __forceinline__ void residual(unsigned char* h,
                                         const float (&acc)[64],
                                         const float* b, int c0, int warp,
                                         int g, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(b + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      auto* p = reinterpret_cast<__nv_bfloat162*>(h + swz(row, col));
      const float2 x = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(x.x + bf16r(acc[4 * j + 2 * r] + bb.x),
                                 x.y + bf16r(acc[4 * j + 2 * r + 1] + bb.y));
    }
  }
}

// hn = bf16(LN(h) * w + b) (+ bf16(pe[row % T]), the sum rounded to bf16)
// over the tile's 64 rows: warp wc (0..7 over both consumers) takes rows 8
// wc .. 8 wc + 7, a lane 8 columns of each (one 16-byte vector).  Rows go
// in groups of R: a group's APE values are loaded at once and each pass
// runs over its rows, so that their loads and reductions overlap (8 rows
// at once spill at the kernel's 168 registers).
template <int R = 4>
__device__ __forceinline__ void layer_norm(const unsigned char* h,
                                           unsigned char* hn, const float* w,
                                           const float* b, const float* pe,
                                           int wc, int lane) {
  const int col = lane * 8;
  float wv[8], bv[8];
  auto load8 = [](const float* p, float (&d)[8]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
    d[4] = y.x, d[5] = y.y, d[6] = y.z, d[7] = y.w;
  };
  load8(w + col, wv);
  load8(b + col, bv);
#pragma unroll 1
  for (int r0 = 8 * wc; r0 < 8 * wc + 8; r0 += R) {
    uint32_t pp[R][4];  // bf16(pe) of the group's frames, packed in pairs
    if (pe) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float pv[8];
        load8(pe + ((r0 + i) % T) * C + col, pv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 q =
              __floats2bfloat162_rn(pv[2 * e], pv[2 * e + 1]);
          pp[i][e] = reinterpret_cast<const uint32_t&>(q);
        }
      }
    }
    float v[R][8], mean[R], rstd[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(h + swz(r0 + i, col));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[i][2 * e] = f.x;
        v[i][2 * e + 1] = f.y;
        s += f.x + f.y;
      }
      mean[i] = s;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) mean[i] = warp_sum(mean[i]) / C;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean[i];
        q += d * d;
      }
      rstd[i] = q;
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      rstd[i] = rsqrtf(warp_sum(rstd[i]) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = bf16r((v[i][e] - mean[i]) * rstd[i] * wv[e] + bv[e]);
      if (pe) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 q = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162&>(pp[i][e]));
          o[2 * e] += q.x;
          o[2 * e + 1] += q.y;
        }
      }
      uint4 y;
      __nv_bfloat162* py = reinterpret_cast<__nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        py[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
      *reinterpret_cast<uint4*>(hn + swz(r0 + i, col)) = y;
    }
  }
}

// The attention of one head for a warp's 16 query rows (rows 16 warp + g,
// + 8) against the 32 keys of its sequence: q's A fragments from the head's
// qkv sums (columns 0..31), k and v (64, DH) row-major in kv (KV_LD apart);
// o = bf16(P V / z) into the head's columns of o.  The seq_attention_kernel
// softmax of temporal_sm90.cuh, at 32 keys.
__device__ __forceinline__ void head_attention(const float (&qkv)[48],
                                               const bf16* ks, const bf16* vs,
                                               unsigned char* o, int head,
                                               int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  const int kb = (warp / 2) * T;  // the sequence's first key
  const float scale = 0.17677669529663687f;  // 32^-0.5
  uint32_t qf[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 2 * kk + hf;
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(qkv[4 * j], qkv[4 * j + 1]);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(qkv[4 * j + 2], qkv[4 * j + 3]);
      qf[kk][2 * hf] = reinterpret_cast<const uint32_t&>(lo);
      qf[kk][2 * hf + 1] = reinterpret_cast<const uint32_t&>(hi);
    }
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t kf[4];
      load_b(kf, ks + (kb + jj * 16) * KV_LD, KV_LD, kk * 16, lane);
      mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
    }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float z[2] = {0.f, 0.f};
  uint32_t pf[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bf16 p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = __float2bfloat16_rn(expf(bf16r(s[j][e] - mx[e >> 1])));
      z[e >> 1] += __bfloat162float(p[e]);
    }
    pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
    pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
  }
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int jd = 0; jd < 2; ++jd) {
      uint32_t vf[4];
      ldmatrix_x4(vf,
                  vs + (kb + kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) *
                           KV_LD +
                      jd * 16 + (lane / 16) * 8,
                  true);
      mma_bf16(acc[2 * jd], pf[kk], vf[0], vf[1]);
      mma_bf16(acc[2 * jd + 1], pf[kk], vf[2], vf[3]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          o + swz(row, head * DH + 8 * j + 2 * t)) =
          __floats2bfloat162_rn(acc[j][2 * r] / z[r], acc[j][2 * r + 1] / z[r]);
  }
}

// One wgmma batch: KP k-panels of 4 k-steps, A panel p at a + p * PANEL, B
// panel p at b + p * BP; ZERO: the product's first batch (its first k-step
// overwrites the sums).
template <int N, int KP, int BP, bool ZERO>
__device__ __forceinline__ void batch(float (&acc)[N / 2], uint32_t a,
                                      uint32_t b) {
  uint64_t da[4 * KP], db[4 * KP];
#pragma unroll
  for (int p = 0; p < KP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      da[4 * p + kk] = desc_sw128(a + p * PANEL) + 2 * kk;
      db[4 * p + kk] = desc_sw128(b + p * BP) + 2 * kk;
    }
  pin(da);
  pin(db);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4 * KP; ++i) {
    if (ZERO && i == 0)
      Wg<N>::template run<0>(acc, da[i], db[i]);
    else
      Wg<N>::template run<1>(acc, da[i], db[i]);
  }
  wgmma_commit();
}

template <class Cfg>
__global__ void __launch_bounds__(Cfg::threads, 1)
    temporal_fused_kernel(const __grid_constant__ Maps maps, Params prm) {
  constexpr int S = Cfg::stages, CL = Cfg::cluster;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic view
  const uint32_t bars = base + Cfg::bar_off;
  // slot s of ring r, its barriers
  constexpr int D = Cfg::depth;
  auto full = [&](int r, int s) { return bars + 8 * (r * D + s); };
  auto empty = [&](int r, int s) { return bars + 8 * (S + r * D + s); };
  const uint32_t hbar = bars + 16 * S;
  auto slot = [&](int r, int s) {
    return base + Cfg::ring_off + (r * D + s) * Cfg::slot_bytes;
  };
  constexpr bool SPLIT = Cfg::split;
  constexpr int NC = SPLIT ? 1 : 2;  // consumers' rows in a slot
  const uint32_t rank = CL == 2 ? cluster_ctarank() : 0;
  const int tiles = (prm.m + ROWS - 1) / ROWS;
  const int units = (tiles + CL - 1) / CL;
  const int first = blockIdx.x / CL, stride = gridDim.x / CL;
  const int wg = threadIdx.x / 128;

  // the biases into shared memory (the epilogues read them often)
  float* const bias = reinterpret_cast<float*>(gbase + Cfg::bias_off);
  for (int i = threadIdx.x; i < 2 * HIDDEN + 3 * C; i += Cfg::threads) {
    const int k = i - 2 * HIDDEN;
    const float* src = k < 0       ? prm.bproj + i
                       : k < 2 * C ? prm.bout[k / C] + k % C
                                   : prm.bffo + (k - 2 * C);
    bias[i] = __ldg(src);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);  // full
      // empty: each warp of the slot's consumers, in every block of the
      // cluster
      mbar_init(bars + 8 * (S + s), 4 * Cfg::readers * CL);
    }
    mbar_init(hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL == 2)
    cluster_sync();  // no block loads into another before its barriers exist
  else
    __syncthreads();

  if (wg == 0) {  // producer: the weights, slot by slot
    setmaxnreg_dec<Cfg::producer_regs>();
    if (threadIdx.x != 0) return;
    int sr[2] = {0, 0};  // each ring's next slot and its phase
    uint32_t phr[2] = {0, 0};
    int r = 0, s = 0;  // the slot being filled
    int b = 0;  // the box's index in its slot
    auto open = [&](int ring, uint32_t bytes) {
      r = ring;
      s = sr[r];
      mbar_wait(empty(r, s), phr[r] ^ 1);
      mbar_expect_tx(full(r, s), bytes);
      b = 0;
    };
    // one box of 32 weight rows x 64 columns (k0) at byte dst of the slot;
    // in a cluster pair, every other box is this block's, sent to both
    auto box = [&](const CUtensorMap* map, int k0, int row, int dst) {
      if constexpr (CL == 2) {
        if ((b & 1) == static_cast<int>(rank))
          tma_load_2d_multicast(slot(r, s) + dst, map, k0, row, full(r, s),
                                0x3);
      } else {
        tma_load_2d(slot(r, s) + dst, map, k0, row, full(r, s));
      }
      ++b;
    };
    auto close = [&]() {
      if (++sr[r] == D) {
        sr[r] = 0;
        phr[r] ^= 1;
      }
    };
    // the slots in order; split: consumer c's rows into its ring, the
    // consumers alternating; shared: both consumers' rows (cc) in each
    for (int u = first; u < units; u += stride) {
      for (int a = 0; a < 2; ++a) {
        // q | k | v rows of head p + 4 cc, one k-panel a slot
        for (int p = 0; p < 4; ++p)
          for (int c = 0; c < 3 - NC; ++c)
            for (int kc = 0; kc < 4; ++kc) {
              open(SPLIT ? c : 0, 3 * NC * BOX);
              for (int cc = 0; cc < NC; ++cc)
                for (int part = 0; part < 3; ++part)
                  box(&maps.wqkv[a], kc * 64,
                      part * C + (p + 4 * (SPLIT ? c : cc)) * DH,
                      (cc * 3 + part) * BOX);
              close();
            }
        // W_out's rows, a k-panel a slot: the 128 of consumer c, or all
        for (int kc = 0; kc < 4; ++kc)
          for (int c = 0; c < 3 - NC; ++c) {
            open(SPLIT ? c : 0, 4 * NC * BOX);
            for (int i = 0; i < 4 * NC; ++i)
              box(&maps.wout[a], kc * 64, (SPLIT ? c * 128 : 0) + i * BOX_ROWS,
                  i * BOX);
            close();
          }
      }
      for (int j = 0; j < CHUNKS; ++j) {
        // two k-panels a slot: consumer cc's x1 rows of hidden columns j HC
        // + 32 cc .., then its gate rows
        for (int hf = 0; hf < 2; ++hf)
          for (int c = 0; c < 3 - NC; ++c) {
            open(SPLIT ? c : 0, 4 * NC * BOX);
            for (int kp = 0; kp < 2; ++kp)
              for (int cc = 0; cc < NC; ++cc)
                for (int gt = 0; gt < 2; ++gt)
                  box(&maps.wproj, (2 * hf + kp) * 64,
                      gt * HIDDEN + j * HC + (SPLIT ? c : cc) * 32,
                      kp * (Cfg::slot_bytes / 2) + (cc * 2 + gt) * BOX);
            close();
          }
        // W_ffo's rows at the chunk's k: consumer c's 128, or all 256
        for (int c = 0; c < 3 - NC; ++c) {
          open(SPLIT ? c : 0, 4 * NC * BOX);
          for (int i = 0; i < 4 * NC; ++i)
            box(&maps.wffo, j * HC, (SPLIT ? c * 128 : 0) + i * BOX_ROWS,
                i * BOX);
          close();
        }
      }
    }
    if constexpr (CL == 2)  // the other block's consumers still arrive
      for (r = 0; r < Cfg::rings; ++r)
        for (int i = 0; i < D; ++i) {
          mbar_wait(empty(r, sr[r]), phr[r] ^ 1);
          close();
        }
    return;
  }

  // consumers
  setmaxnreg_inc<Cfg::consumer_regs>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wc = c * 4 + warp;  // the warp's index over both consumers
  unsigned char* const h = gbase + Cfg::h_off;
  unsigned char* const hn = gbase + Cfg::hn_off;
  unsigned char* const o = gbase + Cfg::o_off;
  const uint32_t hn_s = base + Cfg::hn_off, o_s = base + Cfg::o_off;
  bf16* const ks =
      reinterpret_cast<bf16*>(gbase + Cfg::kv_off + c * 2 * KV_BYTES);
  bf16* const vs = ks + ROWS * KV_LD;
  const bool leader = c == 0 && tid == 0;  // h's loads and stores

  const int ring = SPLIT ? c : 0;  // the ring the consumer reads
  int s = 0;      // the slot last taken
  int taken = 0;  // slots taken from the ring so far
  int prev = -1;  // the slot of the batch in flight
  auto release = [&](int st) {
    if (lane == 0) {
      if constexpr (CL == 2) {
        mbar_arrive_cluster(empty(ring, st), 0);
        mbar_arrive_cluster(empty(ring, st), 1);
      } else {
        mbar_arrive(empty(ring, st));
      }
    }
  };
  // wait for the ring's next slot to be full: every slot of the ring is
  // taken in order, so its barrier is never two phases behind
  auto take = [&]() {
    s = taken % D;
    mbar_wait(full(ring, s), static_cast<uint32_t>(taken / D) & 1);
    ++taken;
  };
  // after a batch on slot s is issued: the one before it is done
  auto issued = [&]() {
    wgmma_wait<1>();
    if (prev >= 0) release(prev);
    prev = s;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    if (prev >= 0) release(prev);
    prev = -1;
  };
  constexpr bool FULL = Cfg::skip == 0;
  constexpr bool LAG = Cfg::lag;
  constexpr bool NORM = !(Cfg::skip & skip::kNorm);
  constexpr bool ATTN = !(Cfg::skip & skip::kAttention);
  constexpr bool GEGLU = !(Cfg::skip & skip::kGeglu);
  constexpr bool RESID = !(Cfg::skip & skip::kResidual);
  // parts left out: sums that nothing reads would let ptxas drop the
  // products that make them; one of each goes to a store no run takes (m >
  // 0)
  auto keep = [&](float v) {
    if (!FULL && prm.m < 0)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base),
                   "r"(__float_as_uint(v))
                   : "memory");
  };
  auto load_h = [&](int u) {
    const int row0 = (u * CL + static_cast<int>(rank)) * ROWS;
    if (row0 >= prm.m) {  // a cluster's tile past the end: nothing to load
      mbar_arrive(hbar);
      return;
    }
    mbar_expect_tx(hbar, TILE);
    for (int p = 0; p < C / 64; ++p)
      tma_load_2d(base + Cfg::h_off + p * PANEL, &maps.h, p * 64, row0, hbar);
  };
  if (leader && first < units) load_h(first);

  uint32_t hph = 0;
  for (int u = first; u < units; u += stride) {
    const int row0 = (u * CL + static_cast<int>(rank)) * ROWS;
    if (leader && u + stride < units) {  // the next tile's rows into L2
      const int next0 = ((u + stride) * CL + static_cast<int>(rank)) * ROWS;
      if (next0 < prm.m)
        for (int p = 0; p < C / 64; ++p)
          tma_prefetch_2d(&maps.h, p * 64, next0);
    }
    mbar_wait(hbar, hph);
    hph ^= 1;
    if constexpr (Cfg::skip & skip::kLoads) {
      for (int i = 0; i < Cfg::per_tile; ++i) {
        take();
        release(s);
      }
      if (leader && u + stride < units) load_h(u + stride);
      continue;
    }

    for (int a = 0; a < 2; ++a) {
      if constexpr (NORM)
        layer_norm(h, hn, prm.ln_w[a], prm.ln_b[a], prm.pe, wc, lane);
      fence_proxy_async();
      sync_consumers();
      for (int p = 0; p < 4; ++p) {
        const int head = p + 4 * c;
        float qkv[48];
        if (LAG && c == 1) lag_wait();
        for (int kc = 0; kc < 4; ++kc) {
          take();
          const uint32_t a_ = hn_s + kc * PANEL,
                         b_ = slot(ring, s) + (SPLIT ? 0 : c * 96 * 128);
          if (kc == 0)
            batch<96, 1, 0, true>(qkv, a_, b_);
          else
            batch<96, 1, 0, false>(qkv, a_, b_);
          issued();
          if (LAG && c == 0 && kc == 1) lag_signal();
        }
        drain();
        fence_regs(qkv);
        keep(qkv[0]);
        // k and v into the consumer's tile, once the last head's readers
        // are done with it
        sync_consumer(c);
        if constexpr (ATTN) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + g + 8 * r, col = 8 * j + 2 * t;
              *reinterpret_cast<__nv_bfloat162*>(ks + row * KV_LD + col) =
                  __floats2bfloat162_rn(qkv[4 * (j + 4) + 2 * r],
                                        qkv[4 * (j + 4) + 2 * r + 1]);
              *reinterpret_cast<__nv_bfloat162*>(vs + row * KV_LD + col) =
                  __floats2bfloat162_rn(qkv[4 * (j + 8) + 2 * r],
                                        qkv[4 * (j + 8) + 2 * r + 1]);
            }
        }
        sync_consumer(c);
        if constexpr (ATTN) head_attention(qkv, ks, vs, o, head, warp, lane);
      }
      fence_proxy_async();
      sync_consumers();  // o is whole
      float acc[64];
      for (int kc = 0; kc < 4; ++kc) {
        take();
        const uint32_t a_ = o_s + kc * PANEL,
                       b_ = slot(ring, s) + (SPLIT ? 0 : c * 128 * 128);
        if (kc == 0)
          batch<128, 1, 0, true>(acc, a_, b_);
        else
          batch<128, 1, 0, false>(acc, a_, b_);
        issued();
      }
      drain();
      fence_regs(acc);
      keep(acc[0]);
      if constexpr (RESID)
        residual(h, acc, bias + 2 * HIDDEN + a * C, c * 128, warp, g, t);
      sync_consumers();  // h is whole for the next norm
    }

    // the GEGLU feed-forward
    if constexpr (NORM)
      layer_norm(h, hn, prm.ln_w[2], prm.ln_b[2], nullptr, wc, lane);
    fence_proxy_async();
    sync_consumers();
    float ff[64];
    const gemm::Geglu<gemm::TemporalK3> geglu{bias, nullptr, HIDDEN};
    for (int j = 0; j < CHUNKS; ++j) {
      float x12[32];
      for (int hf = 0; hf < 2; ++hf) {
        take();
        const uint32_t a_ = hn_s + 2 * hf * PANEL,
                       b_ = slot(ring, s) + (SPLIT ? 0 : c * 64 * 128);
        constexpr int BP = Cfg::slot_bytes / 2;  // a k-panel's rows
        if (hf == 0)
          batch<64, 2, BP, true>(x12, a_, b_);
        else
          batch<64, 2, BP, false>(x12, a_, b_);
        issued();
      }
      drain();
      fence_regs(x12);
      keep(x12[0]);
      // g of the consumer's 32 hidden columns into the chunk's 64 x 64
      // tile (two of them alternate in o's space)
      unsigned char* gt = o + (j % 2) * PANEL;
      if constexpr (GEGLU) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int hc = c * 32 + 8 * jj + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            *reinterpret_cast<__nv_bfloat162*>(gt + swz(row, hc)) = geglu.pair(
                row, j * HC + hc, x12[4 * jj + 2 * r], x12[4 * jj + 2 * r + 1],
                x12[4 * (jj + 4) + 2 * r], x12[4 * (jj + 4) + 2 * r + 1]);
          }
        }
      }
      fence_proxy_async();
      sync_consumers();
      take();
      const uint32_t a_ = o_s + (j % 2) * PANEL,
                     b_ = slot(ring, s) + (SPLIT ? 0 : c * 128 * 128);
      if (j == 0)
        batch<128, 1, 0, true>(ff, a_, b_);
      else
        batch<128, 1, 0, false>(ff, a_, b_);
      issued();
    }
    drain();
    fence_regs(ff);
    keep(ff[0]);
    if constexpr (RESID)
      residual(h, ff, bias + 2 * HIDDEN + 2 * C, c * 128, warp, g, t);
    fence_proxy_async();
    sync_consumers();  // the tile's output is whole
    if (leader) {
      if (FULL && row0 < prm.m) {
        for (int p = 0; p < C / 64; ++p)
          tma_store_2d(&maps.out, base + Cfg::h_off + p * PANEL, p * 64, row0);
        bulk_commit();
      }
      if (u + stride < units) {  // the store has read h before it reloads
        bulk_wait_read<0>();
        load_h(u + stride);
      }
    }
  }
  if (leader) bulk_wait_all();
}

// ---- host side ----

// The shapes this kernel takes: bf16 (the caller's), C = 256, 8 heads, T =
// 32.
inline bool takes(int c, int heads, int t) {
  return c == C && heads == HEADS && t == T;
}

template <class Cfg>
cudaError_t launch(const temporal::Args& a, cudaStream_t st) {
  if (!takes(a.c, a.heads, a.seq) || a.bd <= 0 ||
      static_cast<long long>(a.bd) * a.seq > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int m = a.bd * a.seq;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  Maps maps;
  auto wmap = [&](CUtensorMap* map, const void* w, int rows, int cols) {
    return gemm90::make_map_2d(map, w, bf, cols, rows,
                               static_cast<size_t>(cols) * 2, 64, BOX_ROWS);
  };
  cudaError_t e = gemm90::make_map_2d(&maps.h, a.h, bf, C, m, C * 2, 64, ROWS);
  if (e == cudaSuccess)
    e = gemm90::make_map_2d(&maps.out, a.out, bf, C, m, C * 2, 64, ROWS);
  for (int i = 0; i < 2 && e == cudaSuccess; ++i) {
    e = wmap(&maps.wqkv[i], a.attn[i].wqkv, 3 * C, C);
    if (e == cudaSuccess) e = wmap(&maps.wout[i], a.attn[i].wout, C, C);
  }
  if (e == cudaSuccess) e = wmap(&maps.wproj, a.wproj, 2 * HIDDEN, C);
  if (e == cudaSuccess) e = wmap(&maps.wffo, a.wffo, C, HIDDEN);
  if (e != cudaSuccess) return e;
  Params prm{};
  for (int i = 0; i < 2; ++i) {
    prm.ln_w[i] = a.attn[i].ln_w;
    prm.ln_b[i] = a.attn[i].ln_b;
    prm.bout[i] = a.attn[i].bout;
  }
  prm.ln_w[2] = a.ffn_w;
  prm.ln_b[2] = a.ffn_b;
  prm.pe = a.pe;
  prm.bproj = a.bproj;
  prm.bffo = a.bffo;
  prm.m = m;

  auto kern = temporal_fused_kernel<Cfg>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg::smem_bytes);
  if (e != cudaSuccess) return e;
  constexpr int CL = Cfg::cluster;
  const int units = ((m + ROWS - 1) / ROWS + CL - 1) / CL;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(Cfg::threads);
  cfg.dynamicSmemBytes = Cfg::smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // as many clusters as can be resident at once; asked once a device
  static int resident_on[64] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidValue;
  int& resident = resident_on[dev];
  if (resident == 0) {
    cfg.gridDim = dim3(CL);
    e = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (resident == 0) return cudaErrorInvalidValue;
  }
  const int clusters = units > resident ? resident : units;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * CL));
  e = cudaLaunchKernelEx(&cfg, kern, maps, prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace temporal_fused

// The fused K3 configurations: one ring of 3 weight slots of 32 KB that
// both consumers read, cluster pairs sharing it (TF90) or blocks alone
// (TF90_CL1); TF90_SPLIT gives each consumer a ring of its own (slower:
// PERF.md, section 6); TF90_SKIP, TF90 without some of its parts.
using TF90 = temporal_fused::Config<3, 2, false>;
using TF90_CL1 = temporal_fused::Config<3, 1, false>;
using TF90_SPLIT = temporal_fused::Config<6, 2, true>;
using TF90_LAG = temporal_fused::Config<3, 2, false, 0, true>;
template <int SKIP>
using TF90_SKIP = temporal_fused::Config<3, 2, false, SKIP>;

}  // namespace vda
