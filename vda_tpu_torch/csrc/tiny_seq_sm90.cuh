// K5 on Hopper (sm_90a): softmax attention inside each short sequence, per
// head, in bf16 at head widths 8-128 and 192 (tiny_seq_attention.cu's
// vda_tiny_seq_loop says which shapes; fp32 and the rest keep that file's
// kernel).
//
// Replaces vda_tpu/ops/pallas_attention.py tiny_seq_attention
// (_tiny_seq_kernel).  q, k and v are (BD, T, C), element (b, t, col) at
// b * seq_stride + t * row_stride + col (column slices of one fused
// (BD, T, 3C) projection, or separate tensors); the output is a contiguous
// (BD, T, C).
//
// What bounds it on the H100: bytes.  At the vits window's (5476, 32, 64)
// it moves 90 MB (0.027 ms at 3.35 TB/s) for 1.4 GFLOP, ~16 operations a
// byte.  The kernel it replaces (tiny_seq_attention.cu's own) ran at a
// quarter of that bound: a block a sequence and a head group, q and k
// staged in shared memory as fp32 (twice the bytes, a conversion each), its
// loads, products and stores one after another, the products on the fp32
// pipe.  Here:
//
//   * T >= 2 (mma path).  A persistent grid of 8-warp blocks walks work
//     items, an item one sequence and one head group: the fewest heads whose
//     columns fill whole 64-column boxes (8 heads at dh 8 and 24, 2 at 32,
//     1 at 64, 128 and 192).  One thread copies an item's q, k and v by TMA
//     (3-D maps over (columns, T, BD) with the caller's strides, boxes of
//     64 columns by T rows in the 128-byte swizzle: a fused projection's
//     rows and separate tensors alike, 3 requests an item at the vits
//     shapes; the slab in one 5-D box was 3-5% slower) into a ring of two
//     stages on an mbarrier each: the next item's bytes are in flight
//     while this one computes.  bf16 stays bf16
//     in shared memory.  Blocks of 8 warps; a warp takes a (head, 16 query
//     rows) unit, at dh 192 a (head, 64 output columns, 16 query rows) one
//     (a whole head's unit left 6 of 8 warps idle at T 32 and held 96 sums
//     a lane): S = q k^T by mma.sync m16n8k16 (m16n8k8 for the last 8
//     columns of dh 8, 24, ...), operands by ldmatrix from the swizzled
//     tiles (no bank conflicts), fp32 sums; the softmax in registers, lean:
//     the arithmetic, not the bytes, bounds this loop at T = 32, so its exp
//     is ex2.approx and the row sums come from the tensor core; O
//     = P V by mma.sync with P, rounded to bf16, as the A fragments; O / z
//     to a swizzled output tile in shared memory, which all threads copy
//     out in 16-byte rows (two output tiles, so one barrier an item).  Rows T..TP-1 of
//     every tile are zero (TMA writes T rows), so the padded keys add 0.
//   * T == 1 (row path).  The softmax over one key: o = v * e / e with e =
//     bf16(exp(bf16(s - s))), s = q . k * scale; 1 for a finite score, NaN
//     for an infinite or NaN one, as in the twin and the TPU kernel, so q .
//     k is computed per head and v is not just copied.  A warp takes 256
//     columns of a position (a whole position where a head would cross 256
//     columns: dh 24, 40, ...), 16 bytes a lane of q, k and v, every load
//     issued before the first product, a head's sum over its lanes by
//     shuffles (through shared memory where a head's lanes are not a power
//     of two); a persistent grid of 8-warp blocks.
//
// Rounding follows the TPU kernel (pallas_attention.py _tiny_seq_kernel):
// fp32 products and sums, the scale applied to the sum, the row max, exp of
// the bf16-rounded shifted score rounded to bf16 (that P is JAX's
// e.astype(bf16)), P V with fp32 sums, the row sum of the rounded P in
// fp32, one division at the output.
//
// The design's measurements (tiny_seq_sm90_variants.cu,
// probes/bench_short_attn_sm90.py) run Mode's parts of the same kernels.
#pragma once

#include "sm90.cuh"  // mbarriers, TMA, the tensor-map encoder

namespace vda {

// The kernel the Hopper code replaced (tiny_seq_attention.cu), at every
// shape vda_tiny_seq_attention admits, bf16 or fp32: the fp32 path, the
// shapes takes() refuses, and step 0 of the design's measurements.
cudaError_t tiny_seq_sm80(const void* q, const void* k, const void* v,
                          void* o, int bd, int t, int c, int heads,
                          long long seq_stride, long long row_stride,
                          float scale, bool is_bf16, cudaStream_t st);

namespace tiny90 {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // a block of the mma path
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kBox = 64;  // columns of a TMA box: one 128-byte swizzle row
constexpr int kRowWarps = 8;  // a block of the row path
constexpr int kRowCols = 256;  // columns a warp takes at once: 16 B a lane
constexpr int kMaxRowC = 8 * kRowCols;
constexpr int kMaxSmem = 227 * 1024;

// What a kernel computes: the function (kFull), or for the design's
// measurements its loads alone (kLoads: items waited for, nothing computed
// or written), its products alone (kProducts: the mma path's units on
// whatever the stages hold, no loads, nothing written) or nothing at all
// (kEmpty: the launch on the same grid).  kLoads, kProducts and kEmpty
// write no output.
enum class Mode { kFull, kLoads, kProducts, kEmpty };

__host__ __device__ constexpr int gcd(int a, int b) {
  return b == 0 ? a : gcd(b, a % b);
}

// Heads an item takes: the fewest whose columns fill whole 64-column boxes.
__host__ __device__ constexpr int group_heads(int dh) {
  return kBox / gcd(dh, kBox);
}

// Rows a tile holds: T rounded up to 16, 32 or 64.
__host__ __device__ constexpr int padded_rows(int t) {
  return 16 << ((t > 16) + (t > 32));
}

// Shared memory of the mma path at T for an item gw columns wide (Layout).
__host__ __device__ constexpr int smem_bytes(int t, int gw) {
  return (3 * kStages + 2) * (gw / kBox) * padded_rows(t) * 128 +
         8 * kStages + 1024;
}

// Shared memory of the mma path: kStages stages of q, k and v (nb boxes
// each, a box tp rows of 128 B) and two output tiles of nb boxes, then the
// stages' mbarriers; the base is aligned up to 1024 bytes (the swizzle's
// period) inside the allocation.
struct Layout {
  int tp, nb, box, stage, out, bars, bytes;
};
__host__ __device__ inline Layout layout(int t, int gw) {
  Layout l;
  l.tp = padded_rows(t);
  l.nb = gw / kBox;
  l.box = l.tp * 128;
  l.stage = 3 * l.nb * l.box;
  l.out = l.nb * l.box;
  l.bars = kStages * l.stage + 2 * l.out;
  l.bytes = smem_bytes(t, gw);
  return l;
}

// The mma path's head widths (the kernels instantiated below).
__host__ __device__ constexpr bool mma_width(int dh) {
  return dh == 8 || dh == 16 || dh == 24 || dh == 32 || dh == 48 ||
         dh == 64 || dh == 96 || dh == 128 || dh == 192;
}

// Output columns of a warp's unit: the whole head up to 128 columns; at
// 192 a 64-column slab (one box), so an item of one head at T 32 is 2 row
// tiles x 3 slabs, 6 of a block's 8 warps, each recomputing the head's
// 16 x T scores (a warp a whole head, 2 warps an item, was 1.32x slower at
// vitg's mm0, slabs of 96 1.16x: PERF.md).
__host__ __device__ constexpr int out_width(int dh) {
  return dh == 192 ? kBox : dh;
}

// The shapes the Hopper code takes, in bf16: T >= 2 on the mma path (T <=
// 64, the head widths above, whole head groups, the stages in shared
// memory), T == 1 on the row path (C <= 2048).
inline bool takes(int t, int c, int heads) {
  if (heads <= 0 || c <= 0 || c % heads) return false;
  if (t == 1) return (c / heads) % 8 == 0 && c <= kMaxRowC;
  return t >= 2 && t <= 64 && mma_width(c / heads) &&
         heads % group_heads(c / heads) == 0 &&
         smem_bytes(t, group_heads(c / heads) * (c / heads)) <= kMaxSmem;
}

// ---- device helpers ----

using sm90::mbar_wait;
using sm90::smem_u32;

// Byte offset of 16-byte chunk `ch` (8 columns, counted over the item's
// boxes) of row r in a set of boxes `box` bytes each, in the 128-byte
// swizzle TMA writes: chunk c of row r at chunk c ^ (r % 8).
__device__ __forceinline__ uint32_t chunk_off(int r, int ch, int box) {
  return (ch >> 3) * box + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, fp32) += a (16 x 8, bf16, row) b (8 x 8, bf16, col)
__device__ __forceinline__ void mma8(float (&c)[4], const uint32_t (&a)[2],
                                     uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// far under the bf16 rounding that follows it)
__device__ __forceinline__ float sm90_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One unit of an item: head hl of the group (its first chunk c0), query
// rows 16 mt .. 16 mt + 15, against the t keys of the tiles at qs, ks and
// vs (nb boxes of `box` bytes each); O / z of the head's OW output columns
// from chunk c0 + o0 on into the output tile at os.  The scores and P take
// the whole head whatever OW is, in one order, so every slab of a head
// divides by the same z.
template <int DH, int TP, int OW>
__device__ __forceinline__ void unit(uint32_t qs, uint32_t ks, uint32_t vs,
                                     uint32_t os, int box, int c0, int o0,
                                     int mt, int t, float scale, int lane) {
  constexpr int NCH = DH / 8;  // 16-byte chunks of a head row
  constexpr int NO = OW / 8;   // 16-byte chunks of the unit's output
  constexpr int NT = TP / 8;   // n-tiles of 8 keys
  constexpr int KS = TP / 16;  // k-steps of 16 keys
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * mt;

  // S = q k^T: k-steps of 16 columns (two chunks), the odd chunk by k8
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ch = 0; ch + 1 < NCH; ch += 2) {
    uint32_t a[4];
    ldsm_x4(a, qs + chunk_off(r0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                              c0 + ch + (lane >> 4), box));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (8 * j >= t) continue;  // keys all past T
      uint32_t b[4];
      ldsm_x4(b, ks + chunk_off(8 * j + (lane >> 4) * 8 + (lane & 7),
                                c0 + ch + ((lane >> 3) & 1), box));
      mma16(s[j], a, b[0], b[1]);
      mma16(s[j + 1], a, b[2], b[3]);
    }
  }
  if constexpr (NCH % 2 == 1) {
    uint32_t a[2];
    ldsm_x2(a, qs + chunk_off(r0 + (lane & 15), c0 + NCH - 1, box));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (8 * j >= t) continue;
      uint32_t b[2];
      ldsm_x2(b, ks + chunk_off(8 * j + (lane & 15), c0 + NCH - 1, box));
      mma8(s[j], a, b[0]);
      mma8(s[j + 1], a, b[1]);
    }
  }

  // the softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8 j + 2 tq
  // + (e & 1): scaled sums, the row max, e = bf16(exp(bf16(s - m))), z its
  // fp32 sum; P in the A fragments of the value product
  const bool all_keys = t == TP;  // no key past T: nothing to mask
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * tq + (e & 1);
      s[j][e] = all_keys || key < t ? s[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // pairs of scores converted by one cvt.bf16x2; exp by ex2.approx of the
  // shifted score times log2 e (the arithmetic, not the bytes, bounds this
  // loop: the accurate expf cost 5-7%, a score at a time with fp32 adds for
  // the row sums 40-50% at T = 32, PERF.md); the row sums of the rounded P
  // by the tensor core: P (16 x TP) times ones (TP x 8), every column the
  // sum, in fp32
  constexpr float kLog2e = 1.4426950408889634f;
  uint32_t pf[KS][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // row g + 8 r: one pair of keys
      const float2 d = __bfloat1622float2(__floats2bfloat162_rn(
          s[j][2 * r] - mx[r], s[j][2 * r + 1] - mx[r]));
      pf[j / 2][(j % 2) * 2 + r] =
          pack2(sm90_ex2(d.x * kLog2e), sm90_ex2(d.y * kLog2e));
    }
  float zs[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 ones
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (16 * kk < t) mma16(zs, pf[kk], kOnes, kOnes);
  const float z[2] = {zs[0], zs[2]};

  // O (16 x OW) = P V, V's rows read transposed by ldmatrix
  const int v0 = c0 + o0;  // the first output chunk
  float o[NO][4];
#pragma unroll
  for (int jd = 0; jd < NO; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (16 * kk >= t) continue;  // P is 0 there
    const int key = 16 * kk + (lane & 15);
#pragma unroll
    for (int jd = 0; jd + 1 < NO; jd += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + chunk_off(key, v0 + jd + (lane >> 4), box));
      mma16(o[jd], pf[kk], b[0], b[1]);
      mma16(o[jd + 1], pf[kk], b[2], b[3]);
    }
    if constexpr (NO % 2 == 1) {
      uint32_t b[2];
      ldsm_x2_t(b, vs + chunk_off(key, v0 + NO - 1, box));
      mma16(o[NO - 1], pf[kk], b[0], b[1]);
    }
  }

  // bf16(O / z) into the output tile, 4 bytes a lane at columns 2 tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float rz = 1.f / z[r];
    // o / z, rounded as the twin's division: the product with the
    // reciprocal and one correction by its residual (z is at least 1, o
    // bounded; the product alone rounds differently once in a few hundred
    // thousand outputs, by one bf16 ulp)
    auto div = [&](float x) {
      const float q1 = x * rz;
      return fmaf(fmaf(-q1, z[r], x), rz, q1);
    };
#pragma unroll
    for (int jd = 0; jd < NO; ++jd)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       os + chunk_off(row, v0 + jd, box) + 4 * tq),
                   "r"(pack2(div(o[jd][2 * r]), div(o[jd][2 * r + 1])))
                   : "memory");
  }
}

// The mma path (T >= 2): a persistent grid over items (sequence, head
// group); tmq/tmk/tmv: 3-D maps (columns, T, BD) with boxes of 64 columns
// by T rows.
template <int DH, int TP, Mode M>
__global__ void __launch_bounds__(kThreads)
    tiny90_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  bf16* __restrict__ out, int bd, int t, int c, int heads,
                  float scale, int keep) {
  constexpr int G = group_heads(DH), GW = G * DH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Layout l = layout(t, GW);
  const int ngroups = heads / G;
  const int n_items = bd * ngroups;
  const uint32_t bars = base + l.bars;
  auto full = [&](int s) { return bars + 8 * s; };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows t .. tp - 1 of every tile of the stages: zero, and never written
  // by TMA (a box is t rows); kProducts: every row, which no load fills
  {
    const int r0 = M == Mode::kProducts ? 0 : t;
    const int pad = l.tp - r0, per_box = pad * 8;
    const int n = kStages * 3 * l.nb * per_box;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int bx = i / per_box, rest = i % per_box;
      const uint32_t a = base + bx * l.box + (r0 + rest / 8) * 128 +
                         (rest % 8) * 16;
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(a),
                   "r"(0)
                   : "memory");
    }
  }
  __syncthreads();

  // one thread issues an item's boxes: q, k and v of the group's columns
  // (a fused projection's slab in one 5-D box was 3-5% slower, PERF.md)
  const uint32_t tx = 3u * l.nb * t * 128;
  auto issue = [&](int it, int s) {
    const int b = it / ngroups, col = (it % ngroups) * GW;
    const uint32_t dst = base + s * l.stage;
    sm90::mbar_expect_tx(full(s), tx);
    for (int i = 0; i < l.nb; ++i) {
      sm90::tma_load(dst + i * l.box, &tmq, col + kBox * i, 0, b, full(s));
      sm90::tma_load(dst + (l.nb + i) * l.box, &tmk, col + kBox * i, 0, b,
                     full(s));
      sm90::tma_load(dst + (2 * l.nb + i) * l.box, &tmv, col + kBox * i, 0,
                     b, full(s));
    }
  };
  constexpr bool kLoad = M == Mode::kFull || M == Mode::kLoads;
  constexpr bool kCompute = M == Mode::kFull || M == Mode::kProducts;
  if (kLoad && threadIdx.x == 0) {
    sm90::tma_prefetch(&tmq);
    sm90::tma_prefetch(&tmk);
    sm90::tma_prefetch(&tmv);
    for (int s = 0; s < kStages; ++s) {
      const int it = blockIdx.x + s * gridDim.x;
      if (it < n_items) issue(it, s);
    }
  }

  const int cpr = GW / 8;  // 16-byte chunks of an output row
  int k = 0;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x, ++k) {
    const int s = k % kStages;
    if (kLoad) mbar_wait(full(s), static_cast<uint32_t>((k / kStages) & 1));
    const uint32_t qs = base + s * l.stage;
    const uint32_t ks = qs + l.nb * l.box, vs = ks + l.nb * l.box;
    const uint32_t os = base + kStages * l.stage + (k & 1) * l.out;
    if (kCompute) {  // units (head, slab, row tile)
      constexpr int OW = out_width(DH), MT = TP / 16, NS = DH / OW;
      for (int u = warp; u < G * NS * MT; u += kWarps)
        unit<DH, TP, OW>(qs, ks, vs, os, l.box, (u / (NS * MT)) * (DH / 8),
                         (u % (NS * MT) / MT) * (OW / 8), u % MT, t, scale,
                         lane);
    }
    __syncthreads();  // stage s read, the output tile written
    if (M == Mode::kFull || keep) {
      const int b = it / ngroups, col = (it % ngroups) * GW;
      bf16* dst = out + static_cast<size_t>(b) * t * c + col;
      for (int i = threadIdx.x; i < t * cpr; i += kThreads) {
        const int r = i / cpr, ch = i % cpr;
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(os + chunk_off(r, ch, l.box)));
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * c +
                                  8 * ch) = v;
      }
    }
    if (kLoad && threadIdx.x == 0) {
      const int next = it + kStages * gridDim.x;
      if (next < n_items) issue(next, s);
    }
  }
}

// The row path (T == 1): a warp a piece of a position, NV chunks of 256
// columns (`split` warps a position: each takes one chunk where a head's
// columns never cross a chunk, dh dividing 256, else one warp the whole
// row).  A head's sum over its lanes: by shuffles where its lanes are a
// power of two within the warp's 256 columns, else through shared memory.
template <int NV, Mode M>
__global__ void __launch_bounds__(32 * kRowWarps)
    tiny1_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int bd,
                 int c, int dh, int split, long long seq_stride, float scale,
                 int keep) {
  __shared__ float part[kRowWarps][NV * 32];  // each lane's partial sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lph = dh / 8;  // lanes a head
  const bool shfl = lph <= 32 && 32 % lph == 0;
  const long long warps = static_cast<long long>(gridDim.x) * kRowWarps;
  const long long units = static_cast<long long>(bd) * split;
  for (long long w = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
       w < units; w += warps) {
    const long long b = w / split, in = b * seq_stride;
    const int col0 = static_cast<int>(w % split) * kRowCols * NV;
    uint4 qv[NV], kv[NV], vv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = col0 + kRowCols * i + 8 * lane;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      qv[i] = col < c ? __ldg(reinterpret_cast<const uint4*>(q + in + col))
                      : zero;
      kv[i] = col < c ? __ldg(reinterpret_cast<const uint4*>(k + in + col))
                      : zero;
      vv[i] = col < c ? __ldg(reinterpret_cast<const uint4*>(v + in + col))
                      : zero;
    }
    if constexpr (M == Mode::kLoads) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        x ^= qv[i].x ^ kv[i].y ^ vv[i].z ^ qv[i].w;
      if (keep) out[b * c + lane] = __ushort_as_bfloat16(x & 0xffff);
      continue;
    }
    float d[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const __nv_bfloat162* qe = reinterpret_cast<const __nv_bfloat162*>(&qv[i]);
      const __nv_bfloat162* ke = reinterpret_cast<const __nv_bfloat162*>(&kv[i]);
      d[i] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(qe[e]);
        const float2 bb = __bfloat1622float2(ke[e]);
        d[i] = fmaf(a.x, bb.x, d[i]);
        d[i] = fmaf(a.y, bb.y, d[i]);
      }
    }
    if (shfl) {  // a head's lanes: aligned groups of lph within the warp
#pragma unroll
      for (int i = 0; i < NV; ++i)
        for (int o = 1; o < lph; o <<= 1)
          d[i] += __shfl_xor_sync(0xffffffffu, d[i], o);
    } else {  // the head's partial sums, in one order, from shared memory
      __syncwarp();  // the previous position's reads are done
#pragma unroll
      for (int i = 0; i < NV; ++i) part[warp][32 * i + lane] = d[i];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < NV; ++i) {  // col0 is 0: one warp a row
        const int first = (kRowCols * i + 8 * lane) / dh * lph;
        float sum = 0.f;
        for (int j = 0; j < lph && first + j < NV * 32; ++j)
          sum += part[warp][first + j];
        d[i] = sum;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int col = col0 + kRowCols * i + 8 * lane;
      if (col >= c) continue;
      const float sc = d[i] * scale;  // the one score; the row max is itself
      // e = bf16(exp(bf16(s - m))), z = e: o = v e / z, which is v for a
      // finite score and NaN for an infinite or NaN one
      const float e = round_bf16(sm90_ex2(round_bf16(sc - sc) *
                                          1.4426950408889634f));
      const float w_ = __fdividef(e, e);  // 1, or NaN
      const __nv_bfloat162* ve = reinterpret_cast<const __nv_bfloat162*>(&vv[i]);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = __bfloat1622float2(ve[x]);
        op[x] = pack2(f.x * w_, f.y * w_);
      }
      *reinterpret_cast<uint4*>(out + b * c + col) = o;
    }
  }
}

// ---- host side ----

// A map over one operand: `c` columns of `t` rows row_stride apart, `bd`
// sequences seq_stride apart; boxes of 64 columns by t rows in the 128-byte
// swizzle.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int c, int t,
                            int bd, long long row_stride,
                            long long seq_stride) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bd)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(seq_stride) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBox),
                             static_cast<cuuint32_t>(t), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const bf16 *q, *k, *v;
  bf16* out;
  int bd, t, c, heads;
  long long seq_stride, row_stride;
  float scale;
  int keep;
};

// An empty kernel: the launch alone, on the grid of the path it stands in
// for (a template, so that each source including this header may hold it).
template <int = 0>
__global__ void empty_kernel() {}

template <int DH, int TP, Mode M>
cudaError_t launch_mma(const Args& a, cudaStream_t st) {
  constexpr int GW = group_heads(DH) * DH;
  const Layout l = layout(a.t, GW);
  // kEmpty launches empty_kernel on the grid the function's kernel gets
  constexpr Mode MK = M == Mode::kEmpty ? Mode::kFull : M;
  auto kern = tiny90_kernel<DH, TP, MK>;
  int per_sm = 0;
  cudaError_t e = fit_blocks(kern, kThreads, l.bytes, 0, &per_sm);
  if (e != cudaSuccess) return e;
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInvalidValue;
  const long long items =
      static_cast<long long>(a.bd) * (a.heads / group_heads(DH));
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      items < static_cast<long long>(per_sm) * sms ? items : per_sm * sms);
  if (M == Mode::kEmpty) {
    empty_kernel<><<<grid, kThreads, 0, st>>>();
    return cudaGetLastError();
  }
  CUtensorMap mq, mk, mv;
  e = make_map(&mq, a.q, a.c, a.t, a.bd, a.row_stride, a.seq_stride);
  if (e == cudaSuccess)
    e = make_map(&mk, a.k, a.c, a.t, a.bd, a.row_stride, a.seq_stride);
  if (e == cudaSuccess)
    e = make_map(&mv, a.v, a.c, a.t, a.bd, a.row_stride, a.seq_stride);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, l.bytes, st>>>(mq, mk, mv, a.out, a.bd, a.t, a.c,
                                        a.heads, a.scale, a.keep);
  return cudaGetLastError();
}

template <int DH, Mode M>
cudaError_t launch_dh(const Args& a, cudaStream_t st) {
  if constexpr (M != Mode::kFull) {  // the parts: the windows' T
    if (padded_rows(a.t) != 32) return cudaErrorInvalidValue;
    return launch_mma<DH, 32, M>(a, st);
  } else {
    switch (padded_rows(a.t)) {
      case 16: return launch_mma<DH, 16, M>(a, st);
      case 32: return launch_mma<DH, 32, M>(a, st);
      default: return launch_mma<DH, 64, M>(a, st);
    }
  }
}

template <int NV, Mode M>
cudaError_t launch_row_nv(const Args& a, cudaStream_t st) {
  // kEmpty launches empty_kernel on the grid the function's kernel gets
  constexpr Mode MK = M == Mode::kEmpty ? Mode::kFull : M;
  auto kern = tiny1_kernel<NV, MK>;
  int per_sm = 0;
  cudaError_t e = fit_blocks(kern, 32 * kRowWarps, 0, 0, &per_sm);
  if (e != cudaSuccess) return e;
  const int sms = device_sms();
  if (sms < 1) return cudaErrorInvalidValue;
  const int dh = a.c / a.heads;
  const int split = NV == 1 && kRowCols % dh == 0
                        ? (a.c + kRowCols - 1) / kRowCols : 1;
  const long long need =
      (static_cast<long long>(a.bd) * split + kRowWarps - 1) / kRowWarps;
  const int grid = static_cast<int>(
      need < static_cast<long long>(per_sm) * sms ? need : per_sm * sms);
  if (M == Mode::kEmpty) {
    empty_kernel<><<<grid, 32 * kRowWarps, 0, st>>>();
    return cudaGetLastError();
  }
  kern<<<grid, 32 * kRowWarps, 0, st>>>(a.q, a.k, a.v, a.out, a.bd, a.c, dh,
                                        split, a.seq_stride, a.scale,
                                        a.keep);
  return cudaGetLastError();
}

template <Mode M>
cudaError_t launch_row(const Args& a, cudaStream_t st) {
  // a warp a chunk of 256 columns where a head never crosses one (NV 1),
  // else a warp the whole row
  const int nv = kRowCols % (a.c / a.heads) == 0
                     ? 1 : (a.c + kRowCols - 1) / kRowCols;
  if constexpr (M != Mode::kFull) {  // the parts: the stream's C 256, 1024
    if (nv == 1 && (a.c == 256 || a.c == 1024))
      return launch_row_nv<1, M>(a, st);
    return cudaErrorInvalidValue;
  } else {
    switch (nv) {
      case 1: return launch_row_nv<1, M>(a, st);
      case 2: return launch_row_nv<2, M>(a, st);
      case 3: return launch_row_nv<3, M>(a, st);
      case 4: return launch_row_nv<4, M>(a, st);
      case 5: return launch_row_nv<5, M>(a, st);
      case 6: return launch_row_nv<6, M>(a, st);
      case 7: return launch_row_nv<7, M>(a, st);
      case 8: return launch_row_nv<8, M>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

// The Hopper code at the operands of vda_tiny_seq_attention (bf16; the
// caller checked the strides and alignment); refuses what takes() does not
// take.  The parts run at the main paths' shapes only (T 32 at head widths
// 8, 24 and 192, T 1 at C 256 and 1024), kProducts on the mma path.
template <Mode M>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bd, int t, int c, int heads, long long seq_stride,
                   long long row_stride, float scale, int keep,
                   cudaStream_t st) {
  if (bd <= 0 || !takes(t, c, heads)) return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(o);
  a.bd = bd;
  a.t = t;
  a.c = c;
  a.heads = heads;
  a.seq_stride = seq_stride;
  a.row_stride = row_stride;
  a.scale = scale;
  a.keep = keep;
  if (t == 1) {
    if constexpr (M == Mode::kProducts)
      return cudaErrorInvalidValue;
    else
      return launch_row<M>(a, st);
  }
  if (c / heads == 8) return launch_dh<8, M>(a, st);
  if (c / heads == 24) return launch_dh<24, M>(a, st);
  if (c / heads == 192) return launch_dh<192, M>(a, st);
  if constexpr (M != Mode::kFull) {
    return cudaErrorInvalidValue;
  } else {
    switch (c / heads) {
      case 16: return launch_dh<16, M>(a, st);
      case 32: return launch_dh<32, M>(a, st);
      case 48: return launch_dh<48, M>(a, st);
      case 64: return launch_dh<64, M>(a, st);
      case 96: return launch_dh<96, M>(a, st);
      case 128: return launch_dh<128, M>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace tiny90
}  // namespace vda
