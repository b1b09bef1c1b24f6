// The flash-attention loop of one head over one 64-row query tile (the
// mma.sync loop), run by K8 (segment_attention.cu) and, at the head widths
// and dtypes the Hopper loop (flash_attention_sm90.cuh) does not take, by
// K1/K9 (attention_qkv.cu), K7 (attention_proj.cu) and, in its variants,
// K12 (attention_variants.cu), whose mma_sync variant runs it at every
// width.
//
// q, k and v point at the head's first column of batch row 0 of their
// tensors; consecutive tokens are `rs` elements apart (3*H*D when they are
// column slices of one fused qkv projection, H*D when they are separate
// tensors).  The tile walks 64-row K/V tiles with an online softmax: running
// max and sum and the output accumulator are fp32, and the output is
// normalised once at the end and handed to `store`.
//
// bf16: each of the 4 warps owns 16 query rows and keeps everything of them
// in registers: its Q fragments, the (16, 64) scores of the current K tile,
// the probabilities and the (16, D) output accumulator.  Products are
// tensor-core mma.sync m16n8k16 (fp32 accumulate) with operands read by
// ldmatrix from K/V tiles that cp.async double-buffers in shared memory; the
// score fragment is reused as the A operand of the value product, so scores
// never leave registers.  The probabilities are rounded to bf16 before the
// value product and the row sum adds the rounded values, so the
// normalisation matches the weights actually applied (the TPU kernel's bf16
// exp did the same).
// fp32 (tests, small shapes): the same tiling with scalar FMAs through
// shared memory.
// Keys at or beyond valid_len are masked; N needs no padding.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace vda {
namespace flash {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NT = 128;  // threads: 4 warps

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// c (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 columns) of a row-major bf16 tile whose row 0 is
// this warp's first row: the layout of the A operand of mma_bf16.
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* rows,
                                       int ld, int col, int lane) {
  ldmatrix_x4(r, rows + (((lane / 8) % 2) * 8 + lane % 8) * ld + col +
                     (lane / 16) * 8,
              false);
}

// B fragments of two n-tiles (16 rows of n, 16 columns of k) of a row-major
// (n, k) bf16 tile: b0/b1 of n-tile 0 in r[0..1], of n-tile 1 in r[2..3].
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* rows,
                                       int ld, int col, int lane) {
  ldmatrix_x4(r, rows + ((lane / 16) * 8 + lane % 8) * ld + col +
                     ((lane / 8) % 2) * 8,
              false);
}

// The function and tiling of the bf16 loop.  K1, K7, K8 and K9 run
// Default; the others are K12's ablations of it (attention_variants.cu):
//   kMatmul      P = bf16(S * scale) over the valid keys, no max, no exp,
//                no normalisation (l = 1)
//   kNoMask      no key compare: the loop runs over valid_len keys, which
//                the caller sets to the padded key count, and keys at or
//                beyond n take part as zero rows (score 0, value 0)
//   kFp32Exp     accurate fp32 exp; the row sum adds the unrounded values
//   kBf16Softmax scores rounded to bf16, the max over bf16 values, the
//                shifted score rounded to bf16, times log2 e rounded to
//                bf16 again, exponentiated by ex2.approx.bf16x2
//   kExp2        the max over unscaled scores, exp2 of (s - m) * scale *
//                log2 e as one FMA and ex2.approx (the scale folded in)
// and the tiling: bq query rows a head (16 a warp, so bq / 16 warps), bk
// key rows a K/V tile, and `heads` head groups of bq / 16 warps in a block,
// each on its own head and its own shared memory.
enum class Fn { kFull, kMatmul, kNoMask, kFp32Exp, kBf16Softmax, kExp2 };

template <Fn F = Fn::kFull, int BQ_ = BQ, int BK_ = BK, int HEADS_ = 1>
struct Variant {
  static constexpr Fn fn = F;
  static constexpr int bq = BQ_;
  static constexpr int bk = BK_;
  static constexpr int heads = HEADS_;
  static constexpr int nt = BQ_ * 2;  // threads of a head group
};
using Default = Variant<>;

// Shared memory of the bf16 loop, per head group: Q (bq, DP) and two K and
// two V tiles, rows padded by 16 bytes so the 8 rows an ldmatrix reads hit
// 8 distinct groups of 4 banks.
template <int DP, class V = Default>
struct Bf16Tiles {
  static constexpr int LD = DP + 8;
  static constexpr size_t bytes = sizeof(bf16) * (V::bq + 4 * V::bk) * LD;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ex2_approx_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One head, bf16.  Calls store(r, col, v0, v1) with the normalised outputs
// of local query row r (0..bq-1) at head columns col and col + 1 (col even,
// col < d); rows at or beyond n are handed over too (their queries are
// zero) and the caller drops them.  `tiles` is this head group's shared
// memory.
template <int DP, class V = Default, typename Store>
__device__ __forceinline__ void attend_bf16(const bf16* q, const bf16* k,
                                            const bf16* v, size_t rs, int n,
                                            int d, int valid_len, float scale,
                                            int q0, bf16* tiles, Store store) {
  constexpr Fn FN = V::fn;
  constexpr int TQ = V::bq, TK = V::bk, NTH = V::nt;
  constexpr int LD = Bf16Tiles<DP, V>::LD;
  constexpr int KD = DP / 16;  // k-steps of the score product
  bf16* qs = tiles;
  bf16* ks = qs + TQ * LD;      // two tiles
  bf16* vs = ks + 2 * TK * LD;  // two tiles

  const int tid = V::heads == 1 ? static_cast<int>(threadIdx.x)
                                : static_cast<int>(threadIdx.x) % NTH;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair

  // `rows` rows of one head into a (rows, DP) tile; rows at or beyond n and
  // columns at or beyond d are zero-filled.
  auto load = [&](bf16* dst, const bf16* src, int row0, int rows) {
    for (int i = tid; i < rows * (DP / 8); i += NTH) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool ok = row0 + r < n && c < d;
      const bf16* s = ok ? src + static_cast<size_t>(row0 + r) * rs + c : src;
      __pipeline_memcpy_async(dst + r * LD + c, s, 16, ok ? 0 : 16);
    }
  };

  load(qs, q, q0, TQ);
  load(ks, k, 0, TK);
  load(vs, v, 0, TK);
  __pipeline_commit();

  uint32_t qf[KD][4];
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  // kExp2: (s - m) * scale * log2 e = fma(s, sl2, -m * sl2)
  const float sl2 = scale * 1.4426950408889634f;

  const int n_tiles = (valid_len + TK - 1) / TK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load(ks + (buf ^ 1) * TK * LD, k, (kt + 1) * TK, TK);
      load(vs + (buf ^ 1) * TK * LD, v, (kt + 1) * TK, TK);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // tile kt (and, on the first, Q) is in shared memory
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        load_a(qf[kk], qs + warp * 16 * LD, LD, kk * 16, lane);
    }
    const bf16* kb = ks + buf * TK * LD;
    const bf16* vb = vs + buf * TK * LD;

    // S (16, TK) = Q K^T: TK / 8 n-tiles of 8 keys
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jj = 0; jj < TK / 16; ++jj) {
        uint32_t kf[4];  // keys 16jj.. (two n-tiles), dims 16kk..
        load_b(kf, kb + jj * 16 * LD, LD, kk * 16, lane);
        mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax; this thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3), columns 8j + 2t + (e & 1); a row's 4 threads share a quad
    const int kvalid = valid_len - kt * TK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j * 8 + 2 * t + (e & 1) < kvalid;
        float val;
        if constexpr (FN == Fn::kNoMask)
          val = s[j][e] * scale;
        else if constexpr (FN == Fn::kMatmul)
          val = in ? s[j][e] * scale : 0.f;
        else if constexpr (FN == Fn::kExp2)
          val = in ? s[j][e] : -INFINITY;
        else if constexpr (FN == Fn::kBf16Softmax)
          val = in ? round_t<bf16>(s[j][e] * scale) : -INFINITY;
        else
          val = in ? s[j][e] * scale : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2];
    if constexpr (FN != Fn::kMatmul) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);  // finite: kvalid >= 1
        if constexpr (FN == Fn::kExp2)
          alpha[r] = ex2_approx((m_r[r] - m_new) * sl2);
        else
          alpha[r] = expf(m_r[r] - m_new);  // 0 on the first tile
        m_r[r] = m_new;
      }
    }
    uint32_t pf[TK / 16][4];  // P as the A operand, one per 16 keys
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      if constexpr (FN == Fn::kBf16Softmax) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // the scores and the max are bf16 values already; their
          // difference rounds to bf16, and its product with log2 e (in
          // fp32: log2 e itself is 0.18% off in bf16) rounds again
          const __nv_bfloat162 d2 =
              __hsub2(__floats2bfloat162_rn(s[j][2 * r], s[j][2 * r + 1]),
                      __float2bfloat162_rn(m_r[r]));
          __nv_bfloat162 d2l =
              __floats2bfloat162_rn(__low2float(d2) * 1.4426950408889634f,
                                    __high2float(d2) * 1.4426950408889634f);
          const uint32_t p2 =
              ex2_approx_bf16x2(*reinterpret_cast<uint32_t*>(&d2l));
          pf[j / 2][(j % 2) * 2 + r] = p2;
          const __nv_bfloat162 pv =
              *reinterpret_cast<const __nv_bfloat162*>(&p2);
          sum[r] += __low2float(pv) + __high2float(pv);
        }
      } else {
        bf16 p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (FN == Fn::kMatmul) {
            p[e] = __float2bfloat16(s[j][e]);
          } else if constexpr (FN == Fn::kFp32Exp) {
            const float pe = expf(s[j][e] - m_r[e >> 1]);
            p[e] = __float2bfloat16(pe);
            sum[e >> 1] += pe;
          } else if constexpr (FN == Fn::kExp2) {
            p[e] = __float2bfloat16(
                ex2_approx(fmaf(s[j][e], sl2, -m_r[e >> 1] * sl2)));
            sum[e >> 1] += __bfloat162float(p[e]);
          } else {
            p[e] = __float2bfloat16(__expf(s[j][e] - m_r[e >> 1]));
            sum[e >> 1] += __bfloat162float(p[e]);
          }
        }
        pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);      // row g
        pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);  // row g + 8
      }
    }
    if constexpr (FN != Fn::kMatmul) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O (16, DP) += P V: V read transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int jd = 0; jd < DP / 16; ++jd) {
        uint32_t vf[4];  // keys 16kk.., dims 16jd.. (two n-tiles)
        ldmatrix_x4(vf,
                    vb + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                        jd * 16 + (lane / 16) * 8,
                    true);
        mma_bf16(o[2 * jd], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * jd + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before refilling
  }

  if constexpr (FN == Fn::kMatmul) {
    l_r[0] = l_r[1] = 1.f;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store(warp * 16 + g + 8 * r, col, o[j][2 * r] / l_r[r],
            o[j][2 * r + 1] / l_r[r]);
  }
}

// Shared memory of the fp32 loop.
template <int DP>
struct F32Tiles {
  static constexpr int LDT = DP + 4;  // q/k/v tile row stride (elements)
  static constexpr int LDS = BK + 4;  // scores / probabilities
  static constexpr int LDO = DP + 4;  // output accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(float) * BQ * LDT);
  static constexpr size_t v = align128(k + sizeof(float) * BK * LDT);
  static constexpr size_t s = align128(v + sizeof(float) * BK * LDT);
  static constexpr size_t o = align128(s + sizeof(float) * BQ * LDS);
  static constexpr size_t m = align128(o + sizeof(float) * BQ * LDO);
  static constexpr size_t l = align128(m + sizeof(float) * BQ);
  static constexpr size_t a = align128(l + sizeof(float) * BQ);
  static constexpr size_t bytes = align128(a + sizeof(float) * BQ);
};

// 64 rows of one head into a zero-padded (64, DP) tile; rows at or beyond n
// are zero.
template <int DP>
__device__ void load_tile_f32(float* dst, const float* src, int row0, int n,
                              size_t rs, int d) {
  constexpr int VPR = DP / 4;
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n && c < d)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * F32Tiles<DP>::LDT + c) = val;
  }
}

// One head, fp32.  Calls store(r, c, value) for local query rows r (0..63)
// and head columns c < d; rows at or beyond n are handed over too.  Ends
// with a barrier, so the next head may reuse the shared memory at once.
template <int DP, typename Store>
__device__ __forceinline__ void attend_f32(const float* q, const float* k,
                                           const float* v, size_t rs, int n,
                                           int d, int valid_len, float scale,
                                           int q0, unsigned char* smem,
                                           Store store) {
  using L = F32Tiles<DP>;
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ks = reinterpret_cast<float*>(smem + L::k);
  float* vs = reinterpret_cast<float*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* ms = reinterpret_cast<float*>(smem + L::m);
  float* ls = reinterpret_cast<float*>(smem + L::l);
  float* as = reinterpret_cast<float*>(smem + L::a);

  const int tid = threadIdx.x;
  // thread: a 4x8 micro-tile of rows r0.., columns c0 + 8j
  const int r0 = (tid / 8) * 4, c0 = tid % 8;

  load_tile_f32<DP>(qs, q, q0, n, rs, d);
  for (int i = tid; i < BQ * L::LDO; i += NT) os[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }

  const int n_tiles = (valid_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of ks/vs/ss are done
    load_tile_f32<DP>(ks, k, k0, n, rs, d);
    load_tile_f32<DP>(vs, v, k0, n, rs, d);
    __syncthreads();
    {  // S = Q K^T (unscaled)
      float acc[4][8] = {};
      for (int dd = 0; dd < DP; ++dd) {
        float a[4], bb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(r0 + i) * L::LDT + dd];
#pragma unroll
        for (int j = 0; j < 8; ++j) bb[j] = ks[(c0 + 8 * j) * L::LDT + dd];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ss[(r0 + i) * L::LDS + c0 + 8 * j] = acc[i][j];
    }
    __syncthreads();
    {
      // online softmax: two threads per score row, 32 columns each
      const int r = tid >> 1, cb = (tid & 1) * 32;
      const int kvalid = min(BK, valid_len - k0);
      float* srow = ss + r * L::LDS;
      float mx = -INFINITY;
      for (int c = cb; c < cb + 32; ++c) {
        const float s = c < kvalid ? srow[c] * scale : -INFINITY;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);  // finite: kvalid >= 1
      float sum = 0.f;
      for (int c = cb; c < cb + 32; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((tid & 1) == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        as[r] = alpha;
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    {  // O = O * alpha + P V
      constexpr int NJ = DP / 8;
      float acc[4][NJ] = {};
      for (int kk = 0; kk < BK; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = ss[(r0 + i) * L::LDS + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float val = vs[kk * L::LDT + c0 + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], val, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = as[r0 + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float* o = os + (r0 + i) * L::LDO + c0 + 8 * j;
          *o = *o * alpha + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    store(r, c, os[r * L::LDO + c] / ls[r]);
  }
  __syncthreads();
}

// Head width padded to the mma k-step: the template argument DP of a head
// width d, or 0 where no instantiation takes it.
inline int padded_width(int d) {
  return d > 0 && d <= 128 && d % 8 == 0 ? (d + 15) / 16 * 16 : 0;
}

}  // namespace flash
}  // namespace vda
