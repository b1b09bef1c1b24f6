// The Hopper (sm_90a) flash-attention loop of K1 and K9 (attention_qkv.cu):
// non-causal softmax(Q K^T * scale) V of one head over 64 * NC query rows,
// bf16 in and out, head width 64 (every encoder the repo has: vits 384/6,
// vitb 768/12, vitl 1024/16, vitg 1536/24).  It replaces, for those shapes,
// the Ampere-style loop of flash_attention.cuh (mma.sync fed by ldmatrix,
// cp.async double buffers and __syncthreads), which reached ~25% of the
// bf16 rate on its products alone and ran the online softmax in series
// with them.
//
// What bounds the function on the H100 is the tensor cores: 4 B N^2 H D
// operations against 4 B N H D * 2 bytes (at vitl, 246 GFLOP against 0.36
// GB: 0.249 ms at 989 TFLOP/s, 0.107 ms at 3.35 TB/s).  The design:
//
//   * a block of NC + 1 warpgroups.  Warpgroup 0 is the producer: it gives
//     up registers (setmaxnreg.dec) and one thread issues every load by TMA.
//     Warpgroups 1..NC are consumers (setmaxnreg.inc): each owns 64 query
//     rows of one (batch, head), so a block owns 64 * NC rows;
//   * TMA loads through one 3-D tensor map per operand over (columns,
//     tokens, batch), with the row stride of the caller's layout (3 H D for
//     K1's fused qkv, H D for K9's tensors).  A box is 64 columns (128 B,
//     exactly one 128-byte swizzle row) by a tile's rows; tokens at or
//     beyond N come in as zeros, so the ragged last tile needs no masked
//     load;
//   * a ring of STAGES K and V tiles of BK rows.  K and V of a stage each
//     have a full mbarrier (expect_tx of the tile's bytes, so S can start
//     before V lands) and an empty one, on which the consumers' warps
//     arrive once the product that read the tile has completed: K is
//     released after Q K^T, V after P V;
//   * S = Q K^T by wgmma.mma_async m64nBKk16 with both operands in shared
//     memory (K's (keys, d) rows are K-major for B: no transpose), 4 k-steps
//     of 16 at D = 64, descriptors in the 128-byte swizzle TMA wrote;
//   * the online softmax in registers.  The wgmma accumulator puts warp w's
//     rows at 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1: the
//     mma.sync C layout the old loop used, so its softmax carries over, with
//     the scale folded into one exp2 FMA.  The max is fp32; P is rounded to
//     bf16 once, packed in pairs, before the value product, and the row sum
//     adds the rounded values, as in the old loop and the TPU kernel's bf16
//     exp.  At head width 64 the exponentials take as long as the products
//     (16 a clock an SM against 4 D = 256 operations a score), so every
//     instruction of the softmax counts: with SUM_MMA the row sums are taken
//     by the tensor core, P times a 16 x 8 block of ones in shared memory
//     (wgmma m64n8k16, fp32 sums of the rounded values), in place of two
//     adds and an unpack a score;
//   * O += P V by wgmma m64n64k16 with P, packed to bf16 in registers, as
//     the A operand (the RS form: the S accumulator's layout is the A
//     fragment's, so no shuffle) and V in shared memory as MN-major B (the
//     transpose bit, allowed for 16-bit types);
//   * hiding the softmax.  Without OVERLAP a consumer waits for each
//     product, and the NC consumers' products and exponentials overlap one
//     another.  With OVERLAP the products of tile j+1 (Q K^T) and of tile j
//     (P V) are issued together before tile j+1's softmax, which runs while
//     they execute (wgmma.wait_group 1, then 0), P double-buffered in
//     registers.  Nothing between the first and the last wgmma of such a
//     batch may write a register a wgmma reads, or ptxas serialises the
//     products (C7513): the tiles are waited for first, every descriptor of
//     the batch is made before its wgmma.fence and pinned there (pin),
//     scale-d is an immediate, the mask goes to temporaries, and P is never
//     copied from one buffer to the other (ptxas may coalesce the two).
//     With PINGPONG the consumers take turns issuing their products (a
//     token passed on named barriers);
//   * the epilogue normalises by the row sum and stores rows < N as bf16
//     pairs.  A consumer whose 64 rows all lie at or beyond N computes
//     nothing (the 192-row blocks pad N = 1370 to 1536 rows).
//
// K1/K9's default (SM90, at the end of this file), the measured
// alternatives (attention_sm90_variants.cu, probes/bench_attn_sm90.py) and
// K12's ablations (attention_variants.cu) are configurations of this one
// kernel.
//
// Keys at or beyond valid_len are masked in the last tile only.  The
// scale must be positive (the max is taken over unscaled scores).
#pragma once

#include "sm90.cuh"  // mbarriers, TMA, setmaxnreg, descriptors, wgmma sync

namespace vda {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int D = 64;            // head width
constexpr int ROW_BYTES = 2 * D;  // one row of a tile: one 128-byte swizzle row
constexpr int Q_ROWS = 64;       // query rows of one consumer warpgroup
constexpr int Q_BYTES = Q_ROWS * ROW_BYTES;

// What a consumer computes: the function (kFull), or for the design's
// measurements its products alone (kProducts: P = bf16(S), no max, exp or
// normalisation) or the load stream alone (kLoads: tiles are waited for and
// released, nothing is computed and the output is zero).  K12's ablations
// of the function (attention_variants.cu):
//   kMatmul      P = bf16(S * scale) over the valid keys, no max, no exp,
//                no normalisation
//   kNoMask      no key compare: the loop runs over valid_len keys, which
//                the caller sets to the padded key count; keys at or beyond
//                N are TMA's zero rows (score 0, value 0).  Only a last
//                tile that reaches past valid_len is masked
//   kFp32Exp     accurate fp32 exp (expf); the row sum adds the unrounded
//                values, in registers (the tensor core's sums read bf16 P)
//   kBf16Softmax scores scaled and rounded to bf16, their max, the shifted
//                score rounded to bf16, times log2 e rounded to bf16 again,
//                exponentiated by ex2.approx.bf16x2
enum class Mode {
  kFull,
  kProducts,
  kLoads,
  kMatmul,
  kNoMask,
  kFp32Exp,
  kBf16Softmax
};

template <int BK_, int NC_, int STAGES_, bool OVERLAP_, bool PINGPONG_,
          Mode MODE_ = Mode::kFull, int POLY_ = 0, bool SUM_MMA_ = false>
struct Config {
  static_assert(BK_ % 16 == 0 && BK_ <= 256, "wgmma n and TMA box rows");
  static_assert(NC_ >= 1 && NC_ <= 3, "consumer warpgroups");
  static constexpr int bk = BK_, nc = NC_, stages = STAGES_;
  static constexpr bool overlap = OVERLAP_, pingpong = PINGPONG_ && NC_ > 1;
  static constexpr Mode mode = MODE_;
  // the modes whose output is a softmax, normalised by its row sums
  static constexpr bool softmax = MODE_ == Mode::kFull ||
                                  MODE_ == Mode::kNoMask ||
                                  MODE_ == Mode::kFp32Exp ||
                                  MODE_ == Mode::kBf16Softmax;
  static constexpr int poly = POLY_;  // softmax_tile's POLY
  // the row sums of P by the tensor core (P times a block of ones) instead
  // of adds in the softmax
  static constexpr bool sum_mma = SUM_MMA_;
  static constexpr int bq = Q_ROWS * NC_;
  static constexpr int threads = 128 * (NC_ + 1);
  static constexpr int kv_bytes = BK_ * ROW_BYTES;  // a multiple of 1024
  static constexpr int k_off = NC_ * Q_BYTES;
  static constexpr int v_off = k_off + STAGES_ * kv_bytes;
  static constexpr int bar_off = v_off + STAGES_ * kv_bytes;
  static constexpr int n_bars = 1 + 4 * STAGES_;
  static constexpr int ones_off = (bar_off + 8 * n_bars + 127) / 128 * 128;
  static constexpr int ones_bytes = SUM_MMA_ ? 1024 : 0;
  // + 1024: the base is aligned up to the 1024-byte swizzle period
  static constexpr int smem_bytes = ones_off + ones_bytes + 1024;
  // registers a thread after setmaxnreg: 128 P + 128 NC C equals what the
  // block holds at launch (65536 / threads, rounded down to 8)
  static constexpr int producer_regs = NC_ == 3 ? 32 : 24;
  static constexpr int consumer_regs = NC_ == 3 ? 160 : NC_ == 2 ? 240 : 256;
  static_assert(smem_bytes <= 232448, "shared memory of a block");
};

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// wgmma.mma_async m64nNk16, bf16 operands, fp32 accumulator; scale-d SD is
// an immediate (0 overwrites d), so that no instruction between the wgmmas
// of a batch computes it.
//   WgmmaSS<N>::run<SD>(d, a, b): d (64 x N) (+)= A (64 x 16, shared,
//     K-major) B (16 x N, shared, K-major: N rows of 16 columns)
//   WgmmaRS<N>::run<SD>(d, a, b): d (64 x N) (+)= A (64 x 16, bf16
//     registers) B (16 x N, shared, MN-major: 16 rows of N columns)
template <int N>
struct WgmmaSS;
template <int N>
struct WgmmaRS;

template <>
struct WgmmaSS<32> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, %18, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <>
struct WgmmaSS<64> {
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
struct WgmmaSS<96> {
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

template <>
struct WgmmaSS<128> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, %66, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <>
struct WgmmaSS<176> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[88], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87"
        "}, %88, %89, %90, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <>
struct WgmmaRS<8> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, %9, 1, 1, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SD));
  }
};

template <>
struct WgmmaRS<64> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, %37, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(SD));
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x for x <= 0 on the FMA pipe, beside the special-function unit's
// ex2: x = n + f with n = rint(x) and f in [-1/2, 1/2], 2^f by a degree-3
// polynomial (relative error 7.7e-5, under half a bf16 ulp), n added to the
// exponent; x is clamped at -126.
__device__ __forceinline__ float ex2_poly(float x) {
  constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: x + kMagic = rint(x)
  x = fmaxf(x, -126.f);
  const float t = x + kMagic;
  const float f = x - (t - kMagic);
  const float p = fmaf(fmaf(fmaf(0.055088725f, f, 0.24260436f), f,
                            0.69327629f),
                       f, 0.99992895f);
  const unsigned n = static_cast<unsigned>(__float_as_int(t) -
                                           __float_as_int(kMagic));
  return __int_as_float(__float_as_int(p) + static_cast<int>(n << 23));
}

// s (raw scores, for kProducts) -> the A operand of the value product, one
// fragment a 16 keys: rows g / g + 8, keys 2t, 2t + 1 and 2t + 8, 2t + 9
// of the k-step.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The online softmax of one S tile in a consumer thread's registers (rows g
// and g + 8 of its warp, s[4j + e] at row g + 8 (e >> 1), column 8j + 2t +
// (e & 1)): masks keys at or beyond valid_len when MASKED, takes the new
// running max, writes the exponentials, rounded to bf16 once and packed in
// pairs, into p (the A fragments of the value product) and returns each
// row's rescale factor of O.  With SUM the row sums l take the rounded
// values (without, the caller sums P otherwise).
// POLY moves a share of the exponentials of an unmasked tile to ex2_poly:
// 0 none, 1 a quarter, 2 a half.
template <int BK, bool MASKED, int POLY, bool SUM>
__device__ __forceinline__ void softmax_tile(const float (&s)[BK / 2],
                                             uint32_t (&p)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2,
                                             int kvalid, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool out = MASKED && j * 8 + 2 * t + (e & 1) >= kvalid;
      mx[e >> 1] = fmaxf(mx[e >> 1], out ? -INFINITY : s[4 * j + e]);
    }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile has a valid key
    alpha[r] = ex2((m[r] - m_new) * sl2);    // 0 on the first tile
    m[r] = m_new;
    mb[r] = m_new * sl2;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const bool poly = !MASKED && (POLY == 2   ? j % 2 == 1
                                  : POLY == 1 ? j % 4 == 3
                                              : false);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool out0 = MASKED && j * 8 + 2 * t >= kvalid;
      const bool out1 = MASKED && j * 8 + 2 * t + 1 >= kvalid;
      const float x0 =
          out0 ? -INFINITY : fmaf(s[4 * j + 2 * r], sl2, -mb[r]);
      const float x1 =
          out1 ? -INFINITY : fmaf(s[4 * j + 2 * r + 1], sl2, -mb[r]);
      const __nv_bfloat162 v =
          poly ? __floats2bfloat162_rn(ex2_poly(x0), ex2_poly(x1))
               : __floats2bfloat162_rn(ex2(x0), ex2(x1));
      p[j / 2][2 * (j % 2) + r] = *reinterpret_cast<const uint32_t*>(&v);
      if (SUM) sum[r] += __low2float(v) + __high2float(v);
    }
  }
  if (SUM) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  }
}

__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// K12's ablated softmaxes of one S tile, in softmax_tile's layout and
// contract (m, l, alpha; SUM as there).  kFp32Exp: expf of the scaled
// shifted score, P its bf16 rounding, the row sums of the unrounded values
// (always in registers).  kBf16Softmax: see Mode.
template <int BK, bool MASKED, bool SUM, Mode FN>
__device__ __forceinline__ void softmax_tile_ablated(
    const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], float scale, int kvalid, int t) {
  static_assert(FN == Mode::kFp32Exp || FN == Mode::kBf16Softmax, "mode");
  constexpr bool kBf = FN == Mode::kBf16Softmax;
  constexpr float kLog2e = 1.4426950408889634f;
  // kBf16Softmax's scores: scaled and rounded to bf16 (the max is over
  // these); kFp32Exp's: unscaled, the scale applied with the shift
  auto score = [&](float v) {
    return kBf ? __bfloat162float(__float2bfloat16(v * scale)) : v;
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool out = MASKED && j * 8 + 2 * t + (e & 1) >= kvalid;
      mx[e >> 1] = fmaxf(mx[e >> 1], out ? -INFINITY : score(s[4 * j + e]));
    }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: a tile has a valid key
    alpha[r] = kBf ? expf(m[r] - m_new) : expf((m[r] - m_new) * scale);
    m[r] = m_new;
    mb[r] = kBf ? m_new : m_new * scale;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool out0 = MASKED && j * 8 + 2 * t >= kvalid;
      const bool out1 = MASKED && j * 8 + 2 * t + 1 >= kvalid;
      const float a0 = s[4 * j + 2 * r], a1 = s[4 * j + 2 * r + 1];
      uint32_t pv;
      if constexpr (kBf) {
        // the scores and the max are bf16 values; their difference rounds
        // to bf16, and its product with log2 e (in fp32: log2 e itself is
        // 0.18% off in bf16) rounds again
        const __nv_bfloat162 d2 = __hsub2(
            __floats2bfloat162_rn(out0 ? -INFINITY : score(a0),
                                  out1 ? -INFINITY : score(a1)),
            __float2bfloat162_rn(mb[r]));
        __nv_bfloat162 d2l = __floats2bfloat162_rn(
            __low2float(d2) * kLog2e, __high2float(d2) * kLog2e);
        pv = ex2_bf16x2(*reinterpret_cast<uint32_t*>(&d2l));
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pv);
        if (SUM) sum[r] += __low2float(v) + __high2float(v);
      } else {
        const float e0 = out0 ? 0.f : expf(fmaf(a0, scale, -mb[r]));
        const float e1 = out1 ? 0.f : expf(fmaf(a1, scale, -mb[r]));
        pv = pack_bf16(e0, e1);
        sum[r] += e0 + e1;
      }
      p[j / 2][2 * (j % 2) + r] = pv;
    }
  }
  if (SUM || !kBf) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  }
}

// kMatmul's P: bf16(S * scale), keys at or beyond kvalid zero when MASKED.
template <int BK, bool MASKED>
__device__ __forceinline__ void pack_p_scaled(const float (&s)[BK / 2],
                                              uint32_t (&p)[BK / 16][4],
                                              float scale, int kvalid, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool out0 = MASKED && j * 8 + 2 * t >= kvalid;
      const bool out1 = MASKED && j * 8 + 2 * t + 1 >= kvalid;
      p[j / 2][2 * (j % 2) + r] =
          pack_bf16(out0 ? 0.f : s[4 * j + 2 * r] * scale,
                    out1 ? 0.f : s[4 * j + 2 * r + 1] * scale);
    }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// One (64 * NC)-row query tile of head blockIdx.y of batch blockIdx.z.
// tmq/tmk/tmv: 3-D maps (columns, tokens, batch) of q, k and v with boxes
// of 64 columns by 64 (q) or BK (k, v) rows; out: contiguous (B, N, H * 64).
template <class C>
__global__ void __launch_bounds__(C::threads, 1)
    attention_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv,
                          bf16* __restrict__ out, int n, int heads,
                          int valid_len, float scale) {
  constexpr int BK = C::bk, S = C::stages, NS = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + C::k_off, v_s = base + C::v_off;
  // mbarriers: q_full, then full_k, full_v, empty_k and empty_v of each
  // stage
  const uint32_t bars = base + C::bar_off;
  auto full_k = [&](int kt) { return bars + 8 * (1 + kt % S); };
  auto full_v = [&](int kt) { return bars + 8 * (1 + S + kt % S); };
  auto empty_k = [&](int kt) { return bars + 8 * (1 + 2 * S + kt % S); };
  auto empty_v = [&](int kt) { return bars + 8 * (1 + 3 * S + kt % S); };
  // the phase of a stage's barriers that tile kt waits for
  auto parity = [&](int kt) { return static_cast<uint32_t>((kt / S) & 1); };
  const int q0 = blockIdx.x * C::bq, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (valid_len + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * C::nc);
      mbar_init(empty_v(s), 4 * C::nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::sum_mma) {
    // the ones block of the row sums, for the tensor core's (async) proxy
    if (threadIdx.x < C::ones_bytes / 4)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base + C::ones_off +
                                                      4 * threadIdx.x),
                   "r"(0x3f803f80u)
                   : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<C::producer_regs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tmq);
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
      mbar_expect_tx(bars, C::nc * Q_BYTES);
      for (int c = 0; c < C::nc; ++c)
        tma_load(q_s + c * Q_BYTES, &tmq, h * D, q0 + c * Q_ROWS, b, bars);
      // a stage is free once the consumers released its previous tile
      // (the first round passes at once)
      auto load = [&](int kt, uint32_t tiles, const CUtensorMap* map,
                      uint32_t full, uint32_t empty) {
        mbar_wait(empty, parity(kt) ^ 1);
        mbar_expect_tx(full, C::kv_bytes);
        tma_load(tiles + (kt % S) * C::kv_bytes, map, h * D, kt * BK, b,
                 full);
      };
      for (int kt = 0; kt < n_tiles; ++kt) {
        load(kt, k_s, &tmk, full_k(kt), empty_k(kt));
        load(kt, v_s, &tmv, full_v(kt), empty_v(kt));
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<C::consumer_regs>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float sl2 = scale * 1.4426950408889634f;
  auto release = [&](uint32_t empty) {
    if (lane == 0) mbar_arrive(empty);
  };
  // the token of the issue order: consumer c waits on barrier 1 + c and
  // passes it to the next; the last one hands out the first token
  auto take_turn = [&]() {
    if constexpr (C::pingpong) named_sync(1 + c);
  };
  auto pass_turn = [&](bool last) {
    if constexpr (C::pingpong)
      if (!(last && c == C::nc - 1)) named_arrive(1 + (c + 1) % C::nc);
  };
  if constexpr (C::pingpong)
    if (c == C::nc - 1) named_arrive(1);

  float o[D / 2], ls[4] = {0.f, 0.f, 0.f, 0.f};  // ls: row sums (sum_mma)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  // a consumer whose query rows all lie at or beyond N (the last block of a
  // head) only keeps the ring turning; with PINGPONG it takes its turns
  const bool idle = !C::pingpong && q0 + c * Q_ROWS >= n;
  if (C::mode == Mode::kLoads || idle) {
    for (int kt = 0; kt < n_tiles; ++kt) {
      mbar_wait(full_k(kt), parity(kt));
      release(empty_k(kt));
      mbar_wait(full_v(kt), parity(kt));
      release(empty_v(kt));
    }
    l[0] = l[1] = 1.f;
  } else {
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    // P: two buffers, one read by the P V in flight while the softmax
    // writes the other (a copy from one to the other would let ptxas
    // coalesce them and serialise the products)
    uint32_t pa[BK / 16][4], pb[BK / 16][4];
    mbar_wait(bars, 0);
    const uint64_t dq = desc_sw128(q_s + c * Q_BYTES);

    // the descriptors of a batch's wgmmas, made and pinned before its
    // fence: of Q and K for each k-step of Q K^T, of V for each of P V
    uint64_t da[D / 16], dk[D / 16], dv[BK / 16], d1[1];
    // the ones block: B of the row sums, 16 x 8, any layout reads ones
    const uint64_t ones = static_cast<uint64_t>(
                              ((base + C::ones_off) & 0x3FFFF) >> 4) |
                          static_cast<uint64_t>(128 >> 4) << 16 |
                          static_cast<uint64_t>(256 >> 4) << 32;
    auto desc_k = [&](int kt) {
      const uint64_t d = desc_sw128(k_s + (kt % S) * C::kv_bytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        da[kk] = dq + 2 * kk;
        dk[kk] = d + 2 * kk;
      }
      pin(da);
      pin(dk);
    };
    auto desc_v = [&](int kt) {
      const uint64_t d = desc_sw128(v_s + (kt % S) * C::kv_bytes);
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
        if constexpr (C::sum_mma) WgmmaRS<8>::template run<1>(ls, p[kk], d1[0]);
      }
    };
    // S of tile kt -> its P in pn; alpha is set
    auto softmax = [&](int kt, uint32_t (&pn)[BK / 16][4]) {
      if constexpr (C::mode == Mode::kFull) {
        if (kt == n_tiles - 1)
          softmax_tile<BK, true, C::poly, !C::sum_mma>(
              s, pn, m, l, alpha, sl2, valid_len - kt * BK, t);
        else
          softmax_tile<BK, false, C::poly, !C::sum_mma>(s, pn, m, l, alpha,
                                                        sl2, BK, t);
      } else if constexpr (C::mode == Mode::kNoMask) {
        // only a last tile past the padded key count compares keys
        if (kt == n_tiles - 1 && valid_len % BK)
          softmax_tile<BK, true, C::poly, !C::sum_mma>(
              s, pn, m, l, alpha, sl2, valid_len - kt * BK, t);
        else
          softmax_tile<BK, false, C::poly, !C::sum_mma>(s, pn, m, l, alpha,
                                                        sl2, BK, t);
      } else if constexpr (C::mode == Mode::kFp32Exp ||
                           C::mode == Mode::kBf16Softmax) {
        if (kt == n_tiles - 1)
          softmax_tile_ablated<BK, true, !C::sum_mma, C::mode>(
              s, pn, m, l, alpha, scale, valid_len - kt * BK, t);
        else
          softmax_tile_ablated<BK, false, !C::sum_mma, C::mode>(
              s, pn, m, l, alpha, scale, BK, t);
      } else if constexpr (C::mode == Mode::kMatmul) {
        if (kt == n_tiles - 1)
          pack_p_scaled<BK, true>(s, pn, scale, valid_len - kt * BK, t);
        else
          pack_p_scaled<BK, false>(s, pn, scale, BK, t);
        alpha[0] = alpha[1] = 1.f;
      } else {
        pack_p<BK>(s, pn);
        alpha[0] = alpha[1] = 1.f;
      }
    };

    if constexpr (C::overlap) {
      // batch 0: S of tile 0
      take_turn();
      mbar_wait(full_k(0), parity(0));
      desc_k(0);
      fence_regs(s);
      wgmma_fence();
      issue_s();
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k(0));
      softmax(0, pa);
      // batch kt: S of tile kt with P V of tile kt - 1 (P in pc); tile kt's
      // P goes to pn
      auto batch = [&](int kt, uint32_t (&pc)[BK / 16][4],
                       uint32_t (&pn)[BK / 16][4]) {
        take_turn();
        mbar_wait(full_k(kt), parity(kt));
        mbar_wait(full_v(kt - 1), parity(kt - 1));
        desc_k(kt);
        desc_v(kt - 1);
        fence_regs(s);
        fence_regs(o);
        fence_regs(ls);
        fence_regs<BK / 16>(pc);
        wgmma_fence();
        issue_s();
        wgmma_commit();
        issue_pv(pc);
        wgmma_commit();
        pass_turn(false);
        wgmma_wait<1>();
        fence_regs(s);
        release(empty_k(kt));
        softmax(kt, pn);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ls);
        fence_regs<BK / 16>(pc);
        release(empty_v(kt - 1));
        rescale(o, alpha);
        rescale(ls, alpha);
      };
      // the last batch: P V of the last tile
      auto last = [&](uint32_t (&pc)[BK / 16][4]) {
        take_turn();
        mbar_wait(full_v(n_tiles - 1), parity(n_tiles - 1));
        desc_v(n_tiles - 1);
        fence_regs(o);
        fence_regs(ls);
        fence_regs<BK / 16>(pc);
        wgmma_fence();
        issue_pv(pc);
        wgmma_commit();
        pass_turn(true);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ls);
        release(empty_v(n_tiles - 1));
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
        take_turn();
        mbar_wait(full_k(kt), parity(kt));
        desc_k(kt);
        fence_regs(s);
        wgmma_fence();
        issue_s();
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        release(empty_k(kt));
        softmax(kt, pa);
        rescale(o, alpha);
        rescale(ls, alpha);
        mbar_wait(full_v(kt), parity(kt));
        desc_v(kt);
        fence_regs(o);
        fence_regs(ls);
        fence_regs<BK / 16>(pa);
        wgmma_fence();
        issue_pv(pa);
        wgmma_commit();
        pass_turn(kt == n_tiles - 1);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ls);
        release(empty_v(kt));
      }
    }
    if constexpr (C::softmax && C::sum_mma) {
      l[0] = ls[0];  // every column of the (64, 8) sums is the row sum
      l[1] = ls[2];
    } else if constexpr (C::softmax) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    } else {
      l[0] = l[1] = 1.f;
    }
  }

  const int hd = heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + c * Q_ROWS + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + (static_cast<size_t>(b) * n + row) * hd + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                o[4 * j + 2 * r + 1] / l[r]);
  }
}

// ---- host side ----

// A map over a head-packed bf16 operand: `cols` (H * 64) columns of `n`
// tokens `rs` elements apart, batches n * rs apart; boxes of 64 columns by
// `rows` tokens in the 128-byte swizzle, zero outside the tensor.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int cols,
                            int n, int b, size_t rs, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {rs * 2, static_cast<cuuint64_t>(n) * rs * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k, v: 16-byte aligned, token t of batch b at x + (b * n + t) * rs (rs a
// multiple of 8); out: contiguous (B, N, H * 64); scale > 0.
template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int heads, size_t rs, int valid_len,
                   float scale, cudaStream_t stream) {
  if (!(scale > 0.f)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e = make_map(&mq, q, heads * D, n, b, rs, Q_ROWS);
  if (e == cudaSuccess) e = make_map(&mk, k, heads * D, n, b, rs, C::bk);
  if (e == cudaSuccess) e = make_map(&mv, v, heads * D, n, b, rs, C::bk);
  if (e != cudaSuccess) return e;
  auto kern = attention_sm90_kernel<C>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::smem_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + C::bq - 1) / C::bq, heads, b);
  kern<<<grid, C::threads, C::smem_bytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), n, heads, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace sm90

// K1/K9's configuration of the loop (attention_qkv.cu), the fastest of the
// steps that probes/bench_attn_sm90.py times (attention_sm90_variants.cu):
// K/V tiles of 128 keys in a ring of 2 stages, three consumer warpgroups
// (192 query rows a block) that each wait for a product before the softmax
// and overlap one another, and the row sums of P taken by the tensor core.
// K12's "full" (attention_variants.cu) runs the same configuration.
using SM90 = sm90::Config<128, 3, 2, false, false, sm90::Mode::kFull, 0, true>;

}  // namespace vda
