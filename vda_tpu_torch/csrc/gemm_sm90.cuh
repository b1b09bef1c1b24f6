// The Hopper (sm_90a) GEMM mainloop of K11 and K13 (int8_matmul.cu):
// C = A B^T with A (M, K) and B^T (N, K) row-major, int8 x int8 -> int32
// sums or bf16 x bf16 -> fp32 sums, and an epilogue (gemm_epilogue.cuh)
// that dequantises (K11) or stores (K13).  It replaces the Ampere-style
// loop of gemm_sm80.cuh (mma.sync fed by ldmatrix and cp.async), which
// reached ~20% of the tensor cores' rate: on Hopper only wgmma reaches it.
//
// What bounds the function on the H100: at the encoder's qkv product,
// (43840..45056, 1024) x (1024, 3072), the operations (2.8e11: 0.14 ms at
// 1979 TOP/s int8, 0.29 ms at 989 TFLOP/s bf16) against ~0.05-0.10 GB of
// operands; K13's int8 product writes 0.55 GB of int32, so the bytes bind
// it (0.18 ms at 3.35 TB/s).  The design:
//
//   * a block of three warpgroups.  Warpgroup 0 is the producer: it gives
//     up registers (setmaxnreg.dec) and one thread issues every load by
//     TMA.  Warpgroups 1 and 2 are consumers (setmaxnreg.inc), each owning
//     half of the block's BM output rows (64 or 128) over all BN columns;
//   * TMA loads through one 2-D tensor map per operand over (K, rows), in
//     boxes of 128 bytes of k (one 128-byte swizzle row: 128 int8 or 64
//     bf16 values) by the tile's rows.  A stage is one such box of A and one
//     of B^T, 4 wgmma k-steps of 32 bytes (k32 for s8, k16 for bf16), so the
//     two element types share every descriptor and offset; only the map's
//     element type, the wgmma instruction and the accumulator type differ.
//     Rows at or beyond M or N and bytes at or beyond K come in as zeros,
//     so ragged tiles need no masked load (the wrapper pads K to 16 bytes,
//     TMA's stride granule);
//   * both operands K-major in shared memory, as the 8-bit wgmma requires
//     (the transpose bit exists for 16-bit types only), which is why B is
//     taken transposed: no data is rearranged;
//   * a ring of STAGES stages, each with a full mbarrier (expect_tx of the
//     stage's bytes) and an empty one on which each consumer warp arrives
//     once the wgmma batch that read the stage has completed.  A consumer
//     keeps one batch in flight: it issues k-block kt, waits for kt - 1
//     (wgmma.wait_group 1) and releases kt - 1's stage.  The first product
//     of a tile overwrites the sums (scale-d 0), so nothing zeroes them;
//   * a persistent grid: one block an SM walks the output tiles in row-panel
//     order (tile t is row panel t / tiles_n, column tile t % tiles_n), so
//     the 132 tiles in flight share ~11 panels of A and all of B^T (3 MB
//     int8, 6 MB bf16) in the 50 MB L2, and A is read from device memory
//     about once.  The producer runs STAGES k-blocks ahead across tile
//     boundaries, so one tile's epilogue overlaps the next tile's loads;
//   * (CLUSTER 2) the stages are filled from L2 at ~9.5 TB/s across the
//     card (probes/bench_gemm_sm90.py's loads step), which is as long as
//     the products take: two blocks of a cluster take two row-adjacent
//     tiles of one column tile, and each loads its own A and half of the
//     shared B^T tile, multicast into both blocks, so a block reads 256
//     rows a stage from L2 instead of 384.  A stage is then free once the
//     consumers of both blocks released it (its empty barrier counts 16
//     warps, 8 of them remote), and a producer leaves only once both
//     blocks released its last stages, since the other block still
//     arrives on its barriers;
//   * the epilogue from registers: the wgmma accumulator puts warp w's rows
//     at 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, stored as
//     column pairs, rows >= M and columns >= N skipped; or (STORE_BOXES > 0)
//     staged in shared memory, STORE_BOXES boxes of 64 rows x 128 bytes a
//     consumer in the 128-byte swizzle, and written by TMA stores that clip
//     at M and N.  A consumer writes a group of STORE_BOXES boxes, then one
//     thread issues their stores; before the next group overwrites the
//     boxes it waits until the last group's stores have read them, which
//     the next tile's mainloop usually covers.  Stores from registers take
//     0.06-0.28 ms more than the staging at the probe shapes.
//
// Under a sustained load the card meets its 700 W limit and lowers its
// clock (~1.39 GHz in bf16), where the products alone run at ~98% of the
// tensor rate that clock gives; the epilogue adds 13-15% in bf16 (PERF.md,
// PR 7).
//
// A paired epilogue (paired_epi below; K3's GEGLU, gemm_epilogue.cuh)
// takes a tile of B^T made of two halves: BN / 2 rows from the first half of
// B^T's N rows and the same BN / 2 rows of its second half (x1 and the gate
// of one chunk of hidden columns), so one thread holds both sums of an
// output column.  The output is (M, N / 2).
//
// The library's default (int8_matmul.cu) and the measured alternatives
// (gemm_sm90_variants.cu, probes/bench_gemm_sm90.py) are configurations of
// this one kernel.  Nothing between the first and the last wgmma of a batch
// writes a register a wgmma reads (the descriptors are made and pinned
// before its fence), or ptxas would serialise the batch (C7513).
#pragma once

#include <type_traits>

#include "gemm_epilogue.cuh"
#include "sm90.cuh"

namespace vda {
namespace gemm90 {

using namespace sm90;

constexpr int KB = 128;  // bytes of k a stage: one 128-byte swizzle row
constexpr int KSTEPS = KB / 32;  // wgmma k-steps a stage
constexpr int BOX_ROWS = 64;  // rows of a TMA-store box (a warpgroup's m64)

// What a consumer computes: the function (kFull), or for the design's
// measurements the products alone (kProducts: no epilogue, the output is
// not written), the load stream alone (kLoads: stages are waited for and
// released, nothing is computed or written), and the two halves of the
// TMA-store epilogue: the staging alone (kStage: the epilogue up to the
// stores, which are not issued) and the stores alone (kStoreOnly: staging
// zeroed once, stored without being written, so the output is zero).
enum class Mode { kFull, kProducts, kLoads, kStage, kStoreOnly };

template <int BM_, int BN_, int STAGES_, bool PERSISTENT_ = true,
          int STORE_BOXES_ = 0, Mode MODE_ = Mode::kFull, int CLUSTER_ = 1>
struct Config {
  static_assert(BM_ == 128 || BM_ == 256, "two consumers of m64 products");
  static_assert(BN_ == 128 || BN_ == 256, "wgmma n and TMA box rows");
  static_assert(CLUSTER_ == 1 || CLUSTER_ == 2, "blocks sharing B^T tiles");
  static constexpr int bm = BM_, bn = BN_, stages = STAGES_;
  static constexpr int cluster = CLUSTER_;
  static_assert(STORE_BOXES_ > 0 ||
                    (MODE_ != Mode::kStage && MODE_ != Mode::kStoreOnly),
                "halves of the TMA-store epilogue");
  static constexpr bool persistent = PERSISTENT_;
  // boxes of the TMA-store epilogue a consumer (0: stores from registers)
  static constexpr int store_boxes = STORE_BOXES_;
  static constexpr bool tma_store = STORE_BOXES_ > 0;
  static constexpr Mode mode = MODE_;
  static constexpr int wm = BM_ / 2;  // rows of a consumer
  static constexpr int mi = wm / 64;  // its m64 products a k-step
  static constexpr int threads = 384;
  static constexpr int a_bytes = BM_ * KB, b_bytes = BN_ * KB;
  static constexpr int stage_bytes = a_bytes + b_bytes;  // a multiple of 1024
  static constexpr int box_bytes = BOX_ROWS * 128;
  static constexpr int out_off = STAGES_ * stage_bytes;
  static constexpr int bar_off = out_off + 2 * STORE_BOXES_ * box_bytes;
  // + 1024: the base is aligned up to the 1024-byte swizzle period
  static constexpr int smem_bytes = bar_off + 16 * STAGES_ + 1024;
  // 40 x 128 + 232 x 256 registers fit the SM's 65536
  static constexpr int producer_regs = 40, consumer_regs = 232;
  static_assert(smem_bytes <= 232448, "shared memory of a block");
};

// The element types: wgmma's k-step is 32 bytes of either.
struct S8 {
  using Acc = int;
  static constexpr int elem = 1;
  static constexpr CUtensorMapDataType map_type =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
struct BF16 {
  using Acc = float;
  static constexpr int elem = 2;
  static constexpr CUtensorMapDataType map_type =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// wgmma.mma_async m64nNk32 (s8, int32 sums) or m64nNk16 (bf16, fp32 sums),
// both operands in shared memory and K-major; scale-d SD is an immediate
// (0 overwrites d), so that no instruction between the wgmmas of a batch
// computes it.  Wgmma<T, N>::run<SD>(d, a, b): d (64 x N) (+)= A (64 x 32
// bytes) B (N rows of 32 bytes).
template <class T, int N>
struct Wgmma;

template <>
struct Wgmma<S8, 128> {
  template <int SD>
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, %66;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <>
struct Wgmma<S8, 256> {
  template <int SD>
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, %130;\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <>
struct Wgmma<BF16, 128> {
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
struct Wgmma<BF16, 256> {
  template <int SD>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, %130, 1, 1, 0, 0;\n"
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
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "n"(SD));
  }
};

template <typename Out>
constexpr CUtensorMapDataType out_map_type() {
  if constexpr (std::is_same_v<Out, int>)
    return CU_TENSOR_MAP_DATA_TYPE_INT32;
  else if constexpr (std::is_same_v<Out, float>)
    return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// An epilogue whose `paired` is true combines the two halves of the B^T
// tile (header); its pair() takes the two sums of each half.
template <class E, class = void>
struct paired_epi : std::false_type {};
template <class E>
struct paired_epi<E, std::void_t<decltype(E::paired)>>
    : std::bool_constant<E::paired> {};

// An epilogue with prefetch(row, col) reads another (M, N / PW) operand
// (the residual): each consumer thread asks L2 for its share of the
// tile's lines of it when the tile starts, so that the reads of the
// epilogue, a mainloop later, do not wait on device memory.
template <class E, class = void>
struct prefetch_epi : std::false_type {};
template <class E>
struct prefetch_epi<E, std::void_t<decltype(&E::prefetch)>>
    : std::true_type {};

// Row of B^T that half `hf` (0 or 1) of the tile at column n0 starts at.
template <class Epi, int BN>
__device__ __forceinline__ int b_row(int n0, int hf, int n) {
  if constexpr (paired_epi<Epi>::value)
    return hf * (n / 2) + n0 / 2;
  else
    return n0 + hf * (BN / 2);
}

// The output pair of rows-half h of the 8-column group j of one m64
// slice's sums a, at (row, col): sums 4j + 2h and 4j + 2h + 1 (paired: and
// those of group j + OBN / 8, the same column of the second half).
template <bool PAIRED, int OBN, class Epi, typename Acc, int N>
__device__ __forceinline__ auto pair_value(const Epi& epi, const Acc (&a)[N],
                                           int j, int h, int row, int col) {
  if constexpr (PAIRED)
    return epi.pair(row, col, a[4 * j + 2 * h], a[4 * j + 2 * h + 1],
                    a[4 * (j + OBN / 8) + 2 * h],
                    a[4 * (j + OBN / 8) + 2 * h + 1]);
  else
    return epi.pair(row, col, a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ void consumer_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// C = A B^T, the block's share of the tiles (the walk below); ta, tb: 2-D
// maps over A (M, K) and B^T (N, K) with boxes of 128 bytes of k by BM and
// BN / CLUSTER rows; tc: the output's map (boxes of 64 rows by 128 bytes)
// when STORE_BOXES > 0, else unused; kb: bytes of k a row (a multiple of
// 16).
template <class C, class T, class Epi>
__global__ void __launch_bounds__(C::threads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, int m, int n,
                     int kb, Epi epi) {
  using Acc = typename T::Acc;
  using Out = typename Epi::Out;
  constexpr int S = C::stages, BM = C::bm, BN = C::bn, MI = C::mi;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::bar_off;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  // the block's walk: work unit u is a tile (CL 1) or a pair of
  // row-adjacent tiles of one column tile (CL 2, one tile a block of the
  // cluster), units first, first + stride, ...
  constexpr int CL = C::cluster;
  // PW: output columns are N / PW, OBN a tile's (header: paired)
  constexpr bool PAIRED = paired_epi<Epi>::value;
  constexpr int PW = PAIRED ? 2 : 1, OBN = BN / PW;
  const uint32_t rank = CL == 2 ? cluster_ctarank() : 0;
  const int tiles_n = (n + BN - 1) / BN;
  const int units = ((m + BM * CL - 1) / (BM * CL)) * tiles_n;
  const int first = blockIdx.x / CL, stride = gridDim.x / CL;
  auto origin = [&](int u, int& m0, int& n0) {
    m0 = ((u / tiles_n) * CL + static_cast<int>(rank)) * BM;
    n0 = u % tiles_n * BN;
  };
  const int nk = (kb + KB - 1) / KB;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8 * CL);  // each consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CL == 2)
    cluster_sync();  // no block loads into another before its barriers exist
  else
    __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<C::producer_regs>();
    if (threadIdx.x == 0) {
      tma_prefetch(&ta);
      tma_prefetch(&tb);
      int s = 0;
      uint32_t ph = 0;
      auto next = [&]() {
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      };
      for (int u = first; u < units; u += stride) {
        int m0, n0;
        origin(u, m0, n0);
        for (int kt = 0; kt < nk; ++kt) {
          // a stage is free once the consumers released its previous
          // k-block (the first round passes at once)
          mbar_wait(empty(s), ph ^ 1);
          mbar_expect_tx(full(s), C::stage_bytes);  // A and all of B^T
          const uint32_t st = base + s * C::stage_bytes;
          const int k0 = kt * (KB / T::elem);
          tma_load_2d(st, &ta, k0, m0, full(s));
          if constexpr (CL == 2)  // this block's half of B^T, to both
            tma_load_2d_multicast(st + C::a_bytes + rank * (BN / 2) * KB,
                                  &tb, k0, b_row<Epi, BN>(n0, rank, n),
                                  full(s), 0x3);
          else if constexpr (PAIRED)  // both halves, one box each
            for (int hf = 0; hf < 2; ++hf)
              tma_load_2d(st + C::a_bytes + hf * (BN / 2) * KB, &tb, k0,
                          b_row<Epi, BN>(n0, hf, n), full(s));
          else
            tma_load_2d(st + C::a_bytes, &tb, k0, n0, full(s));
          next();
        }
      }
      if constexpr (CL == 2)  // the other block's consumers still arrive
        for (int i = 0; i < S; ++i) {
          mbar_wait(empty(s), ph ^ 1);
          next();
        }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<C::consumer_regs>();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  auto release = [&](int s) {
    if (lane == 0) {
      if constexpr (CL == 2) {
        mbar_arrive_cluster(empty(s), 0);
        mbar_arrive_cluster(empty(s), 1);
      } else {
        mbar_arrive(empty(s));
      }
    }
  };
  Acc acc[MI][BN / 2];
  int s = 0;
  uint32_t ph = 0;
  // batch of k-block stage st: KSTEPS k-steps of MI m64 x BN products;
  // ZERO: the first of the tile, whose first k-step overwrites the sums
  auto issue = [&](int st, auto zero) {
    const uint32_t sa = base + st * C::stage_bytes + c * C::wm * KB;
    const uint64_t b0 = desc_sw128(base + st * C::stage_bytes + C::a_bytes);
    uint64_t db[KSTEPS], da[MI][KSTEPS];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      db[kk] = b0 + 2 * kk;  // +32 bytes of k
#pragma unroll
      for (int i = 0; i < MI; ++i)
        da[i][kk] = desc_sw128(sa + i * BOX_ROWS * KB) + 2 * kk;
    }
    pin(db);
#pragma unroll
    for (int i = 0; i < MI; ++i) pin(da[i]);
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if constexpr (decltype(zero)::value) {
          if (kk == 0)
            Wgmma<T, BN>::template run<0>(acc[i], da[i][kk], db[kk]);
          else
            Wgmma<T, BN>::template run<1>(acc[i], da[i][kk], db[kk]);
        } else {
          Wgmma<T, BN>::template run<1>(acc[i], da[i][kk], db[kk]);
        }
      }
    wgmma_commit();
  };
  auto next = [&]() {
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  };

  if constexpr (C::mode == Mode::kStoreOnly) {  // the zeros it stores
    for (int o = 4 * tid; o < C::store_boxes * C::box_bytes; o += 4 * 128)
      asm volatile("st.shared.b32 [%0], 0;\n" ::"r"(
                       base + C::out_off + c * C::store_boxes * C::box_bytes +
                       o)
                   : "memory");
    fence_proxy_async();
    consumer_sync(c);
  }

  for (int u = first; u < units; u += stride) {
    int m0, n0;
    origin(u, m0, n0);
    if constexpr (prefetch_epi<Epi>::value) {
      // the thread's 2 MI rows, one 128-byte line in four of each
      constexpr int LINES = OBN * static_cast<int>(sizeof(Out)) / 128;
      constexpr int PER_LINE = 128 / static_cast<int>(sizeof(Out));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + c * C::wm + i * 64 + warp * 16 + g + 8 * h;
          for (int l = t; l < LINES; l += 4)
            if (row < m && n0 / PW + l * PER_LINE < n / PW)
              epi.prefetch(row, n0 / PW + l * PER_LINE);
        }
    }
    if constexpr (C::mode == Mode::kLoads) {
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full(s), ph);
        release(s);
        next();
      }
      continue;
    }
    mbar_wait(full(s), ph);
    issue(s, std::true_type{});
    int prev = s;
    next();
    for (int kt = 1; kt < nk; ++kt) {
      mbar_wait(full(s), ph);
      issue(s, std::false_type{});
      wgmma_wait<1>();  // k-block kt - 1 is done with its stage
#pragma unroll
      for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
      release(prev);
      prev = s;
      next();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
    release(prev);
    if constexpr (C::mode == Mode::kProducts) {
      // sums that nothing reads would let ptxas drop the products that make
      // them: one of each consumer's sums goes to a store that no run takes
      // (m is positive)
      if (m < 0)
#pragma unroll
        for (int i = 0; i < MI; ++i)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base),
                       "r"(reinterpret_cast<const uint32_t&>(acc[i][0]))
                       : "memory");
      continue;
    }

    const int r0 = m0 + c * C::wm;  // the consumer's first row
    if constexpr (!C::tma_store) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < OBN / 8; ++j) {
          const int col = n0 / PW + 8 * j + 2 * t;
          if (col >= n / PW) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + i * 64 + warp * 16 + g + 8 * h;
            if (row < m)
              gemm::store_value(
                  epi, row, col,
                  pair_value<PAIRED, OBN>(epi, acc[i], j, h, row, col));
          }
        }
    } else {
      // the consumer's 64-row slices (MI) x its columns in boxes of 128
      // bytes (COLS columns), in groups of NB boxes of staging
      constexpr int COLS = 128 / sizeof(Out), NB = C::store_boxes;
      constexpr int BOXES = MI * (OBN / COLS);
      using Pair =
          decltype(pair_value<PAIRED, OBN>(epi, acc[0], 0, 0, 0, 0));
#pragma unroll
      for (int g0 = 0; g0 < BOXES; g0 += NB) {
        // the previous group's stores have read the staging
        if (tid == 0) bulk_wait_read<0>();
        consumer_sync(c);
        // the group's pairs first, then their stores (the stores' memory
        // clobbers would make every pair reload its scales)
        Pair v[NB][COLS / 8][2];
#pragma unroll
        for (int bx = g0; bx < g0 + NB && bx < BOXES; ++bx) {
          const int i = bx / (OBN / COLS), cb = bx % (OBN / COLS);
#pragma unroll
          for (int jj = 0; jj < COLS / 8; ++jj) {
            const int j = cb * (COLS / 8) + jj;
            const int col = n0 / PW + 8 * j + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = r0 + i * 64 + warp * 16 + g + 8 * h;
              v[bx - g0][jj][h] = Pair{};
              if (C::mode != Mode::kStoreOnly && row < m && col < n / PW)
                v[bx - g0][jj][h] =
                    pair_value<PAIRED, OBN>(epi, acc[i], j, h, row, col);
            }
          }
        }
#pragma unroll
        for (int bx = g0; bx < g0 + NB && bx < BOXES; ++bx) {
          if constexpr (C::mode == Mode::kStoreOnly) continue;
          const uint32_t buf =
              base + C::out_off + (c * NB + bx - g0) * C::box_bytes;
#pragma unroll
          for (int jj = 0; jj < COLS / 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = warp * 16 + g + 8 * h;  // row in the box
              const int off = (8 * jj + 2 * t) * static_cast<int>(sizeof(Out));
              const uint32_t dst =
                  buf + r * 128 + (((off / 16) ^ (r % 8)) * 16) + off % 16;
              const Pair& p = v[bx - g0][jj][h];
              if constexpr (sizeof(Pair) == 8)
                asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst),
                             "r"(reinterpret_cast<const uint2&>(p).x),
                             "r"(reinterpret_cast<const uint2&>(p).y)
                             : "memory");
              else
                asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                             "r"(reinterpret_cast<const uint32_t&>(p))
                             : "memory");
            }
        }
        fence_proxy_async();
        consumer_sync(c);
        if (tid == 0 && C::mode != Mode::kStage) {
#pragma unroll
          for (int bx = g0; bx < g0 + NB && bx < BOXES; ++bx) {
            const int col0 = n0 / PW + bx % (OBN / COLS) * COLS;
            const int row0 = r0 + bx / (OBN / COLS) * 64;
            // a box wholly outside is not stored
            if (col0 < n / PW && row0 < m)
              tma_store_2d(
                  &tc, base + C::out_off + (c * NB + bx - g0) * C::box_bytes,
                  col0, row0);
          }
          bulk_commit();
        }
      }
    }
  }
  if constexpr (C::tma_store)
    if (tid == 0) bulk_wait_all();
}

// ---- host side ----

// A 2-D map over `rows` rows of `cols` elements of `type`, `row_bytes`
// apart (a multiple of 16); boxes of box_cols x box_rows in the 128-byte
// swizzle (box_cols x the element size is 128 bytes), zero outside the
// tensor.
inline cudaError_t make_map_2d(CUtensorMap* map, const void* ptr,
                               CUtensorMapDataType type, int cols, int rows,
                               size_t row_bytes, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a (M, K) and bt (N, K) of T, kb = K * elem bytes a row (a multiple of
// 16), both 16-byte aligned; epi writes out (M, N).
template <class C, class T, class Epi>
cudaError_t launch(const void* a, const void* bt, int m, int n, int kb,
                   Epi epi, cudaStream_t stream) {
  using Out = typename Epi::Out;
  constexpr bool PAIRED = paired_epi<Epi>::value;
  constexpr int PW = PAIRED ? 2 : 1;
  // paired: each half of a tile lies within its half of B^T
  if (PAIRED && (n / 2) % (C::bn / 2)) return cudaErrorInvalidValue;
  constexpr int box_k = KB / T::elem;
  CUtensorMap ma, mb, mc{};
  cudaError_t e = make_map_2d(&ma, a, T::map_type, kb / T::elem, m, kb,
                              box_k, C::bm);
  if (e == cudaSuccess)
    e = make_map_2d(&mb, bt, T::map_type, kb / T::elem, n, kb, box_k,
                    C::bn / (C::cluster == 2 || PAIRED ? 2 : 1));
  constexpr int out_elem = static_cast<int>(sizeof(Out));
  if (e == cudaSuccess && C::tma_store)
    e = make_map_2d(&mc, epi.out, out_map_type<Out>(), n / PW, m,
                    static_cast<size_t>(n / PW) * out_elem, 128 / out_elem,
                    BOX_ROWS);
  if (e != cudaSuccess) return e;
  auto kern = gemm_sm90_kernel<C, T, Epi>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::smem_bytes);
  if (e != cudaSuccess) return e;
  constexpr int CL = C::cluster;
  const long long units =
      static_cast<long long>((m + C::bm * CL - 1) / (C::bm * CL)) *
      ((n + C::bn - 1) / C::bn);
  if (units * CL > 0x7fffffff) return cudaErrorInvalidValue;
  if constexpr (CL == 1) {
    const int sms = device_sms();
    if (sms == 0) return cudaErrorInvalidValue;
    const int grid = C::persistent && units > sms ? sms
                                                  : static_cast<int>(units);
    kern<<<grid, C::threads, C::smem_bytes, stream>>>(ma, mb, mc, m, n, kb,
                                                      epi);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(C::threads);
    cfg.dynamicSmemBytes = C::smem_bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // persistent: as many clusters as can be resident at once (an SM left
    // over in a GPC of odd size takes none), so that no cluster waits for
    // a place behind the others; asked once a device
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
    const long long clusters =
        C::persistent && units > resident ? resident : units;
    cfg.gridDim = dim3(static_cast<unsigned>(clusters * CL));
    e = cudaLaunchKernelEx(&cfg, kern, ma, mb, mc, m, n, kb, epi);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace vda
