// The Ampere-style mainloop that K11 and K13 ran before the Hopper loop of
// gemm_sm90.cuh replaced it: kept only as a variant of
// gemm_sm90_variants.cu, so that probes/bench_gemm_sm90.py and
// chip_smoke.py can time the two on the same values.  No wrapper reaches it.
//
// A 128 x 128 output tile a block of 8 warps (each 64 x 32), k in 64-byte
// stages that cp.async triple-buffers in shared memory, operands by
// ldmatrix, mma.sync m16n8k32 (int8, int32 sums) or m16n8k16 (bf16, fp32
// sums), one block a tile.  One mainloop for both element types: a k-step
// is 32 bytes of every row of A and of B, which is 32 int8 or 16 bf16
// values, and the two mma shapes read their fragments with the same byte
// layout, so only the mma instruction and the accumulator type differ.  B
// is taken as (N, K) row-major, the layout mma's ".col" operand wants.
// Shared-memory rows are 80 bytes apart, so the 8 rows an ldmatrix reads
// fall on 8 distinct 16-byte bank groups.  Ragged M and N are masked (loads
// zero-filled, stores skipped); K is taken in 16-byte chunks and a ragged
// last stage zero-filled.
#pragma once

#include <cuda_pipeline.h>

#include "gemm_epilogue.cuh"

namespace vda {
namespace gemm80 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128;  // output tile of a block
constexpr int BKB = 64;            // bytes of k a stage: two k-steps
constexpr int PITCH = BKB + 16;    // bytes between shared-memory rows
constexpr int STAGES = 3;
constexpr int THREADS = 256;  // 8 warps: 2 along m x 4 along n, 64 x 32 each
constexpr size_t STAGE_BYTES = static_cast<size_t>(BM + BN) * PITCH;
constexpr size_t SMEM_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

struct S8 {  // int8 x int8 -> int32: k 32 a step
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct BF16 {  // bf16 x bf16 -> fp32: k 16 a step
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// out tile (blockIdx.y, blockIdx.x) of A (M, kb bytes a row) times B^T, B
// given as (N, kb bytes a row), both row-major; epi(row, col, v, v') gets
// the sums of columns col and col + 1 (col even) of each row in range.
template <class Mma, class Epi>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(const unsigned char* __restrict__ a,
                const unsigned char* __restrict__ bt, int m, int n, int kb,
                Epi epi) {
  using Acc = typename Mma::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  // one stage: BM rows of A then BN rows of B, 4 chunks of 16 bytes a row;
  // rows out of range and chunks past kb are zero-filled
  auto load = [&](int stage, int k0) {
    unsigned char* sa = smem + stage * STAGE_BYTES;
    unsigned char* sb = sa + BM * PITCH;
#pragma unroll
    for (int i = tid; i < (BM + BN) * (BKB / 16); i += THREADS) {
      const int r = i / (BKB / 16), c = (i % (BKB / 16)) * 16;
      const bool is_a = r < BM;
      const int row = is_a ? m0 + r : n0 + r - BM;
      const bool ok = row < (is_a ? m : n) && k0 + c < kb;
      const unsigned char* src =
          ok ? (is_a ? a : bt) + static_cast<size_t>(row) * kb + k0 + c : a;
      __pipeline_memcpy_async((is_a ? sa + r * PITCH : sb + (r - BM) * PITCH) +
                                  c,
                              src, 16, ok ? 0 : 16);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (kb + BKB - 1) / BKB;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * BKB);
    __pipeline_commit();
  }
  // ldmatrix row and byte offsets of this lane (flash_attention.cuh's
  // load_a / load_b in bytes)
  const int a_row = ((lane / 8) % 2) * 8 + lane % 8, a_col = (lane / 16) * 16;
  const int b_row = (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 16;
  for (int kt = 0; kt < ktiles; ++kt) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();  // stage kt is in; every warp is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < ktiles) load(nk % STAGES, nk * BKB);
    __pipeline_commit();
    const unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* sb = sa + BM * PITCH;
#pragma unroll
    for (int ks = 0; ks < BKB; ks += 32) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], sa + (wm + i * 16 + a_row) * PITCH + ks + a_col);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(bfr[j], sb + (wn + j * 16 + b_row) * PITCH + ks + b_col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Mma::mma(acc[i][j], af[i], bfr[j / 2][(j % 2) * 2],
                   bfr[j / 2][(j % 2) * 2 + 1]);
    }
  }
  __pipeline_wait_prior(0);

  // fragment (i, j): rows g and g + 8 of m-tile i, columns 2t, 2t + 1 of
  // n-tile j
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + g + 8 * h;
        if (row < m)
          gemm::store_pair(epi, row, col, acc[i][j][2 * h],
                           acc[i][j][2 * h + 1]);
      }
    }
}

template <class Mma, class Epi>
cudaError_t launch(const void* a, const void* bt, int m, int n, int kb,
                   Epi epi, cudaStream_t stream) {
  if ((m + BM - 1) / BM > 65535) return cudaErrorInvalidValue;  // grid rows
  auto kern = gemm_kernel<Mma, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return e;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(bt), m, n, kb, epi);
  return cudaGetLastError();
}

}  // namespace gemm80
}  // namespace vda
