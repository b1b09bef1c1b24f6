// K7: attention + out-projection + LayerScale + residual in one kernel,
//
//   out = x + gamma * (attn(q, k, v) @ W^T + bias)
//
// over the fused qkv projection (B, N, 3C), C = H*D: the whole first half of
// a pre-norm ViT block after norm1.  Replaces vda_tpu/ops/pallas_attention.py
// flash_attention_qkv_proj (_attn_proj_kernel).
//
// The device code is chosen by (dtype, head width) alone
// (vda_attention_proj_loop):
//   * bf16 at head width 64 (vits 384, vitb 768, vitl 1024: every shape the
//     model's gate admits in bf16): the Hopper kernel of
//     attention_heads_sm90.cuh (TMA, wgmma; a cluster pair of blocks on
//     each 64-row tile, each block's producer warpgroup and three consumer
//     warpgroups on half of the heads, the halves of the head-output tile
//     swapped between the two blocks' shared memory, the projection by
//     wgmma from it; vda::K7SM90, defined there, is its configuration);
//   * other head widths and fp32: the kernels below, on the mma.sync loop
//     of flash_attention.cuh.
//
// What bounds it on the H100: operations (vitl: 4*B*N^2*C of attention and
// 2*B*N*C^2 of projection, ~0.34 ms at the bf16 peak); what it saves is the
// (B, N, C) attention output's round trip through device memory between the
// attention and the projection, and the residual's extra pass.
//
// The out-projection contracts over every head, so one block owns one batch
// row and one 64-row query tile across all heads (the TPU kernel's single
// head group).  For each head it runs K1's flash loop (flash_attention.cuh)
// and writes the normalised head output, rounded to the working dtype as
// the TPU kernel does, into an output tile that holds every head.  Then it
// runs the projection from that tile: W (C, C), stored (out, in), is walked
// 64 output columns x 64 inputs at a time.
//
// bf16: the output tile (64 x C) lives in shared memory (132 KB at C=1024,
// padded rows); W chunks are double-buffered by cp.async into the space the
// attention tiles used, and the products run on mma.sync with fp32
// accumulators.  fp32: a 64 x 1024 fp32 tile (256 KB) is over the 227 KB a
// block may hold, so the head outputs go to a device-memory workspace
// (B, N, C) that the same block reads back, and the projection is scalar
// FMAs through shared memory.  The epilogue is x + gamma * (acc + bias) in
// fp32 with one rounding at the end.  N is unpadded: rows at or beyond N are
// computed from zero queries and never stored; keys at or beyond valid_len
// are masked.

#include "attention_heads_sm90.cuh"
#include "flash_attention.cuh"

namespace vda {
namespace {

using namespace flash;

constexpr int PN = 64;  // projection: output columns per tile
constexpr int PK = 64;  // projection: inputs per W chunk
constexpr int LDW = PK + 8;

__host__ __device__ constexpr int round64(int c) { return (c + 63) / 64 * 64; }

// bf16 shared memory: the head-output tile (64, round64(C) + 8), then the
// attention tiles, whose space the two W chunks (64, LDW) reuse.
template <int DP>
size_t bf16_bytes(int c) {
  const size_t tiles = Bf16Tiles<DP>::bytes > 2 * PN * LDW * sizeof(bf16)
                           ? Bf16Tiles<DP>::bytes
                           : 2 * PN * LDW * sizeof(bf16);
  return sizeof(bf16) * BQ * (round64(c) + 8) + tiles;
}

template <int DP>
__global__ void __launch_bounds__(NT)
    attention_proj_bf16_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ w,
                               const float* __restrict__ gb,
                               const bf16* __restrict__ x,
                               bf16* __restrict__ out, int n, int heads, int d,
                               int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = heads * d, cp = round64(c), ldo = cp + 8;
  bf16* os = reinterpret_cast<bf16*>(smem);  // (BQ, ldo)
  bf16* tiles = os + BQ * ldo;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t rs = 3 * static_cast<size_t>(c);
  const bf16* base = qkv + static_cast<size_t>(b) * n * rs;

  // columns C..cp of the tile enter the last W chunk's products: zero them
  for (int i = tid; i < BQ * (cp - c); i += NT)
    os[(i / (cp - c)) * ldo + c + i % (cp - c)] = __float2bfloat16(0.f);
  for (int h = 0; h < heads; ++h)
    attend_bf16<DP>(base + h * d, base + c + h * d, base + 2 * c + h * d, rs,
                    n, d, valid_len, scale, q0, tiles,
                    [&](int r, int col, float v0, float v1) {
                      *reinterpret_cast<__nv_bfloat162*>(
                          os + r * ldo + h * d + col) =
                          __floats2bfloat162_rn(v0, v1);
                    });
  __syncthreads();  // the tile holds every head; the attention tiles are free

  // 64 W rows (output columns col0..) x 64 inputs (k0..) into a chunk;
  // rows or inputs at or beyond C are zero-filled
  auto load_w = [&](bf16* dst, int col0, int k0) {
    for (int i = tid; i < PN * (PK / 8); i += NT) {
      const int r = i / (PK / 8), kk = (i % (PK / 8)) * 8;
      const bool ok = col0 + r < c && k0 + kk < c;
      const bf16* s =
          ok ? w + static_cast<size_t>(col0 + r) * c + k0 + kk : w;
      __pipeline_memcpy_async(dst + r * LDW + kk, s, 16, ok ? 0 : 16);
    }
  };
  const int n_chunks = cp / PK;
  const bf16* arow = os + warp * 16 * ldo;
  for (int col0 = 0; col0 < c; col0 += PN) {
    float acc[PN / 8][4];
#pragma unroll
    for (int j = 0; j < PN / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    load_w(tiles, col0, 0);
    __pipeline_commit();
    for (int kc = 0; kc < n_chunks; ++kc) {
      bf16* wb = tiles + (kc & 1) * PN * LDW;
      if (kc + 1 < n_chunks) {
        load_w(tiles + ((kc + 1) & 1) * PN * LDW, col0, (kc + 1) * PK);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk kc is in shared memory
#pragma unroll
      for (int kk = 0; kk < PK / 16; ++kk) {
        uint32_t af[4];
        load_a(af, arow, ldo, kc * PK + kk * 16, lane);
#pragma unroll
        for (int jj = 0; jj < PN / 16; ++jj) {
          uint32_t bfr[4];
          load_b(bfr, wb + jj * 16 * LDW, LDW, kk * 16, lane);
          mma_bf16(acc[2 * jj], af, bfr[0], bfr[1]);
          mma_bf16(acc[2 * jj + 1], af, bfr[2], bfr[3]);
        }
      }
      __syncthreads();  // every warp is done with chunk kc before refilling
    }
    // epilogue: rows g and g + 8 of this warp, columns 8j + 2t (+1)
#pragma unroll
    for (int j = 0; j < PN / 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (col >= c) continue;
      const float g0 = gb[col], g1 = gb[col + 1];
      const float b0 = gb[c + col], b1 = gb[c + col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row >= n) continue;
        const size_t at = (static_cast<size_t>(b) * n + row) * c + col;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + at));
        const float y0 =
            __fadd_rn(xv.x, __fmul_rn(g0, __fadd_rn(acc[j][2 * r], b0)));
        const float y1 =
            __fadd_rn(xv.y, __fmul_rn(g1, __fadd_rn(acc[j][2 * r + 1], b1)));
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

// fp32 projection tiles: A (64 rows x PK inputs) and W (PN x PK), each
// padded by 4 floats a row.
constexpr int LDP = PK + 4;
constexpr size_t F32_PROJ_BYTES = 2 * align128(sizeof(float) * 64 * LDP);

template <int DP>
constexpr size_t f32_bytes() {
  return F32Tiles<DP>::bytes > F32_PROJ_BYTES ? F32Tiles<DP>::bytes
                                              : F32_PROJ_BYTES;
}

template <int DP>
__global__ void __launch_bounds__(NT)
    attention_proj_f32_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ w,
                              const float* __restrict__ gb,
                              const float* __restrict__ x,
                              float* __restrict__ out, float* ws, int n,
                              int heads, int d, int valid_len, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = heads * d;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y, tid = threadIdx.x;
  const size_t rs = 3 * static_cast<size_t>(c);
  const float* base = qkv + static_cast<size_t>(b) * n * rs;
  float* wsb = ws + static_cast<size_t>(b) * n * c;  // this batch row's rows

  for (int h = 0; h < heads; ++h)
    attend_f32<DP>(base + h * d, base + c + h * d, base + 2 * c + h * d, rs, n,
                   d, valid_len, scale, q0, smem,
                   [&](int r, int col, float val) {
                     if (q0 + r < n)
                       wsb[static_cast<size_t>(q0 + r) * c + h * d + col] = val;
                   });
  // attend_f32 ends with a barrier: this block's workspace rows are
  // written and visible to all its threads

  float* as = reinterpret_cast<float*>(smem);
  float* wt = reinterpret_cast<float*>(smem + align128(sizeof(float) * 64 * LDP));
  const int r0 = (tid / 8) * 4, c0 = tid % 8;  // a 4x8 micro-tile
  for (int col0 = 0; col0 < c; col0 += PN) {
    float acc[4][8] = {};
    for (int k0 = 0; k0 < c; k0 += PK) {
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < 64 * (PK / 4); i += NT) {
        const int r = i / (PK / 4), kk = (i % (PK / 4)) * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 ww = a;
        if (q0 + r < n && k0 + kk < c)
          a = *reinterpret_cast<const float4*>(
              wsb + static_cast<size_t>(q0 + r) * c + k0 + kk);
        if (col0 + r < c && k0 + kk < c)
          ww = *reinterpret_cast<const float4*>(
              w + static_cast<size_t>(col0 + r) * c + k0 + kk);
        *reinterpret_cast<float4*>(as + r * LDP + kk) = a;
        *reinterpret_cast<float4*>(wt + r * LDP + kk) = ww;
      }
      __syncthreads();
      for (int kk = 0; kk < PK; ++kk) {
        float a[4], bb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(r0 + i) * LDP + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bb[j] = wt[(c0 + 8 * j) * LDP + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + c0 + 8 * j;
      if (col >= c) continue;
      const float gam = gb[col], bias = gb[c + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + r0 + i;
        if (row >= n) continue;
        const size_t at = (static_cast<size_t>(b) * n + row) * c + col;
        out[at] = __fadd_rn(x[at], __fmul_rn(gam, __fadd_rn(acc[i][j], bias)));
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* qkv, const void* w, const float* gb,
                   const void* x, void* out, void* ws, int b, int n, int heads,
                   int d, int valid_len, float scale, bool bf,
                   cudaStream_t stream) {
  const dim3 grid((n + BQ - 1) / BQ, b);
  cudaError_t e;
  if (bf) {
    const size_t bytes = bf16_bytes<DP>(heads * d);
    auto kern = attention_proj_bf16_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(w), gb,
        static_cast<const bf16*>(x), static_cast<bf16*>(out), n, heads, d,
        valid_len, scale);
  } else {
    constexpr size_t bytes = f32_bytes<DP>();
    auto kern = attention_proj_f32_kernel<DP>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(w), gb,
        static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(ws), n, heads, d, valid_len, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// The mma.sync kernel in bf16 at head width 64, which the Hopper kernel
// replaces there: the "mma_sync" step of attention_proj_sm90_variants.cu.
cudaError_t attention_proj_mma_sync(const void* qkv, const void* w,
                                    const float* gb, const void* x,
                                    void* out, int b, int n, int heads,
                                    int valid_len, float scale,
                                    cudaStream_t stream) {
  return launch<64>(qkv, w, gb, x, out, nullptr, b, n, heads, 64, valid_len,
                    scale, true, stream);
}

}  // namespace vda

// The device code vda_attention_proj runs for head width d: 90 (the Hopper
// kernel) for bf16 at d = 64, 80 (the mma.sync or fp32 kernels) otherwise.
extern "C" int vda_attention_proj_loop(int d, int is_bf16) {
  return is_bf16 && d == vda::sm90::D ? 90 : 80;
}

// qkv (B, N, 3C), x and out (B, N, C), w (C, C) (out, in), all contiguous in
// the working dtype and 16-byte aligned; gb (2, C) fp32 [gamma; bias]; ws a
// (B, N, C) fp32 workspace for fp32 (unused in bf16, may be null).
// C = heads * d <= 1024.  The Hopper kernel needs scale > 0.
extern "C" int vda_attention_proj(const void* qkv, const void* w,
                                  const float* gb, const void* x, void* out,
                                  void* ws, int b, int n, int heads, int d,
                                  int valid_len, float scale, int is_bf16,
                                  void* stream) {
  const bool bf = is_bf16 != 0;
  if (valid_len <= 0 || valid_len > n || heads * d > 1024 || (!bf && !ws))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (vda_attention_proj_loop(d, is_bf16) == 90) {
    const auto* q = static_cast<const __nv_bfloat16*>(qkv);
    const int c = heads * d;
    return vda::sm90::launch_heads<vda::K7SM90>(
        q, q + c, q + 2 * c, w, gb, x, out, b, n, heads, 3 * c, valid_len,
        scale, st);
  }
  switch (vda::flash::padded_width(d)) {
    case 16: return vda::launch<16>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 32: return vda::launch<32>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 48: return vda::launch<48>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 64: return vda::launch<64>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 80: return vda::launch<80>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 96: return vda::launch<96>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 112: return vda::launch<112>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    case 128: return vda::launch<128>(qkv, w, gb, x, out, ws, b, n, heads, d, valid_len, scale, bf, st);
    default: return cudaErrorInvalidValue;
  }
}
