// K3 and K4 on Hopper (sm_90a): the temporal-transformer block (K3) and its
// attention sub-block (K4) in bf16 at head widths that are multiples of 16
// up to 128 and T <= 64 (vda_temporal_loop in temporal_block.cu says which
// shapes; the rest keep the kernels of temporal_block.cu).
//
// K4 replaces vda_tpu/ops/pallas_temporal.py attention_block_fused
// (_attn_only_kernel), K3 temporal_block_fused (_block_kernel); both run
// _attention, one LN -> +APE -> qkv -> per-sequence attention -> out-proj
// -> residual sub-block, K3 twice and then LN -> GEGLU feed-forward ->
// residual.
//
// What bounds them on the H100.  vitl's mm0 K4 at (1369, 32, 1024): 0.37 ms
// of products at the bf16 peak against ~0.18 GB of h in and out; mm3's K3
// at (5476, 32, 256): 0.47 ms of products.  The kernels these replace kept
// every intermediate in shared memory, so each block streamed the whole
// weight set from L2 for 32-64 rows (8 MB for 32 rows at C = 1024) through
// one-chunk-ahead cp.async stages into wmma products: bound by the latency
// of that stream, at ~1.7 and ~0.65 TB/s of L2 reads.  Here a block is a
// stage of a chain, each on the tool that suits it:
//
//   1. LN + APE (ln_ape_kernel): one warp a row, 16-byte accesses, the
//      statistics in fp32, writing hn in bf16;
//   2. the qkv product hn (M, C) x W_qkv^T (3C, C) on the Hopper GEMM
//      mainloop of K11/K13 (gemm_sm90.cuh: TMA stages, two wgmma consumer
//      warpgroups, a persistent grid of cluster pairs sharing each weight
//      tile by multicast; W read from L2 once per 256 rows, not per 32);
//   3. the per-sequence attention (seq_attention_kernel): a block a
//      sequence and a head, q, k and v staged by cp.async, S = q k^T and
//      O = P v by mma.sync m16n8k16 on the tensor cores (a 32 x 32 score
//      tile is too small for a wgmma's 64 rows); bound by the bytes of qkv;
//   4. the out-projection on the same mainloop, its epilogue adding bias
//      and residual (gemm_epilogue.cuh Residual);
//   K3 then: the LN pass again, the GEGLU product (x1 and gate of one chunk
//   of hidden columns in one tile, combined in the epilogue: Geglu) and the
//   feed-forward product with the residual epilogue.
//
// The intermediates make round trips through device memory (hn, qkv, o:
// ~0.9 GB at mm0; K3 at mm3 ~3.5 GB in all), which fusion would save; a
// 64-row tile's LN output and head outputs at C = 1024 (128 KB each) do not
// fit one block's shared memory beside a weight ring.
//
// Rounding is the TPU kernel's (pallas_temporal.py): LayerNorm statistics
// in fp32, eps 1e-5; the APE added after the norm in bf16; every product's
// fp32 sums rounded to bf16 (plus the bias first where there is one); the
// softmax exp in bf16 of the bf16-rounded difference, its row sum in fp32
// and the division deferred to the (rows, dh) output; tanh GELU in bf16.
//
// The chain's launches all go through one entry point call (vda_attention_
// block, vda_temporal_block); the intermediates live in a device-memory
// workspace the caller allocates (workspace_bytes).  The stage kernels and
// the epilogues carry TemporalK3 or TemporalK4 in their type, so that a
// profile counts each launch under its kernel.
#pragma once

#include <math.h>

#include <cuda_pipeline.h>

#include "flash_attention.cuh"
#include "gemm_sm90.cuh"

namespace vda {
namespace temporal {

using bf16 = __nv_bfloat16;
using gemm::TemporalK3;
using gemm::TemporalK4;

struct AttnWeights {
  const float* ln_w;  // (C,) fp32
  const float* ln_b;
  const void* wqkv;  // (3C, C): to_q's rows, to_k's, to_v's
  const void* wout;  // (C, C)
  const float* bout;  // (C,) fp32
};

// One launch's operands: h and out (BD, T, C), pe (T, C) fp32; K4 reads
// attn[0] alone, K3 everything.  Weights are (out, in) as stored.
struct Args {
  const void* h;
  void* out;
  const float* pe;
  AttnWeights attn[2];
  const float* ffn_w;
  const float* ffn_b;
  const void* wproj;  // (8C, C): x1's rows, then the gate's
  const float* bproj;  // (8C,)
  const void* wffo;   // (C, 4C)
  const float* bffo;  // (C,)
  void* ws;
  unsigned long long ws_bytes;
  int bd, seq, c, heads;
};

// The shapes this code takes: bf16, head widths a multiple of 16 up to 128
// (the mma.sync k-step; the attention's registers), T <= 64 (four 16-row
// tiles a sequence), C % 128 == 0 and C <= 1024 (the LN pass's registers).
inline bool takes(int c, int heads, int t) {
  return heads > 0 && c % heads == 0 && (c / heads) % 16 == 0 &&
         c / heads <= 128 && t >= 1 && t <= 64 && c % 128 == 0 && c <= 1024;
}

// Workspace of the chain: hn, reused for the head outputs (M, C); qkv (M,
// 3C), and in K3 the GEGLU output (M, 4C) in the same place; K3's residual
// stream after its first sub-block (M, C).  bf16.
inline size_t workspace_bytes(int bd, int seq, int c, bool full) {
  const size_t mc = static_cast<size_t>(bd) * seq * c * sizeof(bf16);
  return full ? 6 * mc : 4 * mc;
}

// ---- stage 1: LayerNorm (+ APE) ----

constexpr int LN_ROWS = 8;  // rows a block, one warp each

// y = bf16(LN(x) * w + b) (+ bf16(pe[row % seq]), the sum rounded to bf16)
// over m rows of c columns (a multiple of 8, at most 256 NV); each lane
// holds NV 16-byte vectors of its row.
template <class Tag, int NV>
__global__ void __launch_bounds__(32 * LN_ROWS)
    ln_ape_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                  const float* __restrict__ w, const float* __restrict__ b,
                  const float* __restrict__ pe, int m, int c, int seq) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + warp;
  if (row >= m) return;
  const bf16* xr = x + static_cast<size_t>(row) * c;
  float v[NV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col < c) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + col);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[i][2 * e] = f.x;
        v[i][2 * e + 1] = f.y;
        s += f.x + f.y;
      }
    }
  }
  const float mean = warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if ((i * 32 + lane) * 8 < c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
  const float rstd = rsqrtf(warp_sum(q) / c + 1e-5f);
  const float* per = pe ? pe + static_cast<size_t>(row % seq) * c : nullptr;
  bf16* yr = y + static_cast<size_t>(row) * c;
  // 16-byte reads of the fp32 parameters: 8 a lane's vector
  auto load8 = [](const float* p, float (&d)[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 z = __ldg(reinterpret_cast<const float4*>(p) + 1);
    d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
    d[4] = z.x, d[5] = z.y, d[6] = z.z, d[7] = z.w;
  };
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int col = (i * 32 + lane) * 8;
    if (col >= c) continue;
    float o[8], wv[8], bv[8], pv[8];
    load8(w + col, wv);
    load8(b + col, bv);
    if (per) load8(per + col, pv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = __bfloat162float(__float2bfloat16_rn(
          (v[i][e] - mean) * rstd * wv[e] + bv[e]));
      if (per) o[e] += __bfloat162float(__float2bfloat16_rn(pv[e]));
    }
    uint4 u;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
    *reinterpret_cast<uint4*>(yr + col) = u;
  }
}

template <class Tag>
cudaError_t launch_ln(const bf16* x, bf16* y, const float* w, const float* b,
                      const float* pe, int m, int c, int seq,
                      cudaStream_t st) {
  if (m <= 0 || c % 8 || c > 1024 || seq <= 0) return cudaErrorInvalidValue;
  const dim3 grid((m + LN_ROWS - 1) / LN_ROWS), block(32 * LN_ROWS);
  switch ((c / 8 + 31) / 32) {
    case 1: ln_ape_kernel<Tag, 1><<<grid, block, 0, st>>>(x, y, w, b, pe, m, c, seq); break;
    case 2: ln_ape_kernel<Tag, 2><<<grid, block, 0, st>>>(x, y, w, b, pe, m, c, seq); break;
    case 3: ln_ape_kernel<Tag, 3><<<grid, block, 0, st>>>(x, y, w, b, pe, m, c, seq); break;
    case 4: ln_ape_kernel<Tag, 4><<<grid, block, 0, st>>>(x, y, w, b, pe, m, c, seq); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- stage 3: the per-sequence attention ----

// Attention of one sequence (seq <= 64 rows) and one head of width DH over
// qkv (BD * seq, 3C) = [q | k | v], into o (BD * seq, C) at the head's
// columns.  A block has seq / 16 warps (rounded up), each 16 query rows
// against every key: S (16 x 64 at most) stays in registers, its C
// fragments become P's A fragments in bf16 as they are (the flash loop's
// layout, flash_attention.cuh).  Rows past seq are zero in shared memory
// and masked as keys.  Small blocks (64 threads and 8-26 KB at T = 32)
// keep many sequences' loads in flight on an SM: blocks of all 8 heads of
// a sequence (a row's q, k and v in one read, 61 KB at C = 256) were
// slower, 0.250 ms against 0.171 at vitl's mm3 (PERF.md, section 6).
template <class Tag, int DH>
__global__ void __launch_bounds__(128)
    seq_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                         int seq, int c, int heads, float scale) {
  using flash::ldmatrix_x4;
  using flash::load_a;
  using flash::load_b;
  using flash::mma_bf16;
  using flash::pack;
  constexpr int LD = DH + 8;  // padded rows: 8 rows an ldmatrix reads hit
                              // 8 groups of 4 banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int tp = (seq + 15) / 16 * 16;
  const int head = blockIdx.x % heads, sq = blockIdx.x / heads;
  const size_t row0 = static_cast<size_t>(sq) * seq;

  // q, k, v of the head: 3 x tp rows of DH / 8 16-byte chunks
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < 3 * tp * CH; i += blockDim.x) {
    const int part = i / (tp * CH), r = (i / CH) % tp, ch = i % CH;
    bf16* dst = sm + (part * tp + r) * LD + ch * 8;
    if (r < seq)
      __pipeline_memcpy_async(
          dst, qkv + (row0 + r) * 3 * c + part * c + head * DH + ch * 8, 16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* sq_ = sm + warp * 16 * LD;
  const bf16* sk = sm + tp * LD;
  const bf16* sv = sm + 2 * tp * LD;

  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) load_a(qf[kk], sq_, LD, kk * 16, lane);

  // S = q k^T over up to 64 keys: 8 n-tiles of 8 keys
  float s[8][4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * jj][e] = s[2 * jj + 1][e] = 0.f;
    if (jj * 16 < tp)
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t kb[4];
        load_b(kb, sk + jj * 16 * LD, LD, kk * 16, lane);
        mma_bf16(s[2 * jj], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
      }
  }
  // rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp's 16; keys 8j + 2t
  // + (e & 1)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      s[j][e] = key < seq ? s[j][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  // e = bf16(exp(bf16(s - m))), z its fp32 row sum; P's A fragments
  float z[2] = {0.f, 0.f};
  uint32_t pf[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bf16 p[4];  // keys at or past seq: exp(-inf) = 0
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d =
          __bfloat162float(__float2bfloat16_rn(s[j][e] - mx[e >> 1]));
      p[e] = __float2bfloat16_rn(expf(d));
      z[e >> 1] += __bfloat162float(p[e]);
    }
    pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);      // row g
    pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);  // row g + 8
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
    z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
  }
  // O (16, DH) = P V, V read transposed by ldmatrix
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk * 16 >= tp) continue;
#pragma unroll
    for (int jd = 0; jd < DH / 16; ++jd) {
      uint32_t vf[4];
      ldmatrix_x4(vf,
                  sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                      jd * 16 + (lane / 16) * 8,
                  true);
      mma_bf16(acc[2 * jd], pf[kk], vf[0], vf[1]);
      mma_bf16(acc[2 * jd + 1], pf[kk], vf[2], vf[3]);
    }
  }
  // o = bf16(O / z)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= seq) continue;
    bf16* dst = o + (row0 + row) * c + head * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] / z[r], acc[j][2 * r + 1] / z[r]);
  }
}

template <class Tag, int DH>
cudaError_t launch_attention_dh(const bf16* qkv, bf16* o, int bd, int seq,
                                int c, int heads, float scale,
                                cudaStream_t st) {
  const int tp = (seq + 15) / 16 * 16;
  const int smem = 3 * tp * (DH + 8) * static_cast<int>(sizeof(bf16));
  auto kern = seq_attention_kernel<Tag, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<bd * heads, 2 * tp, smem, st>>>(qkv, o, seq, c, heads, scale);
  return cudaGetLastError();
}
template <class Tag>
cudaError_t launch_attention(const bf16* qkv, bf16* o, int bd, int seq,
                             int c, int heads, cudaStream_t st) {
  if (bd <= 0 || !takes(c, heads, seq) ||
      static_cast<long long>(bd) * heads > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int dh = c / heads;
  const float scale = 1.f / sqrtf(static_cast<float>(dh));
  switch (dh) {
    case 16: return launch_attention_dh<Tag, 16>(qkv, o, bd, seq, c, heads, scale, st);
    case 32: return launch_attention_dh<Tag, 32>(qkv, o, bd, seq, c, heads, scale, st);
    case 48: return launch_attention_dh<Tag, 48>(qkv, o, bd, seq, c, heads, scale, st);
    case 64: return launch_attention_dh<Tag, 64>(qkv, o, bd, seq, c, heads, scale, st);
    case 80: return launch_attention_dh<Tag, 80>(qkv, o, bd, seq, c, heads, scale, st);
    case 96: return launch_attention_dh<Tag, 96>(qkv, o, bd, seq, c, heads, scale, st);
    case 112: return launch_attention_dh<Tag, 112>(qkv, o, bd, seq, c, heads, scale, st);
    case 128: return launch_attention_dh<Tag, 128>(qkv, o, bd, seq, c, heads, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- stages 2 and 4: the products ----

// out (M, N, or N / 2 paired) = epi(a (M, K) x bt (N, K)^T), bf16 operands
template <class G, class Epi>
cudaError_t product(const void* a, const void* bt, int m, int n, int k,
                    Epi epi, cudaStream_t st) {
  if (!gemm::shape_ok(m, n, k, 2)) return cudaErrorInvalidValue;
  return gemm90::launch<G, gemm90::BF16>(a, bt, m, n, k * 2, epi, st);
}

// ---- the chains ----

// out = h + out-proj(attention(LN(h) + pe)) over bd sequences; hn (M, C)
// and qkv (M, 3C) are workspace.  out may not be h.
template <class Tag, class G>
cudaError_t attention_sub(const bf16* h, bf16* out, const float* pe,
                          const AttnWeights& w, bf16* hn, bf16* qkv, int bd,
                          int seq, int c, int heads, cudaStream_t st) {
  const int m = bd * seq;
  cudaError_t e = launch_ln<Tag>(h, hn, w.ln_w, w.ln_b, pe, m, c, seq, st);
  if (e == cudaSuccess)
    e = product<G>(hn, w.wqkv, m, 3 * c, c,
                   gemm::QkvStore<Tag>{qkv, 3 * c}, st);
  if (e == cudaSuccess)  // the head outputs overwrite hn
    e = launch_attention<Tag>(qkv, hn, bd, seq, c, heads, st);
  if (e == cudaSuccess)
    e = product<G>(hn, w.wout, m, c, c,
                   gemm::Residual<Tag>{h, w.bout, out, c}, st);
  return e;
}

// K4 with the products on configuration G.
template <class G>
cudaError_t attention_block(const Args& a, cudaStream_t st) {
  if (!takes(a.c, a.heads, a.seq) || a.bd <= 0 ||
      static_cast<long long>(a.bd) * a.seq > 0x7fffffff || a.ws == nullptr ||
      a.ws_bytes < workspace_bytes(a.bd, a.seq, a.c, false))
    return cudaErrorInvalidValue;
  const size_t mc = static_cast<size_t>(a.bd) * a.seq * a.c;
  bf16* hn = static_cast<bf16*>(a.ws);
  return attention_sub<TemporalK4, G>(static_cast<const bf16*>(a.h),
                                      static_cast<bf16*>(a.out), a.pe,
                                      a.attn[0], hn, hn + mc, a.bd, a.seq,
                                      a.c, a.heads, st);
}

// K3 with the products on configuration G: the first sub-block into the
// workspace, the second into out, the feed-forward's residual in place.
template <class G>
cudaError_t temporal_block(const Args& a, cudaStream_t st) {
  if (!takes(a.c, a.heads, a.seq) || a.c > 512 || a.bd <= 0 ||
      static_cast<long long>(a.bd) * a.seq > 0x7fffffff || a.ws == nullptr ||
      a.ws_bytes < workspace_bytes(a.bd, a.seq, a.c, true))
    return cudaErrorInvalidValue;
  const int m = a.bd * a.seq, c = a.c;
  const size_t mc = static_cast<size_t>(m) * c;
  bf16* hn = static_cast<bf16*>(a.ws);
  bf16* big = hn + mc;     // qkv (M, 3C), then the GEGLU output (M, 4C)
  bf16* h1 = big + 4 * mc;
  bf16* out = static_cast<bf16*>(a.out);
  using Tag = TemporalK3;
  cudaError_t e = attention_sub<Tag, G>(static_cast<const bf16*>(a.h), h1,
                                        a.pe, a.attn[0], hn, big, a.bd,
                                        a.seq, c, a.heads, st);
  if (e == cudaSuccess)
    e = attention_sub<Tag, G>(h1, out, a.pe, a.attn[1], hn, big, a.bd, a.seq,
                              c, a.heads, st);
  if (e == cudaSuccess)
    e = launch_ln<Tag>(out, hn, a.ffn_w, a.ffn_b, nullptr, m, c, a.seq, st);
  if (e == cudaSuccess)
    e = product<G>(hn, a.wproj, m, 8 * c, c,
                   gemm::Geglu<Tag>{a.bproj, big, 4 * c}, st);
  if (e == cudaSuccess)
    e = product<G>(big, a.wffo, m, c, 4 * c,
                   gemm::Residual<Tag>{out, a.bffo, out, c}, st);
  return e;
}

}  // namespace temporal

// The products of the Hopper chain: K13's configuration (int8_matmul.cu
// GEMM90: 128 x 256 tiles, 4 stages, TMA-store epilogue, persistent
// cluster pairs), the fastest of probes/bench_temporal_sm90.py's steps.
using TB90 = gemm90::Config<128, 256, 4, true, 2, gemm90::Mode::kFull, 2>;

// The kernels of temporal_block.cu that these replace, for the shapes
// routed here too (vda_temporal_variant's "sm80" step): defined there.
cudaError_t temporal_sm80(const temporal::Args& a, bool full, int is_bf16,
                          cudaStream_t st);
bool temporal_sm80_workspace(int bd, int seq, int c, int heads, int is_bf16,
                             bool full, unsigned long long* bytes);

}  // namespace vda
