// K3 and K4: fused temporal-transformer blocks over (BD, T, C) sequences.
//
// K3 (vda_temporal_block) replaces vda_tpu/ops/pallas_temporal.py
// temporal_block_fused (_block_kernel): a whole TemporalTransformerBlock,
//   2x (LN -> +APE -> qkv -> per-sequence attention -> out-proj -> residual)
//   then LN -> GEGLU feed-forward -> residual.
// K4 (vda_attention_block) replaces attention_block_fused (_attn_only_kernel):
// one attention sub-block, for the wide modules (C up to 1024).
//
// One block of 16 warps owns g whole sequences (rows = g*T, padded to 16) and
// keeps every intermediate in shared memory: the LayerNorm output, one head
// group's q/k/v, the (T, T) scores, the concatenated head outputs, and (K3)
// the residual stream, the fp32 feed-forward accumulator and 64 hidden
// columns of the GEGLU input at a time.  Rows are read from device memory
// once and written once.  Weights (torch (out, in) layout, in the working
// dtype, L2-resident) are streamed by each block into shared memory 64
// columns at a time with cp.async (gemm_rows); g is as large as shared
// memory allows so each weight byte serves more rows.  Projections: WMMA
// bf16 16x16x16 fragments with fp32 accumulation (scalar FMAs for fp32).
// Attention per head per sequence is scalar fp32: it is ~1% of the block's
// operations.  Rounding points follow the TPU kernel.
//
// Every shape the JAX gates admit is taken (C % 128 == 0, heads dividing C
// into widths that are multiples of 8, T <= 64).  Where even one sequence's
// buffers do not fit shared memory (fp32 at C=1024, bf16 at C=1024 with
// T > 32, or very wide heads), `plan` moves the largest buffers, in a fixed
// order, to a device-memory workspace with one slice a block; the caller asks
// vda_temporal_workspace for its size.  `plan` is the only description of
// the layout: the launch refuses what it cannot place.
//
// The entry points run these kernels for fp32 and for the bf16 shapes that
// the Hopper code does not take; vda_temporal_loop says which (90: the
// Hopper code, 80: the kernels here).  On the Hopper side, K3 at vitl's
// width (C = 256, 8 heads, T = 32) runs the fused kernel of
// temporal_fused_sm90.cuh (vda::TF90), every other shape the chain of
// temporal_sm90.cuh (vda::TB90 its products' configuration).  None stands
// in for another: a shape runs the code its loop names or the launch fails.

#include <cuda_pipeline.h>
#include <mma.h>

#include "common.cuh"
#include "temporal_fused_sm90.cuh"

namespace vda {
namespace {

using namespace nvcuda;

constexpr int NW = 16;  // warps per block
constexpr int NT = NW * 32;
constexpr int FC = 64;  // GEGLU hidden columns formed at a time
constexpr int KC = 64;  // weight columns (the K axis) staged at a time
constexpr int WLD = KC + 8;  // staged weight row stride (elements)
constexpr size_t SMEM_MAX = 232448;

// Output columns a GEMM pass covers: every warp owns one 16x16 tile.
__host__ __device__ inline int panel_width(int rows) {
  return (NW / (rows / 16)) * 16;
}

// bf16: two staged (panel_width x KC) weight chunks; they also serve, once
// a pass ends, as the warps' 16x16 fp32 epilogue tiles (all fp32 needs).
__host__ __device__ inline size_t stage_bytes(int rows, int t) {
  const size_t scr = static_cast<size_t>(NW) * 256 * 4;
  const size_t st = 2 * static_cast<size_t>(panel_width(rows)) * WLD * 2;
  return t == 2 && st > scr ? st : scr;
}

// Row stride (elements) of the tiles the products read as A operands: one
// 32-byte pad, so the 16 rows of a WMMA fragment spread over all banks.
__host__ __device__ inline int padded(int width, int t) {
  return width + 32 / t;
}

// Row stride (elements) of one head group's [q | k | v] rows and of the
// score rows: one 4-byte pad, so rows read by neighbouring threads fall in
// different banks.
__host__ __device__ inline int qkv_ld(int gw, int t) { return 3 * gw + 4 / t; }

// Heads one q/k/v product serves: their width must be a multiple of 16 (the
// WMMA tile); heads are a multiple of 8 wide.
__host__ __device__ inline int head_group(int dh) { return dh % 16 ? 2 : 1; }

// The buffers that may leave shared memory for the workspace: the residual
// stream (K3), the LayerNorm output, the head outputs, one head group's
// q/k/v and the feed-forward accumulator (K3).
enum Buf { HS, XS, OS, QKV, ACC, NBUF };

struct Layout {
  size_t off[NBUF];  // offset in shared memory, or in the block's slice
  unsigned spill;    // bit b set: buffer b lives in the workspace
  size_t s, z, scr, x12;  // always in shared memory
  size_t smem, ws;  // bytes of shared memory; of workspace a block
};

__host__ __device__ inline size_t take(size_t& off, size_t n) {
  const size_t o = off;
  off = align128(off + n);
  return o;
}

// Layout for `rows` rows of width c, head-group width gw, sequence length
// seq, element size t; `full` adds K3's feed-forward buffers and the
// resident residual stream.
__host__ __device__ inline Layout make_layout(int rows, int c, int gw, int seq,
                                              int t, bool full,
                                              unsigned spill) {
  Layout L{};
  L.spill = spill;
  size_t sm = 0, ws = 0;
  const size_t r = rows;
  auto place = [&](int b, size_t n) {
    L.off[b] = take((spill >> b) & 1 ? ws : sm, n);
  };
  if (full) place(HS, r * c * t);
  place(XS, r * padded(c, t) * t);
  place(OS, r * padded(c, t) * t);
  place(QKV, r * qkv_ld(gw, t) * t);
  L.s = take(sm, r * (seq + 1) * 4);
  L.z = take(sm, r * 4);
  L.scr = take(sm, stage_bytes(rows, t));
  if (full) {
    place(ACC, r * c * 4);
    L.x12 = take(sm, r * padded(2 * FC, t) * t);
  }
  L.smem = sm;
  L.ws = ws;
  return L;
}

struct Plan {
  int g;  // sequences a block owns
  Layout L;
};

// The most sequences (K3 up to 4, K4 one) whose buffers all fit shared
// memory; failing that one sequence, with buffers moved to the workspace in
// the order below until the rest fit.  False if the shape is not taken.
bool plan(int bd, int seq, int c, int heads, int t, bool full, Plan* out) {
  if (heads <= 0 || c % heads || bd < 1 || seq < 1 || seq > 64 || c % 128)
    return false;
  const int dh = c / heads;
  if (dh % 8 || (dh % 16 && heads % 2)) return false;
  const int gw = head_group(dh) * dh;
  for (int g = full ? 4 : 1; g >= 1; --g) {
    const Layout L = make_layout((g * seq + 15) / 16 * 16, c, gw, seq, t, full,
                                 0);
    if (L.smem <= SMEM_MAX) {
      *out = {g, L};
      return true;
    }
  }
  const int order[] = {OS, XS, HS, QKV, ACC};
  unsigned spill = 0;
  for (int b : order) {
    spill |= 1u << b;
    const Layout L =
        make_layout((seq + 15) / 16 * 16, c, gw, seq, t, full, spill);
    if (L.smem <= SMEM_MAX) {
      *out = {1, L};
      return true;
    }
  }
  return false;
}

size_t workspace_bytes(const Plan& pl, int bd) {
  return static_cast<size_t>((bd + pl.g - 1) / pl.g) * pl.L.ws;
}

struct AttnParams {
  const float* ln_w;
  const float* ln_b;
  const void* wq;  // (C, C) each
  const void* wk;
  const void* wv;
  const void* wout;  // (C, C)
  const float* bout;
};

struct Params {
  const void* h;
  void* out;
  const float* pe;  // (T, C) fp32
  AttnParams attn[2];
  const float* ffn_w;
  const float* ffn_b;
  const void* wproj;  // (8C, C): x1 rows then gate rows
  const float* bproj;
  const void* wffo;  // (C, 4C)
  const float* bffo;
  unsigned char* ws;  // workspace: L.ws bytes a block
  Layout L;
  int bd, seq, c, heads, g;
};

template <typename T>
struct Tile {
  int rows;     // padded to a multiple of 16
  int seqrows;  // g * seq
  int valid;    // rows holding real sequences
  int c, seq, heads, dh, hg, gw;
  int ldx;  // row stride of xs and os
  T *hs, *xs, *os, *qkv, *x12;
  float *s, *z, *acc;
  unsigned char* scr;  // weight stages / epilogue tiles
};

// Spill: some buffers live in the workspace.  Without it every tile pointer
// is derived from the shared-memory base alone, so the compiler emits
// shared-memory loads and stores for them (a pointer that may point to
// either space is generic, and slower).
template <typename T, bool Spill>
__device__ Tile<T> make_tile(const Params& p, unsigned char* smem) {
  Tile<T> t;
  t.c = p.c;
  t.seq = p.seq;
  t.heads = p.heads;
  t.dh = p.c / p.heads;
  t.hg = head_group(t.dh);
  t.gw = t.hg * t.dh;
  t.seqrows = p.g * p.seq;
  t.rows = (t.seqrows + 15) / 16 * 16;
  t.valid = min(p.g, p.bd - static_cast<int>(blockIdx.x) * p.g) * p.seq;
  t.ldx = padded(t.c, sizeof(T));
  const Layout& L = p.L;
  unsigned char* ws = p.ws + static_cast<size_t>(blockIdx.x) * L.ws;
  auto at = [&](int b) {
    if constexpr (Spill) return ((L.spill >> b) & 1 ? ws : smem) + L.off[b];
    return smem + L.off[b];
  };
  t.hs = reinterpret_cast<T*>(at(HS));
  t.xs = reinterpret_cast<T*>(at(XS));
  t.os = reinterpret_cast<T*>(at(OS));
  t.qkv = reinterpret_cast<T*>(at(QKV));
  t.acc = reinterpret_cast<float*>(at(ACC));
  t.s = reinterpret_cast<float*>(smem + L.s);
  t.z = reinterpret_cast<float*>(smem + L.z);
  t.scr = smem + L.scr;
  t.x12 = reinterpret_cast<T*>(smem + L.x12);
  return t;
}

// Y (rows x n) = A (rows x k, row stride lda; shared memory, or the
// workspace) times W^T, row j of W (k contiguous elements in device memory,
// 16-byte aligned) at wrow(j); k is a multiple of KC (C % 128 == 0,
// FC == 64).  epi(row, col, value) receives every fp32 result.  Called by
// all threads of the block.
//
// bf16: the output is covered in panels of panel_width(rows) columns, each
// warp owning one 16x16 tile of a panel.  All threads stage the panel's
// weights KC columns at a time into shared memory with cp.async, one chunk
// ahead of the tensor-core products (two buffers), so each weight byte is
// read from device memory once a block.  fp32 (tests) uses scalar FMAs.
template <typename T, typename WRow, typename Epi>
__device__ void gemm_rows(const T* a, int lda, const Tile<T>& tl, WRow wrow,
                          int n, int k, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nrt = tl.rows / 16;
  float* sw = reinterpret_cast<float*>(tl.scr) + warp * 256;
  if constexpr (sizeof(T) == 2) {
    const int np = panel_width(tl.rows), rt = warp % nrt, ct = warp / nrt;
    T* ws = reinterpret_cast<T*>(tl.scr);
    const int nk = k / KC;
    for (int n0 = 0; n0 < n; n0 += np) {
      const int pw = min(np, n - n0);
      const bool active = ct * 16 < pw;
      auto stage = [&](int kc) {
        T* dst = ws + (kc & 1) * np * WLD;
        for (int i = threadIdx.x; i < pw * (KC / 8); i += NT) {
          const int r = i / (KC / 8), c8 = (i % (KC / 8)) * 8;
          __pipeline_memcpy_async(dst + r * WLD + c8,
                                  wrow(n0 + r) + kc * KC + c8, 16);
        }
        __pipeline_commit();
      };
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      __syncthreads();  // the previous pass's epilogue tiles are read
      stage(0);
      for (int kc = 0; kc < nk; ++kc) {
        if (kc + 1 < nk) {
          stage(kc + 1);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();  // chunk kc is in shared memory for every thread
        if (active) {
          const T* wb = ws + (kc & 1) * np * WLD + ct * 16 * WLD;
          const T* at = a + rt * 16 * lda + kc * KC;
#pragma unroll
          for (int u = 0; u < KC / 16; ++u) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> fb;
            wmma::load_matrix_sync(fa, at + 16 * u, lda);
            wmma::load_matrix_sync(fb, wb + 16 * u, WLD);
            wmma::mma_sync(acc, fa, fb, acc);
          }
        }
        __syncthreads();  // chunk kc's buffer may be refilled
      }
      if (active) {  // the stages are free: they hold the epilogue tiles
        wmma::store_matrix_sync(sw, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int i = lane; i < 256; i += 32)
          epi(rt * 16 + i / 16, n0 + ct * 16 + i % 16, sw[i]);
        __syncwarp();
      }
    }
  } else {
    for (int t = warp; t < nrt * (n / 16); t += NW) {
      const int rt = t % nrt, ct = t / nrt;
      const T* at = a + rt * 16 * lda;
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const T* wr[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) wr[j] = wrow(ct * 16 + c0 + j);
      float acc[8] = {};
      for (int kk = 0; kk < k; ++kk) {
        const float x = at[r * lda + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(x, wr[j][kk], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sw[r * 16 + c0 + j] = acc[j];
      __syncwarp();
      for (int i = lane; i < 256; i += 32)
        epi(rt * 16 + i / 16, ct * 16 + i % 16, sw[i]);
      __syncwarp();
    }
  }
}

// xs = LN(src) (+ pe[row % seq]) over every tile row (src row stride c),
// eps 1e-5, fp32 statistics; one warp per row.  Rows past `valid` become
// zero.
template <typename T>
__device__ void layer_norm_rows(const T* src, const Tile<T>& tl,
                                const float* w, const float* b,
                                const float* pe) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, c = tl.c;
  for (int r = warp; r < tl.rows; r += NW) {
    T* d = tl.xs + r * tl.ldx;
    if (r >= tl.valid) {
      for (int j = lane; j < c; j += 32) d[j] = from_f<T>(0.f);
      continue;
    }
    const T* x = src + static_cast<size_t>(r) * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += to_f(x[j]);
    const float mean = warp_sum(s) / c;
    float v = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float e = to_f(x[j]) - mean;
      v += e * e;
    }
    const float rstd = rsqrtf(warp_sum(v) / c + 1e-5f);
    const float* per = pe ? pe + static_cast<size_t>(r % tl.seq) * c : nullptr;
    for (int j = lane; j < c; j += 32) {
      float y = round_t<T>((to_f(x[j]) - mean) * rstd * w[j] + b[j]);
      if (per) y += round_t<T>(per[j]);
      d[j] = from_f<T>(y);
    }
  }
}

// Attention of head hh of the current head group within each sequence:
// reads q/k/v from tl.qkv, writes columns ocol.. of tl.os.
template <typename T>
__device__ void head_attention(const Tile<T>& tl, int hh, int ocol,
                               float scale) {
  const int seq = tl.seq, dh = tl.dh, ld = qkv_ld(tl.gw, sizeof(T));
  const int sst = seq + 1;  // score row stride
  const T* q = tl.qkv + hh * dh;
  const T* k = tl.qkv + tl.gw + hh * dh;
  const T* v = tl.qkv + 2 * tl.gw + hh * dh;
  for (int i = threadIdx.x; i < tl.seqrows * seq; i += NT) {
    const int r = i / seq, kr = (r / seq) * seq + i % seq;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d)
      acc = fmaf(to_f(q[r * ld + d]), to_f(k[kr * ld + d]), acc);
    tl.s[r * sst + i % seq] = acc * scale;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < tl.seqrows; r += NT) {
    float* sr = tl.s + r * sst;
    float m = -INFINITY;
    for (int j = 0; j < seq; ++j) m = fmaxf(m, sr[j]);
    float z = 0.f;
    for (int j = 0; j < seq; ++j) {
      // bf16: exp of the bf16-rounded difference, rounded to bf16
      const float e = sizeof(T) == 2
                          ? round_t<T>(__expf(round_t<T>(sr[j] - m)))
                          : expf(sr[j] - m);
      sr[j] = e;
      z += e;
    }
    tl.z[r] = z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tl.seqrows * dh; i += NT) {
    const int r = i / dh, d = i % dh, kr0 = (r / seq) * seq;
    const float* pr = tl.s + r * sst;
    float acc = 0.f;
    for (int j = 0; j < seq; ++j)
      acc = fmaf(pr[j], to_f(v[(kr0 + j) * ld + d]), acc);
    tl.os[r * tl.ldx + ocol + d] = from_f<T>(acc / tl.z[r]);
  }
  __syncthreads();
}

// hdst = hsrc + out-proj(attention(LN(hsrc) + pe)); hsrc/hdst may be
// shared memory (K3, in place) or device memory (K4).
template <typename T>
__device__ void attention_subblock(const T* hsrc, T* hdst, const Tile<T>& tl,
                                   const AttnParams& p, const float* pe) {
  const int c = tl.c;
  layer_norm_rows<T>(hsrc, tl, p.ln_w, p.ln_b, pe);
  __syncthreads();
  const T* wq = static_cast<const T*>(p.wq);
  const T* wk = static_cast<const T*>(p.wk);
  const T* wv = static_cast<const T*>(p.wv);
  const float scale = 1.f / sqrtf(static_cast<float>(tl.dh));
  const int ld = qkv_ld(tl.gw, sizeof(T)), gw = tl.gw;
  T* qkv = tl.qkv;
  for (int h0 = 0; h0 < tl.heads; h0 += tl.hg) {
    const int col0 = h0 * tl.dh;
    // q, k and v of this head group: gw rows each of to_q, to_k, to_v
    gemm_rows<T>(
        tl.xs, tl.ldx, tl,
        [&](int j) {
          const int part = (j >= gw) + (j >= 2 * gw);
          const T* w = part == 0 ? wq : part == 1 ? wk : wv;
          return w + static_cast<size_t>(col0 + j - part * gw) * c;
        },
        3 * gw, c,
        [&](int r, int j, float val) { qkv[r * ld + j] = from_f<T>(val); });
    __syncthreads();
    for (int hh = 0; hh < tl.hg; ++hh)
      head_attention<T>(tl, hh, col0 + hh * tl.dh, scale);
  }
  const float* bout = p.bout;
  const T* wout = static_cast<const T*>(p.wout);
  const int valid = tl.valid;
  gemm_rows<T>(tl.os, tl.ldx, tl,
               [&](int j) { return wout + static_cast<size_t>(j) * c; }, c, c,
               [&](int r, int j, float val) {
                 if (r < valid) {
                   const size_t i = static_cast<size_t>(r) * c + j;
                   hdst[i] = from_f<T>(to_f(hsrc[i]) +
                                       round_t<T>(val + bout[j]));
                 }
               });
  __syncthreads();
}

template <typename T, bool Spill>
__global__ void __launch_bounds__(NT) attention_block_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T> tl = make_tile<T, Spill>(p, smem);
  const size_t off = static_cast<size_t>(blockIdx.x) * p.g * p.seq * p.c;
  attention_subblock<T>(static_cast<const T*>(p.h) + off,
                        static_cast<T*>(p.out) + off, tl, p.attn[0], p.pe);
}

template <typename T, bool Spill>
__global__ void __launch_bounds__(NT) temporal_block_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T> tl = make_tile<T, Spill>(p, smem);
  const int c = tl.c, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t off = static_cast<size_t>(blockIdx.x) * p.g * p.seq * c;
  const T* h = static_cast<const T*>(p.h) + off;
  T* out = static_cast<T*>(p.out) + off;

  for (int r = warp; r < tl.rows; r += NW) {
    if (r < tl.valid)
      copy_row(tl.hs + r * c, h + static_cast<size_t>(r) * c, c, lane, 32);
    else
      zero_row(tl.hs + r * c, c, lane, 32);
  }
  __syncthreads();
  attention_subblock<T>(tl.hs, tl.hs, tl, p.attn[0], p.pe);
  attention_subblock<T>(tl.hs, tl.hs, tl, p.attn[1], p.pe);

  // GEGLU feed-forward, 64 hidden columns at a time
  layer_norm_rows<T>(tl.hs, tl, p.ffn_w, p.ffn_b, nullptr);
  for (int i = threadIdx.x; i < tl.rows * c; i += NT) tl.acc[i] = 0.f;
  __syncthreads();
  const T* wproj = static_cast<const T*>(p.wproj);
  const T* wffo = static_cast<const T*>(p.wffo);
  const float* bproj = p.bproj;
  float* acc = tl.acc;
  const int hidden = 4 * c, ld12 = padded(2 * FC, sizeof(T));
  for (int j0 = 0; j0 < hidden; j0 += FC) {
    for (int part = 0; part < 2; ++part) {  // x1 columns, then the gate's
      const int w0 = part * hidden + j0;
      T* dst = tl.x12 + part * FC;
      gemm_rows<T>(
          tl.xs, tl.ldx, tl,
          [&](int j) { return wproj + static_cast<size_t>(w0 + j) * c; }, FC,
          c, [&](int r, int j, float val) {
            dst[r * ld12 + j] = from_f<T>(val + bproj[w0 + j]);
          });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tl.rows * FC; i += NT) {
      T* x = tl.x12 + (i / FC) * ld12;
      const int j = i % FC;
      const float gt = to_f(x[FC + j]);
      float g;
      if constexpr (sizeof(T) == 2)  // tanh GELU in bf16
        g = 0.5f * gt *
            (1.f + tanhf(0.7978845608028654f * (gt + 0.044715f * gt * gt * gt)));
      else  // exact erf GELU in fp32
        g = 0.5f * gt * (1.f + erff(gt * 0.7071067811865476f));
      x[j] = from_f<T>(to_f(x[j]) * round_t<T>(g));
    }
    __syncthreads();
    gemm_rows<T>(
        tl.x12, ld12, tl,
        [&](int j) { return wffo + static_cast<size_t>(j) * hidden + j0; }, c,
        FC, [&](int r, int j, float val) { acc[r * c + j] += val; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tl.valid * c; i += NT)
    out[i] = from_f<T>(to_f(tl.hs[i]) + round_t<T>(acc[i] + p.bffo[i % c]));
}

template <typename T>
cudaError_t launch(const Params& p, bool full, cudaStream_t stream) {
  void (*kern)(Params) =
      full ? (p.L.spill ? temporal_block_kernel<T, true>
                        : temporal_block_kernel<T, false>)
           : (p.L.spill ? attention_block_kernel<T, true>
                        : attention_block_kernel<T, false>);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.L.smem));
  if (e != cudaSuccess) return e;
  kern<<<(p.bd + p.g - 1) / p.g, NT, p.L.smem, stream>>>(p);
  return cudaGetLastError();
}

// Plans the launch; refuses a shape `plan` does not take and a workspace
// smaller than the plan needs.
cudaError_t run(Params p, bool full, int is_bf16, unsigned long long ws_bytes,
                void* stream) {
  Plan pl;
  if (!plan(p.bd, p.seq, p.c, p.heads, is_bf16 ? 2 : 4, full, &pl) ||
      ws_bytes < workspace_bytes(pl, p.bd) || (pl.L.ws && !p.ws))
    return cudaErrorInvalidValue;
  p.g = pl.g;
  p.L = pl.L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, full, st)
                 : launch<float>(p, full, st);
}

}  // namespace

cudaError_t temporal_sm80(const temporal::Args& a, bool full, int is_bf16,
                          cudaStream_t st) {
  Params p{};
  p.h = a.h;
  p.out = a.out;
  p.pe = a.pe;
  const size_t cc = static_cast<size_t>(a.c) * a.c * (is_bf16 ? 2 : 4);
  for (int i = 0; i < (full ? 2 : 1); ++i) {
    const auto& w = a.attn[i];
    const auto* q = static_cast<const unsigned char*>(w.wqkv);
    p.attn[i] = {w.ln_w, w.ln_b, q, q + cc, q + 2 * cc, w.wout, w.bout};
  }
  p.ffn_w = a.ffn_w;
  p.ffn_b = a.ffn_b;
  p.wproj = a.wproj;
  p.bproj = a.bproj;
  p.wffo = a.wffo;
  p.bffo = a.bffo;
  p.ws = static_cast<unsigned char*>(a.ws);
  p.bd = a.bd;
  p.seq = a.seq;
  p.c = a.c;
  p.heads = a.heads;
  return run(p, full, is_bf16, a.ws_bytes, st);
}

bool temporal_sm80_workspace(int bd, int seq, int c, int heads, int is_bf16,
                             bool full, unsigned long long* bytes) {
  Plan pl;
  if (!plan(bd, seq, c, heads, is_bf16 ? 2 : 4, full, &pl)) return false;
  *bytes = workspace_bytes(pl, bd);
  return true;
}

}  // namespace vda

// 90 where the entry points below run the Hopper chain (temporal_sm90.cuh:
// bf16, head widths a multiple of 16 up to 128, T <= 64; full = 1 for K3,
// which the JAX gate holds to C <= 512, 0 for K4, C <= 1024), else 80: the
// kernels of this file.
extern "C" int vda_temporal_loop(int c, int heads, int t, int is_bf16,
                                 int full) {
  return is_bf16 && heads > 0 && c % heads == 0 && (c / heads) % 16 == 0 &&
                 c / heads <= 128 && t >= 1 && t <= 64 && c % 128 == 0 &&
                 c <= 1024 >> full
             ? 90
             : 80;
}

// Bytes of device-memory workspace a launch of this shape needs (0 when
// every buffer of the kernels here fits shared memory); cudaErrorInvalidValue
// if it is not taken.  full: 1 for K3, 0 for K4.
extern "C" int vda_temporal_workspace(int bd, int seq, int c, int heads,
                                      int is_bf16, int full,
                                      unsigned long long* bytes) {
  if (bd < 1) return cudaErrorInvalidValue;
  if (vda_temporal_loop(c, heads, seq, is_bf16, full) == 90) {
    // the fused K3 keeps its intermediates in shared memory
    *bytes = full && vda::temporal_fused::takes(c, heads, seq)
                 ? 0
                 : vda::temporal::workspace_bytes(bd, seq, c, full != 0);
    return cudaSuccess;
  }
  return vda::temporal_sm80_workspace(bd, seq, c, heads, is_bf16, full != 0,
                                      bytes)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

namespace {

cudaError_t run_block(const vda::temporal::Args& a, bool full, int is_bf16,
                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (vda_temporal_loop(a.c, a.heads, a.seq, is_bf16, full) == 90) {
    if (full && vda::temporal_fused::takes(a.c, a.heads, a.seq))
      return vda::temporal_fused::launch<vda::TF90>(a, st);
    return full ? vda::temporal::temporal_block<vda::TB90>(a, st)
                : vda::temporal::attention_block<vda::TB90>(a, st);
  }
  return vda::temporal_sm80(a, full, is_bf16, st);
}

}  // namespace

// K4.  h, out (BD, T, C) and the weights in the working dtype, wqkv (3C, C)
// the rows of to_q, to_k and to_v; pe (T, C), the norm's and bout fp32.
extern "C" int vda_attention_block(
    const void* h, void* out, const float* pe, const float* ln_w,
    const float* ln_b, const void* wqkv, const void* wout, const float* bout,
    void* ws, unsigned long long ws_bytes, int bd, int seq, int c, int heads,
    int is_bf16, void* stream) {
  vda::temporal::Args a{};
  a.h = h;
  a.out = out;
  a.pe = pe;
  a.attn[0] = {ln_w, ln_b, wqkv, wout, bout};
  a.ws = ws;
  a.ws_bytes = ws_bytes;
  a.bd = bd;
  a.seq = seq;
  a.c = c;
  a.heads = heads;
  return run_block(a, false, is_bf16, stream);
}

// K3.  As K4, for both attention sub-blocks, then the feed-forward: wproj
// (8C, C) (x1's rows, then the gate's), wffo (C, 4C), their biases fp32.
extern "C" int vda_temporal_block(
    const void* h, void* out, const float* pe, const float* ln0_w,
    const float* ln0_b, const void* wqkv0, const void* wout0,
    const float* bout0, const float* ln1_w, const float* ln1_b,
    const void* wqkv1, const void* wout1, const float* bout1,
    const float* ffn_w, const float* ffn_b, const void* wproj,
    const float* bproj, const void* wffo, const float* bffo, void* ws,
    unsigned long long ws_bytes, int bd, int seq, int c, int heads,
    int is_bf16, void* stream) {
  vda::temporal::Args a{};
  a.h = h;
  a.out = out;
  a.pe = pe;
  a.attn[0] = {ln0_w, ln0_b, wqkv0, wout0, bout0};
  a.attn[1] = {ln1_w, ln1_b, wqkv1, wout1, bout1};
  a.ffn_w = ffn_w;
  a.ffn_b = ffn_b;
  a.wproj = wproj;
  a.bproj = bproj;
  a.wffo = wffo;
  a.bffo = bffo;
  a.ws = ws;
  a.ws_bytes = ws_bytes;
  a.bd = bd;
  a.seq = seq;
  a.c = c;
  a.heads = heads;
  return run_block(a, true, is_bf16, stream);
}
