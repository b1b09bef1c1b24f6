// K6's Hopper loop: one new frame's attention over a cached context, bf16,
// head widths a multiple of 8 up to 128 (vitl's 128 at C 1024 and 32 at C
// 256, and the vitb/vits widths).  The function and its rounding are those
// of stream_kv_attention.cu (and of ops/stream_kernel.py's twin): the
// encoding add rounded to bf16, fp32 products, exp of the bf16-rounded
// shifted score rounded to bf16, an fp32 sum, one division at the output.
//
// What bounds it on the H100: bytes.  A position's context is 2 x rows x C
// values, each used in one product (about one operation a byte), so the
// card can do nothing faster than read it once.  The design keeps loads in
// flight on every SM and little else in their way:
//  * A warp owns one (position, head) at a time.  A row of the head is
//    dh / 8 lanes of 16 bytes (LP lanes, the next power of two), so one
//    load instruction covers 32 / LP rows and a 32-row chunk of K (or V)
//    is LP loads a lane, all issued at once.  At head widths above 64 the
//    chunk of V is loaded after its scores (8 KB in flight a warp at dh
//    128): loaded beside K it doubled the registers (168, spilling) and
//    left 3 blocks of 4 warps an SM, and the loop ran ~29% slower at C
//    1024; at dh 32 K and V load together (4 KB a warp), 1-4% faster than
//    apart.  Rows that are not valid are never read.
//  * Blocks are persistent (as many as fit on the card) and each owns a
//    range of heads: that range's pe_k and pe_v rows, the same for every
//    position, are staged in shared memory once (16 KB a block: one head at
//    C 1024, four at C 256) and read from there.
//  * Scores: each lane's 8-column partial dot, reduced over its LP lanes
//    by shuffles, written to the warp's score row in shared memory; the
//    softmax over the row by warp shuffles; the weighted sum a lane's 8
//    columns in fp32 over its rows, reduced over the row groups by
//    shuffles, one division, 16-byte stores.
// No tensor core: at one operation a byte they would wait like the FMAs.
// Any row count runs, a 32-row chunk at a time (K14's probe passes 43).
//
// The parts the design-step probe times (stream_kv_sm90_variants.cu) are
// configurations of the same kernel: kLoads reads every byte and computes
// nothing, kNoPe leaves the encoding add out (the function with pe = 0),
// kNoValueSum computes the scores and softmax and leaves the weighted sum
// out.  kLoads and kNoValueSum write no output.
#pragma once

#include "common.cuh"

namespace vda {

// The kernel stream_kv_attention.cu had before this loop, kept for fp32,
// head widths above 128 and the design-step probe (defined there).
cudaError_t stream_kv_sm80(const void* q, const void* kn, const void* vn,
                           const void* kb, const void* vb, const void* pek,
                           const void* pev, const unsigned char* valid,
                           void* out, int bhw, int rows, int c, int heads,
                           float scale, bool is_bf16, cudaStream_t stream);

namespace stream90 {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory

enum Part : int { kFull = 0, kLoads = 1, kNoPe = 2, kNoValueSum = 3 };

// The encoding bytes a block stages, which sets its head range: 16 KB
// (32 and 64 KB ran 3-8% slower at C 1024: fewer blocks an SM).
constexpr size_t kPeBudget = 16 * 1024;

inline bool takes(int c, int heads) {
  return heads > 0 && c % heads == 0 && (c / heads) % 8 == 0 &&
         c / heads <= 128;
}

struct Args {
  const bf16 *q, *kn, *vn, *kb, *vb, *pek, *pev;
  const unsigned char* valid;
  bf16* out;
  int bhw, rows, c, heads, dh;
  int hb;       // heads a block takes (its head range), whose encodings
                // it stages
  float scale;
  int keep;     // 0: the parts' results are kept alive on a branch no run
                // takes
};

// Shared memory of a block: pe_k and pe_v of its heads, [head][row][dh];
// the valid flags; each warp's score row (rows + 1 rounded up to 32).
struct Layout {
  size_t pv, valid, scores, bytes;
};
__host__ __device__ inline Layout layout(int rows, int hb, int dh) {
  Layout l;
  const size_t pe = static_cast<size_t>(hb) * rows * dh * sizeof(bf16);
  l.pv = pe;
  l.valid = 2 * pe;
  l.scores = l.valid + (static_cast<size_t>(rows) + 15) / 16 * 16;
  l.bytes = l.scores + sizeof(float) * kWarps * ((rows + 32) / 32 * 32);
  return l;
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i],
                                                           f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t fold(const uint4& u) {
  return u.x ^ u.y ^ u.z ^ u.w;
}

// Row r of this lane's chunk: cached rows come from buf (position b), row
// `rows` is the new row; rows past it, and cached rows that are not valid,
// read as zeros and are never touched.
template <int S, int RPI>
__device__ __forceinline__ void load_chunk(uint4 (&v)[S], const bf16* buf,
                                           const bf16* row_new,
                                           const unsigned char* vs, int k0,
                                           int grp, bool act, long long b,
                                           int rows, int c, int col) {
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int r = k0 + grp + j * RPI;
    const bool ok = act && (r < rows ? vs[r] != 0 : r == rows);
    const bf16* p = r < rows ? buf + (b * rows + r) * c + col
                             : row_new + b * c + col;
    const uint4* u = reinterpret_cast<const uint4*>(p);
    v[j] = ok ? __ldg(u) : make_uint4(0, 0, 0, 0);
  }
}

template <int LP, int PART>
__global__ void __launch_bounds__(kThreads, 4) kv_loop_kernel(const Args a) {
  constexpr int RPI = 32 / LP;  // rows a load instruction covers
  constexpr int S = LP;         // loads a lane for a 32-row chunk
  // a chunk of V loaded after its scores, not beside its K: at head widths
  // above 64, where both would spill
  constexpr bool kVAfter = LP == 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = a.rows, c = a.c, dh = a.dh;
  const Layout l = layout(rows, a.hb, dh);
  bf16* pk = reinterpret_cast<bf16*>(smem);
  bf16* pv = reinterpret_cast<bf16*>(smem + l.pv);
  unsigned char* vs = smem + l.valid;
  const int r32 = (rows + 32) / 32 * 32;

  const int h0 = blockIdx.y * a.hb;
  const int nh = min(a.hb, a.heads - h0);
  const int vpr = dh / 8;
  for (int i = threadIdx.x; i < nh * rows * vpr; i += kThreads) {
    const int x = i % vpr, r = (i / vpr) % rows, h = i / (vpr * rows);
    const size_t src = static_cast<size_t>(r) * c + (h0 + h) * dh + 8 * x;
    const size_t dst = (static_cast<size_t>(h) * rows + r) * dh + 8 * x;
    *reinterpret_cast<uint4*>(pk + dst) =
        __ldg(reinterpret_cast<const uint4*>(a.pek + src));
    *reinterpret_cast<uint4*>(pv + dst) =
        __ldg(reinterpret_cast<const uint4*>(a.pev + src));
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) vs[r] = a.valid[r];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / LP, sub = lane % LP;
  const bool act = 8 * sub < dh;  // this lane's 8 columns lie in the head
  float* sc = reinterpret_cast<float*>(smem + l.scores) + warp * r32;
  uint32_t keep = 0;

  const long long items = static_cast<long long>(a.bhw) * nh;
  for (long long it = static_cast<long long>(blockIdx.x) * kWarps + warp;
       it < items; it += static_cast<long long>(gridDim.x) * kWarps) {
    const long long b = it / nh;
    const int h = static_cast<int>(it % nh);
    const int col = (h0 + h) * dh + 8 * sub;  // this lane's first column
    const bf16* pkh = pk + static_cast<size_t>(h) * rows * dh + 8 * sub;
    const bf16* pvh = pv + static_cast<size_t>(h) * rows * dh + 8 * sub;

    // chunk k0 of this item's K or V rows into v
    const auto load_k = [&](uint4(&v)[S], int k0) {
      load_chunk<S, RPI>(v, a.kb, a.kn, vs, k0, grp, act, b, rows, c, col);
    };
    const auto load_v = [&](uint4(&v)[S], int k0) {
      load_chunk<S, RPI>(v, a.vb, a.vn, vs, k0, grp, act, b, rows, c, col);
    };
    uint4 kr[S], vr[S];
    load_k(kr, 0);
    if (!kVAfter) load_v(vr, 0);
    if (PART == kLoads) {  // the loop's loads in its order, nothing else
      for (int k0 = 0; k0 <= rows; k0 += 32) {
        if (k0) load_k(kr, k0);
#pragma unroll
        for (int j = 0; j < S; ++j) keep ^= fold(kr[j]);
        if (k0 || kVAfter) load_v(vr, k0);
#pragma unroll
        for (int j = 0; j < S; ++j) keep ^= fold(vr[j]);
      }
      continue;
    }
    float qf[8];
    unpack8(act ? __ldg(reinterpret_cast<const uint4*>(a.q + b * c + col))
                : make_uint4(0, 0, 0, 0),
            qf);

    // scores, a 32-row chunk at a time; -inf marks a row that takes no part
    for (int k0 = 0; k0 <= rows; k0 += 32) {
      if (k0)
        load_k(kr, k0);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int r = k0 + grp + j * RPI;
        float kf[8];
        unpack8(kr[j], kf);
        if (PART != kNoPe && act && r < rows) {
          float pf[8];
          unpack8(*reinterpret_cast<const uint4*>(pkh + r * dh), pf);
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = bf16_round(kf[e] + pf[e]);
        }
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(qf[e], kf[e], acc);
#pragma unroll
        for (int o = LP / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const bool ok = r < rows ? vs[r] != 0 : r == rows;
        if (sub == 0) sc[r] = ok ? acc * a.scale : -INFINITY;
      }
    }
    __syncwarp();

    // softmax weights, normalisation deferred
    float m = -INFINITY;
    for (int r = lane; r < r32; r += 32) m = fmaxf(m, sc[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float z = 0.f;  // m is finite: the new row always takes part
    for (int r = lane; r < r32; r += 32) {
      const float s = sc[r];
      const float e = s == -INFINITY ? 0.f : bf16_round(expf(bf16_round(
                                                 s - m)));
      sc[r] = e;
      z += e;
    }
    z = warp_sum(z);
    __syncwarp();

    if (PART == kNoValueSum) {
      if (kVAfter)
        load_v(vr, 0);
#pragma unroll
      for (int j = 0; j < S; ++j) keep ^= fold(vr[j]);
      for (int k0 = 32; k0 <= rows; k0 += 32) {
        load_v(vr, k0);
#pragma unroll
        for (int j = 0; j < S; ++j) keep ^= fold(vr[j]);
      }
      keep ^= __float_as_uint(z);
      continue;  // the score row is rewritten only after the loads above
    }

    // weighted sum of the value rows: a lane its 8 columns over its rows
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 <= rows; k0 += 32) {
      if (k0 || kVAfter)
        load_v(vr, k0);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int r = k0 + grp + j * RPI;
        const float e = sc[r];
        float vf[8];
        unpack8(vr[j], vf);
        if (PART != kNoPe && act && r < rows) {
          float pf[8];
          unpack8(*reinterpret_cast<const uint4*>(pvh + r * dh), pf);
#pragma unroll
          for (int x = 0; x < 8; ++x) vf[x] = bf16_round(vf[x] + pf[x]);
        }
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[x] = fmaf(e, vf[x], acc[x]);
      }
    }
#pragma unroll
    for (int o = LP; o < 32; o <<= 1)
#pragma unroll
      for (int x = 0; x < 8; ++x)
        acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], o);
    if (grp == 0 && act) {
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[x] = acc[x] / z;
      *reinterpret_cast<uint4*>(a.out + b * c + col) = pack8(acc);
    }
    __syncwarp();  // the score row is rewritten by the next item
  }
  if (a.keep) reinterpret_cast<uint32_t*>(a.out)[threadIdx.x] = keep;
}

// The heads a block stages: as many as the budget holds, at least one.
inline int heads_a_block(int rows, int heads, int dh, size_t budget) {
  const size_t per_head = 2 * static_cast<size_t>(rows) * dh * sizeof(bf16);
  const size_t fit = per_head ? budget / per_head : heads;
  return static_cast<int>(fit < 1 ? 1 : (fit < static_cast<size_t>(heads)
                                             ? fit : heads));
}

template <int LP, int PART>
cudaError_t launch_lp(const Args& a, size_t smem, cudaStream_t st) {
  auto kern = kv_loop_kernel<LP, PART>;
  int per_sm = 0;
  const cudaError_t e = fit_blocks(kern, kThreads, smem, 0, &per_sm);
  const int sms = device_sms();
  if (e != cudaSuccess) return e;
  if (sms < 1) return cudaErrorInvalidValue;
  const int ranges = (a.heads + a.hb - 1) / a.hb;
  const long long need =
      (static_cast<long long>(a.bhw) * a.hb + kWarps - 1) / kWarps;
  const long long fit = (static_cast<long long>(per_sm) * sms + ranges - 1) /
                        ranges;
  const int bx = static_cast<int>(need < fit ? need : fit);
  kern<<<dim3(bx, ranges), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Launch configuration PART of the loop: q, kn, vn (bhw, c); kb, vb (bhw,
// rows, c); pek, pev (rows, c); all bf16, contiguous, 16-byte aligned.
template <int PART>
cudaError_t launch(const void* q, const void* kn, const void* vn,
                   const void* kb, const void* vb, const void* pek,
                   const void* pev, const unsigned char* valid, void* out,
                   int bhw, int rows, int c, int heads, float scale, int keep,
                   cudaStream_t st) {
  if (bhw <= 0 || rows < 0 || !takes(c, heads)) return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.kn = static_cast<const bf16*>(kn);
  a.vn = static_cast<const bf16*>(vn);
  a.kb = static_cast<const bf16*>(kb);
  a.vb = static_cast<const bf16*>(vb);
  a.pek = static_cast<const bf16*>(pek);
  a.pev = static_cast<const bf16*>(pev);
  a.valid = valid;
  a.out = static_cast<bf16*>(out);
  a.bhw = bhw;
  a.rows = rows;
  a.c = c;
  a.heads = heads;
  a.dh = c / heads;
  a.scale = scale;
  a.keep = keep;
  a.hb = heads_a_block(rows, heads, a.dh, kPeBudget);
  const size_t smem = layout(rows, a.hb, a.dh).bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int lanes = a.dh / 8;
  if (lanes > 8) return launch_lp<16, PART>(a, smem, st);
  if (lanes > 4) return launch_lp<8, PART>(a, smem, st);
  if (lanes > 2) return launch_lp<4, PART>(a, smem, st);
  if (lanes > 1) return launch_lp<2, PART>(a, smem, st);
  return launch_lp<1, PART>(a, smem, st);
}

}  // namespace stream90
}  // namespace vda
