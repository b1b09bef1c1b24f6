// K14 on Hopper: the streaming-attention probe's reduced kernels (the
// function and its roundings: stream_probe.cu's head comment).
//
// Replaces scripts/probe_stream_kernel.py simple_kernel, as the kernel of
// stream_probe.cu did.  At the probe's shape (32 positions, 43 cached rows,
// C 256, 8 heads of 32, groups of 16) the whole call reads 1.4 MB: 0.45 us
// at the card's memory rate, below what a launch costs.  So the design
// aims at latency: every byte on its way in one round trip, and no serial
// loop over rows.
//
//   * A (group, head) pair is a cluster of up to 8 blocks (16 pairs x 8 =
//     128 blocks at the probe's shape), each holding a share of the pair's
//     context rows (G * rows of them, in chunks of 16) and the rank that
//     takes the last chunk with NEW also the group's G new rows.
//   * Each block brings its query tile, its K and V chunks (and the
//     encodings of their rows with PE) into shared memory by 16-byte
//     cp.async, all issued at once, rows past the group zero-filled.
//   * A warp takes a chunk: S = Q K^T by mma.sync (the group's 16 queries
//     are one m16 tile; a head of 32 is two k16 steps), the scale and mask
//     rounded as the twin rounds them, then O += P V by mma.sync, P the
//     bf16 values the twin multiplies (e, or bf16(s) without SOFTMAX).
//   * The softmax is the twin's, not an online one: each block's row
//     maxima go to every block of the cluster before any exponential, so
//     e = bf16(exp(bf16(s - m))) with the global m.  A warp keeps the
//     scores of its first two chunks in registers between the passes.
//   * Each block sums its warps' O and z in a fixed order and sends each
//     row to the block that finishes it (rows spread over the cluster),
//     which adds the cluster's sums in rank order: no atomics, so a call
//     repeats bit for bit, and only the fp32 summation order differs from
//     the twin.
//   * Blocks exchange data only by pushing it: st.async into the peer's
//     shared memory, completing on the peer's mbarrier, which counts the
//     bytes it waits for.  The one cluster barrier (the mbarriers made
//     before any push) is arrived at when the loads are issued and waited
//     on when they have landed, so it costs nothing on the way; no block
//     reads another's shared memory, so none waits for the others to
//     leave.  (Cluster barriers and pulled reads cost ~0.6 us each and 1.4
//     us at the end, PERF.md.)
//   * Every row is read in every stage, also those the mask sets to
//     -1e30: the byte bound counts them, and the launch, not the bytes,
//     sets the time.
//
// Takes groups of up to 16 positions (one m16 tile of queries), head widths
// a multiple of 8 up to 128 (padded to 16 with zeros in shared memory), and
// any row count whose chunks fit a block's shared memory.  The C entry
// point routes every other shape to stream_probe.cu's kernel.

#pragma once

#include "common.cuh"

namespace vda {
namespace probe90 {

using bf16 = __nv_bfloat16;

constexpr int MASK = 1, PE = 2, SOFTMAX = 4, NEW = 8;
constexpr int kWarps = 4;  // a block's warps (8 gained 2-4%, 16 lost 60%)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxGroup = 16;   // the queries of one m16 tile
constexpr int kMaxDh = 128;
constexpr size_t kMaxSmem = 227 * 1024;

// kFull the kernel; kLoads its loads alone; kEmpty an empty kernel on the
// same launch
enum class Mode { kFull, kLoads, kEmpty };

__host__ __device__ inline int pad16(int dh) { return (dh + 15) / 16 * 16; }
// a row in shared memory: the padded head, plus 16 bytes so that the 8 rows
// of an ldmatrix fall in 8 distinct 16-byte bank groups
__host__ __device__ inline int row_bytes(int dh) { return 2 * pad16(dh) + 16; }
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~15; }

// chunks of 16 context rows of a group; with NEW one more (the new rows)
__host__ __device__ inline int ctx_chunks(int rows, int group) {
  return (group * rows + 15) / 16;
}
__host__ __device__ inline int total_chunks(int rows, int group,
                                            int features) {
  return ctx_chunks(rows, group) + ((features & NEW) ? 1 : 0);
}
__host__ __device__ inline int cluster_of(int total) {
  return total < kMaxCluster ? total : kMaxCluster;
}
// the most chunks a block of the cluster takes ([r T / cl, (r + 1) T / cl))
__host__ __device__ inline int chunks_per_block(int total, int cl) {
  return (total + cl - 1) / cl;
}

// rows of the group's outputs a block finishes, at most: rows
// [r G / cl, (r + 1) G / cl) go to rank r
__host__ __device__ inline int rows_cap(int cl) {
  return (kMaxGroup + cl - 1) / cl;
}

// Shared memory of a block: two mbarriers; q, then K, V and the encodings
// of `pb` chunks; the rows' owners (MASK); the warps' row maxima and those
// every block sends; the warps' partial O and z; the O and z rows every
// block sends.
__host__ __device__ inline size_t smem_bytes(int dh, int pb, int cl) {
  const size_t rb = row_bytes(dh);
  size_t n = 16 + 16 * rb + 3 * static_cast<size_t>(pb) * 16 * rb;
  n += align16(static_cast<size_t>(pb) * 16 * sizeof(short));
  n += sizeof(float) * (kWarps * 16 + kMaxCluster * 16);
  n += sizeof(float) * (kWarps * 16 * dh + kWarps * 16);
  n += sizeof(float) * static_cast<size_t>(cl) * rows_cap(cl) * (dh + 1);
  return n;
}

inline bool takes(int rows, int c, int heads, int group) {
  if (rows <= 0 || group <= 0 || group > kMaxGroup || heads <= 0) return false;
  if (c % heads != 0) return false;
  if ((c / heads) % 8 != 0) return false;
  if (c / heads > kMaxDh) return false;
  const int total = total_chunks(rows, group, NEW);
  const int cl = cluster_of(total);
  return smem_bytes(c / heads, chunks_per_block(total, cl), cl) <= kMaxSmem;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory, zeros where src_bytes 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: every thread of every block arrives
// (release: what it did before is seen after the wait), then waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the mbarrier made visible to the cluster's pushes
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on bar, which then waits for `bytes` pushed bytes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The address of the same shared-memory offset in block `rank`.
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 4 or 16 bytes into a peer's shared memory (cluster addresses), counted
// on the peer's mbarrier
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// far under the bf16 rounding that follows it; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DH, Mode M>
__global__ void __launch_bounds__(kThreads)
    probe90_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                   const bf16* __restrict__ vn, const bf16* __restrict__ kb,
                   const bf16* __restrict__ vb, const bf16* __restrict__ pe,
                   const unsigned char* __restrict__ valid,
                   bf16* __restrict__ out, int rows, int c, int heads,
                   int group, float scale, int features, int cl) {
  constexpr int DP = (DH + 15) / 16 * 16;  // the head padded to k16 steps
  constexpr int RB = 2 * DP + 16;          // bytes a row in shared memory
  constexpr int KS = DP / 16;              // k16 steps of S
  constexpr int NB = DH / 8;               // n8 blocks of O
  constexpr int PPR = DP / 8;              // 16-byte pieces a padded row
  constexpr int PR = DH / 8;               // pieces that hold the head
  extern __shared__ __align__(16) unsigned char sm[];

  const int rank = static_cast<int>(cluster_rank());
  const int pair = blockIdx.x / cl;
  const int h = pair % heads, gi = pair / heads;
  const int nr = group * rows;  // context rows of the group
  const int nctx = (nr + 15) / 16;
  const int total = nctx + ((features & NEW) ? 1 : 0);
  const int c0 = rank * total / cl;
  const int nb = (rank + 1) * total / cl - c0;  // this block's chunks
  const int pb = (total + cl - 1) / cl;         // the slots of every block
  const long long pos0 = static_cast<long long>(gi) * group;
  const long long row0 = pos0 * rows;
  const int col0 = h * DH;
  const bool pe_on = features & PE;

  const int rcap = rows_cap(cl);
  const int own0 = rank * group / cl;                // the rows this block
  const int n_own = (rank + 1) * group / cl - own0;  // finishes
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);  // maxima, outputs
  unsigned char* qs = sm + 16;
  unsigned char* ks = qs + 16 * RB;
  unsigned char* vs = ks + pb * 16 * RB;
  unsigned char* ps = vs + pb * 16 * RB;
  short* own = reinterpret_cast<short*>(ps + pb * 16 * RB);
  float* wmax = reinterpret_cast<float*>(ps + pb * 16 * RB +
                                         align16(pb * 16 * sizeof(short)));
  float* in_max = wmax + kWarps * 16;      // [kMaxCluster][16]
  float* part = in_max + kMaxCluster * 16;  // [kWarps][16][DH]
  float* zpart = part + kWarps * 16 * DH;   // [kWarps][16]
  float* in_o = zpart + kWarps * 16;        // [cl][rcap][DH]
  float* in_z = in_o + cl * rcap * DH;      // [cl][rcap]
  const uint32_t bar_max = smem_u32(&bars[0]), bar_out = smem_u32(&bars[1]);
  const bool softmax = features & SOFTMAX;

  // every load at once, in two groups: the query tile, K and the
  // encodings, then V; rows past the group and the head's padding are
  // zero-filled.  Local row lr is row c0 * 16 + lr of the group's chunks
  // (context rows, then with NEW the group's new rows); neighbouring
  // threads copy neighbouring 16-byte pieces.  (A thread a row, its source
  // found once, was slower: PERF.md.)
  const int nloc = nb * 16;
  const int new0 = nctx * 16;  // the first new row's index
  for (int idx = threadIdx.x; idx < 16 * PPR; idx += kThreads) {
    const int row = idx / PPR, piece = idx % PPR;
    const bool real = row < group && piece < PR;
    cp_async16(smem_u32(qs + row * RB + piece * 16),
               real ? q + (pos0 + row) * c + col0 + piece * 8 : q,
               real ? 16 : 0);
  }
  // piece `piece` of local row lr's source: a (bhw, rows, c) buffer row or
  // a new row (kn, vn), nullptr past the group and in the head's padding
  auto source = [&](int lr, int piece, const bf16* buf, const bf16* fresh) {
    const int jr = c0 * 16 + lr;
    if (piece >= PR) return static_cast<const bf16*>(nullptr);
    if (jr < nr) return buf + (row0 + jr) * c + col0 + piece * 8;
    if (jr >= new0 && jr - new0 < group)
      return fresh + (pos0 + jr - new0) * c + col0 + piece * 8;
    return static_cast<const bf16*>(nullptr);
  };
  auto copy = [&](unsigned char* dst, const bf16* src) {
    cp_async16(smem_u32(dst), src != nullptr ? src : q,
               src != nullptr ? 16 : 0);
  };
  for (int idx = threadIdx.x; idx < nloc * PPR; idx += kThreads) {
    const int lr = idx / PPR, piece = idx % PPR, jr = c0 * 16 + lr;
    const int off = lr * RB + piece * 16;
    copy(ks + off, source(lr, piece, kb, kn));
    if (pe_on)
      copy(ps + off, jr < nr && piece < PR
                         ? pe + static_cast<long long>(jr % rows) * c +
                               col0 + piece * 8
                         : nullptr);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < nloc * PPR; idx += kThreads) {
    const int lr = idx / PPR, piece = idx % PPR;
    copy(vs + lr * RB + piece * 16, source(lr, piece, vb, vn));
  }
  cp_async_commit();
  // the mbarriers the peers push to, each waiting for its bytes: every
  // block's 16 maxima (SOFTMAX), every block's sums of this block's rows
  if constexpr (M == Mode::kFull) {
    if (threadIdx.x == 0) {
      mbar_init(bar_max, 1);
      mbar_init(bar_out, 1);
      fence_mbar_init();
      if (softmax) mbar_expect(bar_max, cl * 16 * sizeof(float));
      mbar_expect(bar_out, cl * n_own * (DH + 1) * sizeof(float));
    }
    cluster_arrive();  // waited on once the loads are in
  }
  if (features & MASK)
    for (int lr = threadIdx.x; lr < nloc; lr += kThreads) {
      const int jr = c0 * 16 + lr;
      own[lr] = jr < nr && valid[jr % rows] ? static_cast<short>(jr / rows)
                                            : static_cast<short>(-1);
    }
  if constexpr (M == Mode::kLoads) {
    cp_async_wait<0>();
    __syncthreads();
    return;
  }
  cp_async_wait<1>();  // Q and K (and the encodings) are in
  __syncthreads();
  cluster_wait();  // the peers' mbarriers

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const uint32_t q_u = smem_u32(qs), k_u = smem_u32(ks), v_u = smem_u32(vs),
                 p_u = smem_u32(ps);
  const float pad = softmax ? -INFINITY : 0.f;  // rows past the group

  uint32_t qa[KS][4];  // the query tile's A fragments
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], q_u + (lane & 15) * RB + (2 * kk + (lane >> 4)) * 16);

  // the scores of local chunk ls: row g + 8 (e >> 1), key 8 j + 2 t4 +
  // (e & 1) of the chunk, k = bf16(k + pe) added on the fragments (in
  // fp32, rounded, as the twin's bf16 add; the new rows' encodings are
  // zeros), the scale and mask (or the new rows' mask) added and each step
  // rounded as the twin rounds it
  auto scores = [&](int ls, float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t roff = (ls * 16 + (lane >> 4) * 8 + (lane & 7)) * RB;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = roff + (2 * kk + ((lane >> 3) & 1)) * 16;
      uint32_t b[4];
      ldsm_x4(b, k_u + off);
      if (pe_on) {
        uint32_t p[4];
        ldsm_x4(p, p_u + off);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&b[r]));
          const float2 d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p[r]));
          b[r] = pack2(a.x + d.x, a.y + d.y);
        }
      }
      mma16(s[0], qa[kk], b[0], b[1]);
      mma16(s[1], qa[kk], b[2], b[3]);
    }
    const int jr0 = (c0 + ls) * 16;
    const bool ctx = jr0 < new0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int kc = 8 * j + 2 * t4 + e1;
        const int jr = jr0 + kc;
        const int who = (features & MASK) && ctx ? own[ls * 16 + kc] : -1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = g + 8 * r;
          float& x = s[j][2 * r + e1];
          if (ctx) {
            if (jr >= nr)
              x = pad;
            else if (features & MASK)
              x = __fadd_rn(__fmul_rn(x, scale), who == i ? 0.f : -1e30f);
          } else {
            x = kc < group ? __fadd_rn(x, kc == i ? 0.f : -1e30f) : pad;
          }
        }
      }
  };

  // a warp's first two chunks keep their scores between the passes; any
  // further chunk (more than 8 a block) computes them again
  const int l0 = warp, l1 = warp + kWarps;
  float s0[2][4], s1[2][4], s[2][4];
  if (l0 < nb) scores(l0, s0);
  if (l1 < nb) scores(l1, s1);
  float m[2] = {0.f, 0.f};
  if (softmax) {
    // the row maxima: the warps', the block's, then the cluster's
    float mx[2] = {-INFINITY, -INFINITY};
    auto take = [&](const float (&x)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
    };
    if (l0 < nb) take(s0);
    if (l1 < nb) take(s1);
    for (int ls = warp + 2 * kWarps; ls < nb; ls += kWarps) {
      scores(ls, s);
      take(s);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t4 == 0) {
      wmax[warp * 16 + g] = mx[0];
      wmax[warp * 16 + g + 8] = mx[1];
    }
    __syncthreads();
    if (threadIdx.x < 16) {  // the block's maxima, pushed to every block
      float b = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        b = fmaxf(b, wmax[w * 16 + threadIdx.x]);
      const uint32_t a = smem_u32(in_max + rank * 16 + threadIdx.x);
      for (int r = 0; r < cl; ++r) push(peer(a, r), b, peer(bar_max, r));
    }
    mbar_wait(bar_max, 0);
    m[0] = m[1] = -INFINITY;
    for (int r = 0; r < cl; ++r) {
      m[0] = fmaxf(m[0], in_max[r * 16 + g]);
      m[1] = fmaxf(m[1], in_max[r * 16 + g + 8]);
    }
  }
  cp_async_wait<0>();  // V is in
  __syncthreads();

  // O = P V over this warp's chunks, z the sum of e
  float o[NB][4];
#pragma unroll
  for (int jd = 0; jd < NB; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
  float z[2] = {0.f, 0.f};
  constexpr float kLog2e = 1.4426950408889634f;
  auto accumulate = [&](int ls, const float (&x)[2][4]) {
    uint32_t pf[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (softmax) {
          // e = bf16(exp(bf16(s - m))), exp by ex2 of the rounded
          // difference times log2 e (its error far under the rounding)
          const float2 d = __bfloat1622float2(__floats2bfloat162_rn(
              x[j][2 * r] - m[r], x[j][2 * r + 1] - m[r]));
          const __nv_bfloat162 ev =
              __floats2bfloat162_rn(ex2(d.x * kLog2e), ex2(d.y * kLog2e));
          const float2 ef = __bfloat1622float2(ev);
          z[r] += ef.x;
          z[r] += ef.y;
          pf[2 * j + r] = *reinterpret_cast<const uint32_t*>(&ev);
        } else {
          pf[2 * j + r] = pack2(x[j][2 * r], x[j][2 * r + 1]);
        }
      }
    const uint32_t vrow = v_u + (ls * 16 + (lane & 15)) * RB;
#pragma unroll
    for (int jd = 0; jd + 1 < NB; jd += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + (jd + (lane >> 4)) * 16);
      mma16(o[jd], pf, b[0], b[1]);
      mma16(o[jd + 1], pf, b[2], b[3]);
    }
    if constexpr (NB % 2 == 1) {
      uint32_t b[2];
      ldsm_x2_t(b, vrow + (NB - 1) * 16);
      mma16(o[NB - 1], pf, b[0], b[1]);
    }
  };
  if (l0 < nb) accumulate(l0, s0);
  if (l1 < nb) accumulate(l1, s1);
  for (int ls = warp + 2 * kWarps; ls < nb; ls += kWarps) {
    scores(ls, s);
    accumulate(ls, s);
  }

  // the block's sums: its warps' partials added in warp order
  if (warp < nb) {
    float* pw = part + warp * 16 * DH;
#pragma unroll
    for (int jd = 0; jd < NB; ++jd)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(pw + (g + 8 * r) * DH + 8 * jd + 2 * t4) =
            make_float2(o[jd][2 * r], o[jd][2 * r + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 1);
      z[r] += __shfl_xor_sync(0xffffffffu, z[r], 2);
    }
    if (t4 == 0) {
      zpart[warp * 16 + g] = z[0];
      zpart[warp * 16 + g + 8] = z[1];
    }
  }
  __syncthreads();

  // each row of the block's sums (its warps' partials added in warp
  // order), 4 columns a push, to the block that finishes the row
  const int nw = nb < kWarps ? nb : kWarps;
  constexpr int P4 = DH / 4;
  for (int idx = threadIdx.x; idx < group * P4; idx += kThreads) {
    const int i = idx / P4, k4 = idx % P4;
    float4 a = *reinterpret_cast<const float4*>(part + i * DH + 4 * k4);
    for (int w = 1; w < nw; ++w) {
      const float4 b =
          *reinterpret_cast<const float4*>(part + (w * 16 + i) * DH + 4 * k4);
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const int r = ((i + 1) * cl - 1) / group;  // the row's block
    const int li = i - r * group / cl;
    push4(peer(smem_u32(in_o + (rank * rcap + li) * DH + 4 * k4), r), a,
          peer(bar_out, r));
  }
  if (static_cast<int>(threadIdx.x) < group) {
    const int i = threadIdx.x;
    float a = zpart[i];
    for (int w = 1; w < nw; ++w) a += zpart[w * 16 + i];
    const int r = ((i + 1) * cl - 1) / group;
    const int li = i - r * group / cl;
    push(peer(smem_u32(in_z + rank * rcap + li), r), a, peer(bar_out, r));
  }

  // this block's rows: the cluster's sums added in rank order, o / z,
  // rounded to bf16
  if (n_own > 0) mbar_wait(bar_out, 0);
  for (int p = threadIdx.x; p < n_own * (DH / 2); p += kThreads) {
    const int li = p / (DH / 2), col = 2 * (p % (DH / 2));
    float2 acc = *reinterpret_cast<const float2*>(in_o + li * DH + col);
    float zz = in_z[li];
    for (int r = 1; r < cl; ++r) {
      const float2 v =
          *reinterpret_cast<const float2*>(in_o + (r * rcap + li) * DH + col);
      acc.x += v.x;
      acc.y += v.y;
      zz += in_z[r * rcap + li];
    }
    if (softmax) {
      acc.x = acc.x / zz;
      acc.y = acc.y / zz;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (pos0 + own0 + li) * c + col0 +
                                       col) = __floats2bfloat162_rn(acc.x, acc.y);
  }
}

// An empty kernel: the launch alone, on the grid, cluster and shared memory
// of the kernel it stands in for.
template <int DH>
__global__ void __launch_bounds__(kThreads) probe90_empty_kernel() {}

struct Args {
  const bf16 *q, *kn, *vn, *kb, *vb, *pe;
  const unsigned char* valid;
  bf16* out;
  int bhw, rows, c, heads, group;
  float scale;
  int features;
};

// Sets kern's dynamic shared memory limit when a launch needs more than the
// default 48 KB and more than `set` (the kernel's last limit) holds.
template <class K>
cudaError_t allow_smem(K kern, size_t smem, std::atomic<size_t>& set) {
  if (smem <= set.load()) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) set.store(smem);
  return e;
}

template <int DH, Mode M>
cudaError_t launch_dh(const Args& a, cudaStream_t st) {
  const int total = total_chunks(a.rows, a.group, a.features);
  const int cl = cluster_of(total);
  const size_t smem = smem_bytes(DH, chunks_per_block(total, cl), cl);
  const long long blocks =
      static_cast<long long>(a.bhw / a.group) * a.heads * cl;
  if (smem > kMaxSmem || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static std::atomic<size_t> set{48 * 1024};  // this kernel's limit
  cudaError_t e;
  if constexpr (M == Mode::kEmpty) {
    auto kern = probe90_empty_kernel<DH>;
    e = allow_smem(kern, smem, set);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern);
  } else {
    auto kern = probe90_kernel<DH, M>;
    e = allow_smem(kern, smem, set);
    if (e == cudaSuccess)
      e = cudaLaunchKernelEx(&cfg, kern, a.q, a.kn, a.vn, a.kb, a.vb, a.pe,
                             a.valid, a.out, a.rows, a.c, a.heads, a.group,
                             a.scale, a.features, cl);
  }
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The Hopper kernel (kFull), its loads alone (kLoads: the probe's head
// widths 32 and 64 only) or an empty kernel on its grid (kEmpty) at the
// operands of vda_stream_probe; refuses what takes() does not take.
template <Mode M>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (!takes(a.rows, a.c, a.heads, a.group)) return cudaErrorInvalidValue;
  const int dh = a.c / a.heads;
  if constexpr (M == Mode::kLoads) {
    if (dh == 32) return launch_dh<32, M>(a, st);
    if (dh == 64) return launch_dh<64, M>(a, st);
    return cudaErrorInvalidValue;
  } else {
    switch (dh) {
      case 8: return launch_dh<8, M>(a, st);
      case 16: return launch_dh<16, M>(a, st);
      case 24: return launch_dh<24, M>(a, st);
      case 32: return launch_dh<32, M>(a, st);
      case 40: return launch_dh<40, M>(a, st);
      case 48: return launch_dh<48, M>(a, st);
      case 56: return launch_dh<56, M>(a, st);
      case 64: return launch_dh<64, M>(a, st);
      case 72: return launch_dh<72, M>(a, st);
      case 80: return launch_dh<80, M>(a, st);
      case 88: return launch_dh<88, M>(a, st);
      case 96: return launch_dh<96, M>(a, st);
      case 104: return launch_dh<104, M>(a, st);
      case 112: return launch_dh<112, M>(a, st);
      case 120: return launch_dh<120, M>(a, st);
      case 128: return launch_dh<128, M>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace probe90
}  // namespace vda
