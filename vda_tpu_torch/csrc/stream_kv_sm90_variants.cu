// The design steps of K6's Hopper loop (stream_kv_sm90.cuh), for the
// measurements of probes/bench_stream_sm90.py.  The operands of
// vda_stream_kv_attention, bf16; `variant` picks the step:
//   0 sm80        the kernel the loop replaced (stream_kv_attention.cu: a
//                 block a position and a group of heads, the rows staged in
//                 shared memory by cp.async, a lane a row, then a column)
//   1 sm90        the Hopper loop: vda_stream_kv_attention's own (16 KB of
//                 encodings a block; at head widths above 64 a chunk of V
//                 loaded after its scores, elsewhere beside its K)
//   2 loads       1's loads of K, V and the new row alone (nothing computed
//                 or written)
//   3 no_pe       1 without the encoding adds (the function with pe = 0)
//   4 no_value_sum  1's loads, scores and softmax, without the weighted
//                 sum (nothing written)
//   5 read_linear the least the loads could cost: a kernel that reads the
//                 K and V rows from first byte to last, 16 bytes a thread
//                 and 8 in flight, and computes nothing (a yardstick of the
//                 card's read rate, not K6's function; nothing written)
//   6 k_ahead     1 with the next item's K rows copied into shared memory
//                 by cp.async while the current item computes, and the
//                 current item's V loaded into registers before its
//                 scores (rows <= 31: one chunk an item)
// `keep` is 0 from every caller: the steps that write nothing keep their
// results alive on a branch no run takes.

#include "stream_kv_sm90.cuh"

namespace {

constexpr int kReadThreads = 256, kReadUnroll = 8;

__global__ void __launch_bounds__(kReadThreads)
    read_linear_kernel(const uint4* __restrict__ k,
                       const uint4* __restrict__ v, long long n, int keep,
                       uint32_t* out) {
  uint32_t acc = 0;
  const long long stride =
      static_cast<long long>(gridDim.x) * kReadThreads * kReadUnroll;
  for (long long i0 = static_cast<long long>(blockIdx.x) * kReadThreads *
                          kReadUnroll + threadIdx.x;
       i0 < 2 * n; i0 += stride) {
    uint4 r[kReadUnroll];
#pragma unroll
    for (int u = 0; u < kReadUnroll; ++u) {
      const long long i = i0 + u * kReadThreads;
      r[u] = i < n ? __ldg(k + i) : (i < 2 * n ? __ldg(v + i - n)
                                               : make_uint4(0, 0, 0, 0));
    }
#pragma unroll
    for (int u = 0; u < kReadUnroll; ++u)
      acc ^= r[u].x ^ r[u].y ^ r[u].z ^ r[u].w;
  }
  if (keep) out[threadIdx.x] = acc;
}

cudaError_t read_linear(const void* kb, const void* vb, void* out, int bhw,
                        int rows, int c, int keep, cudaStream_t st) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, read_linear_kernel, kReadThreads, 0);
  if (e != cudaSuccess) return e;
  const long long n =
      static_cast<long long>(bhw) * rows * c * sizeof(__nv_bfloat16) / 16;
  read_linear_kernel<<<per_sm * vda::device_sms(), kReadThreads, 0, st>>>(
      static_cast<const uint4*>(kb), static_cast<const uint4*>(vb), n, keep,
      static_cast<uint32_t*>(out));
  return cudaGetLastError();
}


// k_ahead: the loop with the next item's K rows copied into shared memory
// by cp.async while the current item computes, and the current item's V
// rows loaded into registers before its scores.  One 32-row chunk an item
// (rows <= 31); a lane copies and later reads its own 16-byte pieces, so
// the copies need no barrier beyond their wait.
namespace ahead {

using namespace vda::stream90;

__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  const auto d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__host__ __device__ inline size_t k_offset(const Layout& l) {
  return (l.bytes + 15) / 16 * 16;
}

template <int LP>
__global__ void __launch_bounds__(kThreads, 4) kernel(const Args a) {
  constexpr int RPI = 32 / LP, S = LP;
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
  const bool act = 8 * sub < dh;
  float* sc = reinterpret_cast<float*>(smem + l.scores) + warp * r32;
  uint4* kbuf = reinterpret_cast<uint4*>(smem + k_offset(l)) + warp * 32 * S;
  const long long items = static_cast<long long>(a.bhw) * nh;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  const auto copy_k = [&](long long item) {  // item's K rows into kbuf
    const long long b = item / nh;
    const int col = (h0 + static_cast<int>(item % nh)) * dh + 8 * sub;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int r = grp + j * RPI;
      const bool ok = act && (r < rows ? vs[r] != 0 : r == rows);
      const bf16* p = r < rows ? a.kb + (b * rows + r) * c + col
                               : a.kn + b * c + col;
      copy16(kbuf + j * 32 + lane, p, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  long long it = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (it < items) copy_k(it);
  for (; it < items; it += step) {
    const long long b = it / nh;
    const int h = static_cast<int>(it % nh);
    const int col = (h0 + h) * dh + 8 * sub;
    const bf16* pkh = pk + static_cast<size_t>(h) * rows * dh + 8 * sub;
    const bf16* pvh = pv + static_cast<size_t>(h) * rows * dh + 8 * sub;
    uint4 vr[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int r = grp + j * RPI;
      const bool ok = act && (r < rows ? vs[r] != 0 : r == rows);
      const bf16* p = r < rows ? a.vb + (b * rows + r) * c + col
                               : a.vn + b * c + col;
      vr[j] = ok ? __ldg(reinterpret_cast<const uint4*>(p))
                 : make_uint4(0, 0, 0, 0);
    }
    float qf[8];
    unpack8(act ? __ldg(reinterpret_cast<const uint4*>(a.q + b * c + col))
                : make_uint4(0, 0, 0, 0),
            qf);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int r = grp + j * RPI;
      float kf[8];
      unpack8(kbuf[j * 32 + lane], kf);
      if (act && r < rows) {
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
    if (it + step < items) copy_k(it + step);  // its K read: the next's
    __syncwarp();

    float m = -INFINITY;
    for (int r = lane; r < r32; r += 32) m = fmaxf(m, sc[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float z = 0.f;
    for (int r = lane; r < r32; r += 32) {
      const float s = sc[r];
      const float e = s == -INFINITY ? 0.f : bf16_round(expf(bf16_round(
                                                 s - m)));
      sc[r] = e;
      z += e;
    }
    z = vda::warp_sum(z);
    __syncwarp();

    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int r = grp + j * RPI;
      const float e = sc[r];
      float vf[8];
      unpack8(vr[j], vf);
      if (act && r < rows) {
        float pf[8];
        unpack8(*reinterpret_cast<const uint4*>(pvh + r * dh), pf);
#pragma unroll
        for (int x = 0; x < 8; ++x) vf[x] = bf16_round(vf[x] + pf[x]);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[x] = fmaf(e, vf[x], acc[x]);
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
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int LP>
cudaError_t launch_lp(const Args& a, size_t smem, cudaStream_t st) {
  auto kern = kernel<LP>;
  int per_sm = 0;
  const cudaError_t e = vda::fit_blocks(kern, kThreads, smem, 0, &per_sm);
  const int sms = vda::device_sms();
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

cudaError_t launch(const void* q, const void* kn, const void* vn,
                   const void* kb, const void* vb, const void* pek,
                   const void* pev, const unsigned char* valid, void* out,
                   int bhw, int rows, int c, int heads, float scale,
                   cudaStream_t st) {
  if (bhw <= 0 || rows < 0 || rows > 31 || !takes(c, heads))
    return cudaErrorInvalidValue;
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
  a.keep = 0;
  a.hb = heads_a_block(rows, heads, a.dh, kPeBudget);
  const int lanes = a.dh / 8;
  const int lp = lanes > 8 ? 16 : lanes > 4 ? 8 : lanes > 2 ? 4
                                                 : lanes > 1 ? 2 : 1;
  const size_t smem = k_offset(layout(rows, a.hb, a.dh)) +
                      static_cast<size_t>(kWarps) * 32 * lp * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (lp == 16) return launch_lp<16>(a, smem, st);
  if (lp == 8) return launch_lp<8>(a, smem, st);
  if (lp == 4) return launch_lp<4>(a, smem, st);
  if (lp == 2) return launch_lp<2>(a, smem, st);
  return launch_lp<1>(a, smem, st);
}

}  // namespace ahead

}  // namespace

extern "C" int vda_stream_kv_variant(const void* q, const void* kn,
                                     const void* vn, const void* kb,
                                     const void* vb, const void* pek,
                                     const void* pev, const void* valid,
                                     void* out, int bhw, int rows, int c,
                                     int heads, float scale, int keep,
                                     int variant, void* stream) {
  using namespace vda::stream90;
  const auto* flags = static_cast<const unsigned char*>(valid);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return vda::stream_kv_sm80(q, kn, vn, kb, vb, pek, pev, flags,
                                       out, bhw, rows, c, heads, scale, true,
                                       st);
    case 1: return launch<kFull>(q, kn, vn, kb, vb, pek, pev, flags, out, bhw,
                                 rows, c, heads, scale, keep, st);
    case 2: return launch<kLoads>(q, kn, vn, kb, vb, pek, pev, flags, out,
                                  bhw, rows, c, heads, scale, keep, st);
    case 3: return launch<kNoPe>(q, kn, vn, kb, vb, pek, pev, flags, out, bhw,
                                 rows, c, heads, scale, keep, st);
    case 4: return launch<kNoValueSum>(q, kn, vn, kb, vb, pek, pev, flags,
                                       out, bhw, rows, c, heads, scale, keep,
                                       st);
    case 5: return read_linear(kb, vb, out, bhw, rows, c, keep, st);
    case 6: return ahead::launch(q, kn, vn, kb, vb, pek, pev, flags, out,
                                 bhw, rows, c, heads, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
