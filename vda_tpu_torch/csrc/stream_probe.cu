// K14: the reduced kernels of the streaming-attention probe, one feature of
// K6 added at a time.
//
// Replaces scripts/probe_stream_kernel.py simple_kernel (its pallas_call
// runs `kern`).  Positions come in groups of G; each query of a group
// scores against all G * rows cached rows of its group (not only its own
// position's), per head of width dh:
//   s = q . k_r                        (k_r = bf16(k_r + pe_r) with PE)
//   MASK     s = s * scale + (0 if row r is the query's own position and
//            valid, else -1e30), each step rounded
//   SOFTMAX  e_r = bf16(exp(bf16(s_r - m))), m the row max; NEW adds the
//            G new rows of the group (score q . kn_j + 0 on the query's own
//            row, -1e30 elsewhere; no scale), o = sum e v / sum e
//   without SOFTMAX, o = sum bf16(s_r) v_r (the MASK stage's outputs are
//            ~1e31: finite in bf16, whose range is fp32's)
// Stages the probe runs: dot (0), dot+mask (MASK), dot+mask+pe+softmax
// (MASK | PE | SOFTMAX), all (every feature).
//
// Not K6 with parts cut out: K6 never reads another position's rows.  The
// probe runs at 32 positions of 8 heads of 32, a few hundred KB, so no
// bound is in reach; the design is the plainest that is right: a block a
// (group, head), a warp a query, scores a lane a row through 16-byte
// loads, the softmax on warp shuffles, the weighted sum a lane a column
// (serial over the group's rows: its time); scores in shared memory.

#include "common.cuh"

namespace vda {
namespace {

using bf16 = __nv_bfloat16;

constexpr int MASK = 1, PE = 2, SOFTMAX = 4, NEW = 8;
constexpr int WARPS = 8;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q . k over dh columns (dh % 8 == 0, 16-byte aligned rows), k with pe
// added and rounded to bf16 where pe is given
__device__ __forceinline__ float dot(const bf16* q, const bf16* k,
                                     const bf16* pe, int dh) {
  float acc = 0.f;
  for (int x = 0; x < dh; x += 8) {
    const uint4 qr = __ldg(reinterpret_cast<const uint4*>(q + x));
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + x));
    const bf16* qe = reinterpret_cast<const bf16*>(&qr);
    const bf16* ke = reinterpret_cast<const bf16*>(&kr);
    if (pe != nullptr) {
      const uint4 pr = __ldg(reinterpret_cast<const uint4*>(pe + x));
      const bf16* pv = reinterpret_cast<const bf16*>(&pr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc = fmaf(to_f(qe[j]), round_t<bf16>(to_f(ke[j]) + to_f(pv[j])), acc);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(to_f(qe[j]), to_f(ke[j]), acc);
    }
  }
  return acc;
}

template <int F>
__global__ void __launch_bounds__(WARPS * 32)
    stream_probe_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ kn,
                        const bf16* __restrict__ vn,
                        const bf16* __restrict__ kb,
                        const bf16* __restrict__ vb,
                        const bf16* __restrict__ pe,
                        const unsigned char* __restrict__ valid,
                        bf16* __restrict__ out, int rows, int c, int dh,
                        int group, float scale) {
  extern __shared__ float sm[];
  const int gi = blockIdx.x, col0 = blockIdx.y * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nr = group * rows;  // context rows of the group
  float* sc = sm + warp * (nr + group);  // scores, then the new rows'
  const long long row0 = static_cast<long long>(gi) * nr;
  const long long pos0 = static_cast<long long>(gi) * group;

  for (int i = warp; i < group; i += WARPS) {
    const bf16* qp = q + (pos0 + i) * c + col0;
    for (int r = lane; r < nr; r += 32) {
      float s = dot(qp, kb + (row0 + r) * c + col0,
                    (F & PE) ? pe + static_cast<long long>(r % rows) * c + col0
                             : nullptr,
                    dh);
      if (F & MASK) {
        const bool own = r / rows == i && valid[r % rows];
        s = __fadd_rn(__fmul_rn(s, scale), own ? 0.f : -1e30f);
      }
      sc[r] = s;
    }
    if (F & NEW)
      for (int j = lane; j < group; j += 32)
        sc[nr + j] =
            __fadd_rn(dot(qp, kn + (pos0 + j) * c + col0, nullptr, dh),
                      j == i ? 0.f : -1e30f);
    __syncwarp();
    const int ne = (F & NEW) ? nr + group : nr;  // scores that take part
    float z = 1.f;
    if (F & SOFTMAX) {
      float m = -INFINITY;
      for (int r = lane; r < ne; r += 32) m = fmaxf(m, sc[r]);
      m = warp_max(m);
      z = 0.f;
      for (int r = lane; r < ne; r += 32) {
        const float e = round_t<bf16>(expf(round_t<bf16>(sc[r] - m)));
        sc[r] = e;
        z += e;
      }
      z = warp_sum(z);
    } else {
      for (int r = lane; r < ne; r += 32) sc[r] = round_t<bf16>(sc[r]);
    }
    __syncwarp();
    for (int x = lane; x < dh; x += 32) {
      float o = 0.f;
      for (int r = 0; r < nr; ++r)
        o = fmaf(sc[r], to_f(vb[(row0 + r) * c + col0 + x]), o);
      if (F & NEW)
        for (int j = 0; j < group; ++j)
          o = fmaf(sc[nr + j], to_f(vn[(pos0 + j) * c + col0 + x]), o);
      out[(pos0 + i) * c + col0 + x] =
          __float2bfloat16((F & SOFTMAX) ? o / z : o);
    }
    __syncwarp();  // the scores are read before the next query writes them
  }
}

template <int F>
cudaError_t launch(const void* q, const void* kn, const void* vn,
                   const void* kb, const void* vb, const void* pe,
                   const unsigned char* valid, void* out, int bhw, int rows,
                   int c, int heads, int group, float scale,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(float) * WARPS * (group * rows + group);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = stream_probe_kernel<F>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kern<<<dim3(bhw / group, heads), WARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
      static_cast<const bf16*>(vn), static_cast<const bf16*>(kb),
      static_cast<const bf16*>(vb), static_cast<const bf16*>(pe), valid,
      static_cast<bf16*>(out), rows, c, c / heads, group, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vda

// q, kn, vn (BHW, C); kb, vb (BHW, rows, C); pe (rows, C); valid (rows,)
// bytes; out (BHW, C); all bf16 but valid, contiguous, 16-byte aligned.
// BHW a multiple of group; C / heads a multiple of 8.  features: 0, MASK,
// MASK | PE | SOFTMAX or all four (1, 7, 15).
extern "C" int vda_stream_probe(const void* q, const void* kn,
                                const void* vn, const void* kb,
                                const void* vb, const void* pe,
                                const void* valid, void* out, int bhw,
                                int rows, int c, int heads, int group,
                                float scale, int features, void* stream) {
  if (bhw <= 0 || rows <= 0 || group <= 0 || bhw % group || heads <= 0 ||
      c % heads || (c / heads) % 8)
    return cudaErrorInvalidValue;
  const auto* flags = static_cast<const unsigned char*>(valid);
  const auto st = static_cast<cudaStream_t>(stream);
#define VDA_STAGE(F)                                                        \
  case F:                                                                   \
    return vda::launch<F>(q, kn, vn, kb, vb, pe, flags, out, bhw, rows, c,   \
                          heads, group, scale, st)
  switch (features) {
    VDA_STAGE(0);
    VDA_STAGE(vda::MASK);
    VDA_STAGE(vda::MASK | vda::PE | vda::SOFTMAX);
    VDA_STAGE(vda::MASK | vda::PE | vda::SOFTMAX | vda::NEW);
    default:
      return cudaErrorInvalidValue;
  }
#undef VDA_STAGE
}
