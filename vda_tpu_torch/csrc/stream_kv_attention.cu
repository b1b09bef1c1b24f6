// K6: one new frame's attention over a cached context, per position and head.
//
// q, k_new, v_new are (BHW, C); k_buf, v_buf are (BHW, rows, C) cached
// projections without position encoding; pe_k, pe_v are (rows, C), the
// projected encoding of each cached row; valid is (rows,) bytes.  For each
// position b and head h, with k_r = k_buf[b, r] + pe_k[r] and v_r likewise
// (the add rounded to the working type):
//   o = sum_r e_r v_r + e_new v_new over valid r, divided by the sum of e,
//   e_r = exp(q . k_r * scale - m), m the largest score.
//
// Replaces vda_tpu/ops/pallas_stream.py stream_kv_attention
// (_stream_kv_kernel).  The TPU kernel tiled 16 positions and masked a
// block-diagonal (16, 16 * rows) score tile to fill the MXU.  Here the bound
// is bytes: a position's context is 2 x rows x C values, each used in one
// product, so the card can do nothing faster than read it once.  Written in
// CUDA C++ rather than Triton (which would serve as well, since no tensor
// core is needed) to keep the one build route of the other kernels.
//
// Two loops, chosen by (C, heads, dtype) alone (vda_stream_kv_loop):
//  * 90: bf16 at head widths a multiple of 8 up to 128, every main-path
//    shape: stream_kv_sm90.cuh (persistent blocks, the encodings staged in
//    shared memory once, a warp a (position, head) with a 32-row chunk of
//    K and V in registers, loaded before the first product).
//  * 80: fp32 and wider heads: the kernel below.  One block owns one
//    position and a group of heads: it copies the group's columns of the
//    valid context rows, and of the new row, into shared memory with
//    16-byte cp.async loads (rows that are not valid are never read) and
//    gives each head a warp.  Scores take a lane a row, the softmax runs on
//    warp shuffles, and the weighted sum takes a lane a column.  The
//    encodings, the same for every position, come through the cache.
//
// Rounding follows the TPU kernel: the encoding add in the working type, fp32
// products and sums, exp of the bf16-rounded shifted score rounded to bf16
// (bf16 only), an fp32 sum of those values, one division at the output.

#include <cuda_pipeline.h>

#include "stream_kv_sm90.cuh"

namespace vda {
namespace {

constexpr int GROUP_COLS = 128;  // staged columns of a head group
constexpr size_t MAX_SMEM = 227 * 1024;

inline int group_of(int heads, int dh) {
  if (dh > GROUP_COLS) return 1;
  return heads < GROUP_COLS / dh ? heads : GROUP_COLS / dh;
}

// Shared memory of a block: the K and V rows (rows + 1 each, the last the
// new row) at a pitch that is 16 mod 128 bytes, so 8 lanes reading 16 bytes
// from 8 consecutive rows hit distinct banks; q in fp32; each warp's scores.
struct Layout {
  int pitch;
  size_t v, q, s, bytes;
};
__host__ __device__ inline Layout layout(int rows, int width, int group,
                                         int elem) {
  Layout l;
  l.pitch = (width * elem + 127) / 128 * 128 + 16;
  l.v = static_cast<size_t>(rows + 1) * l.pitch;
  l.q = 2 * l.v;
  l.s = l.q + align128(sizeof(float) * width);
  l.bytes = l.s + sizeof(float) * group * (rows + 1);
  return l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(512)
    stream_kv_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                     const T* __restrict__ vn, const T* __restrict__ kb,
                     const T* __restrict__ vb, const T* __restrict__ pek,
                     const T* __restrict__ pev,
                     const unsigned char* __restrict__ valid,
                     T* __restrict__ out, int rows, int c, int heads, int dh,
                     int group, float scale) {
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = layout(rows, group * dh, group, sizeof(T));
  unsigned char* ks = smem;
  unsigned char* vs = smem + l.v;
  float* qs = reinterpret_cast<float*>(smem + l.q);
  float* ss = reinterpret_cast<float*>(smem + l.s);

  const long long b = blockIdx.x;
  const int h0 = blockIdx.y * group;
  const int ng = min(group, heads - h0);
  const int width = ng * dh, col0 = h0 * dh;

  // the group's columns of every valid cached row and of the new row
  const int vpr = width / VE;
  for (int i = threadIdx.x; i < (rows + 1) * vpr; i += blockDim.x) {
    const int r = i / vpr, x = (i % vpr) * VE;
    if (r < rows && !valid[r]) continue;
    const long long off = r < rows ? (b * rows + r) * c + col0 + x
                                   : b * c + col0 + x;
    const size_t dst = static_cast<size_t>(r) * l.pitch + x * sizeof(T);
    __pipeline_memcpy_async(ks + dst, (r < rows ? kb : kn) + off, 16);
    __pipeline_memcpy_async(vs + dst, (r < rows ? vb : vn) + off, 16);
  }
  __pipeline_commit();
  for (int x = threadIdx.x; x < width; x += blockDim.x)
    qs[x] = to_f(q[b * c + col0 + x]);
  __pipeline_wait_prior(0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= ng) return;
  const int hc = warp * dh;  // the head's first column within the group
  const float* qh = qs + hc;
  float* sw = ss + warp * (rows + 1);

  // scores: a lane a row; -inf marks a row that is not valid
  for (int r = lane; r <= rows; r += 32) {
    float acc = -INFINITY;
    if (r == rows || valid[r]) {
      acc = 0.f;
      const T* kr = reinterpret_cast<const T*>(ks + r * l.pitch) + hc;
      const T* pr = pek + static_cast<long long>(r) * c + col0 + hc;
      for (int x = 0; x < dh; x += VE) {
        const uint4 kraw = *reinterpret_cast<const uint4*>(kr + x);
        const T* ke = reinterpret_cast<const T*>(&kraw);
        if (r < rows) {
          const uint4 praw = __ldg(reinterpret_cast<const uint4*>(pr + x));
          const T* pe = reinterpret_cast<const T*>(&praw);
#pragma unroll
          for (int j = 0; j < VE; ++j)
            acc = fmaf(qh[x + j], round_t<T>(to_f(ke[j]) + to_f(pe[j])), acc);
        } else {  // the new row carries its encoding already
#pragma unroll
          for (int j = 0; j < VE; ++j) acc = fmaf(qh[x + j], to_f(ke[j]), acc);
        }
      }
      acc *= scale;
    }
    sw[r] = acc;
  }
  __syncwarp();

  // softmax weights, normalisation deferred
  float m = -INFINITY;
  for (int r = lane; r <= rows; r += 32) m = fmaxf(m, sw[r]);
  m = warp_max(m);  // finite: the new row always takes part
  float z = 0.f;
  for (int r = lane; r <= rows; r += 32) {
    const float e =
        sw[r] == -INFINITY ? 0.f : round_t<T>(expf(round_t<T>(sw[r] - m)));
    sw[r] = e;
    z += e;
  }
  z = warp_sum(z);
  __syncwarp();

  // weighted sum of the value rows: a lane a column
  for (int x = lane; x < dh; x += 32) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      if (!valid[r]) continue;
      const float vv = to_f(reinterpret_cast<const T*>(vs + r * l.pitch)[hc + x]);
      const float pv = to_f(pev[static_cast<long long>(r) * c + col0 + hc + x]);
      acc = fmaf(sw[r], round_t<T>(vv + pv), acc);
    }
    acc = fmaf(sw[rows],
               to_f(reinterpret_cast<const T*>(vs + rows * l.pitch)[hc + x]),
               acc);
    out[b * c + col0 + hc + x] = from_f<T>(acc / z);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kn, const void* vn,
                   const void* kb, const void* vb, const void* pek,
                   const void* pev, const unsigned char* valid, void* out,
                   int bhw, int rows, int c, int heads, float scale,
                   cudaStream_t stream) {
  const int dh = c / heads, group = group_of(heads, dh);
  const Layout l = layout(rows, group * dh, group, sizeof(T));
  if (l.bytes > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = stream_kv_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(bhw, (heads + group - 1) / group);
  kern<<<grid, 32 * group, l.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const T*>(kb),
      static_cast<const T*>(vb), static_cast<const T*>(pek),
      static_cast<const T*>(pev), valid, static_cast<T*>(out), rows, c, heads,
      dh, group, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t stream_kv_sm80(const void* q, const void* kn, const void* vn,
                           const void* kb, const void* vb, const void* pek,
                           const void* pev, const unsigned char* valid,
                           void* out, int bhw, int rows, int c, int heads,
                           float scale, bool is_bf16, cudaStream_t stream) {
  if (bhw <= 0 || rows < 0 || heads <= 0 || c % heads || (c / heads) % 8 ||
      c / heads > 512)
    return cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kn, vn, kb, vb, pek, pev, valid, out,
                                 bhw, rows, c, heads, scale, stream);
  return launch<float>(q, kn, vn, kb, vb, pek, pev, valid, out, bhw, rows, c,
                       heads, scale, stream);
}

}  // namespace vda

// The loop vda_stream_kv_attention runs at this shape: 90 (the Hopper loop
// of stream_kv_sm90.cuh) or 80 (the kernel above).
extern "C" int vda_stream_kv_loop(int c, int heads, int is_bf16) {
  return is_bf16 && vda::stream90::takes(c, heads) ? 90 : 80;
}

extern "C" int vda_stream_kv_attention(const void* q, const void* kn,
                                       const void* vn, const void* kb,
                                       const void* vb, const void* pek,
                                       const void* pev, const void* valid,
                                       void* out, int bhw, int rows, int c,
                                       int heads, float scale, int is_bf16,
                                       void* stream) {
  const auto* flags = static_cast<const unsigned char*>(valid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vda_stream_kv_loop(c, heads, is_bf16) == 90)
    return vda::stream90::launch<vda::stream90::kFull>(
        q, kn, vn, kb, vb, pek, pev, flags, out, bhw, rows, c, heads, scale,
        0, st);
  return vda::stream_kv_sm80(q, kn, vn, kb, vb, pek, pev, flags, out, bhw,
                             rows, c, heads, scale, is_bf16 != 0, st);
}
