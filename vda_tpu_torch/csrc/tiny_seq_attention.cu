// K5: softmax attention inside each short sequence, per head.
//
// q, k, v are (BD, T, C) with T <= 64 and heads of width dh = C / heads, a
// multiple of 8.  The three share one layout: element (b, t, col) lives at
// b * seq_stride + t * row_stride + col, so they may be column slices of one
// fused (BD, T, 3C) projection.  The output is a contiguous (BD, T, C).
//
// Replaces vda_tpu/ops/pallas_attention.py tiny_seq_attention
// (_tiny_seq_kernel).  The TPU kernel filled the 128x128 MXU by masking a
// block-diagonal (512 x 512) score tile over 16 sequences at once.  Here the
// bound is bytes: every input byte is needed once and the products are few
// (4 T^2 C a sequence, ~16 operations a byte at T = 32 and dh = 8).
//
// Two codes, chosen by (T, C, heads, dtype) alone (vda_tiny_seq_loop):
//  * 90: bf16 at the shapes tiny_seq_sm90.cuh takes (every main path, head
//    widths 8-128 and 192): its TMA ring and tensor-core products (T >= 2),
//    a warp per 256 columns of a position (T = 1);
//  * 80: fp32 and the rest: the kernel below, in which one
//    block owns one sequence and a group of heads, copies that group's columns
// of the sequence into shared memory once (16-byte coalesced loads, turned
// into fp32 there so no lane converts a value another lane converts too),
// and gives each head a warp and each query row a lane: the lane keeps its
// row's T scores in registers and reads K and V rows as warp-wide broadcasts.
// The output goes through shared memory and leaves in whole rows.  Heads
// wider than 128 columns are walked in 64-column chunks, the scores summed
// over the chunks, so any multiple of 8 fits.  T > 32 runs in two sets of 32
// query rows.
//
// Rounding follows the TPU kernel: fp32 products and sums, the scale applied
// to the sum, exp of the bf16-rounded shifted score rounded to bf16 (bf16
// only), an fp32 row sum of those values, and one division at the output.

#include "tiny_seq_sm90.cuh"

namespace vda {
namespace {

constexpr int GROUP_COLS = 128;  // staged columns of a head group
constexpr int CHUNK = 64;        // columns of a chunk of a wider head

// Row pitch, in floats, of a staged tile `cols` wide: 16-byte rows whose
// starts step 4 banks apart, so the 8 lanes of a quarter warp reading 16
// bytes from 8 consecutive rows hit 32 distinct banks.
__host__ __device__ inline int pitch_of(int cols) {
  return ((cols + 31) / 32) * 32 + 4;
}

// Head grouping: `group` heads a block; `chunk` columns staged at a time.
struct Plan {
  int group, chunk;
};
inline Plan plan(int heads, int dh) {
  if (dh <= GROUP_COLS)
    return {heads < GROUP_COLS / dh ? heads : GROUP_COLS / dh, dh};
  return {1, CHUNK};
}

// rows [row0, row0 + nrows) x columns [col0, col0 + width) of a strided
// tensor into a float tile (row r at dst + r * pitch).
template <typename T>
__device__ void stage(float* dst, const T* src, int row0, int nrows, int width,
                      int col0, long long row_stride, int pitch) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = width / VE;
  for (int i = threadIdx.x; i < nrows * vpr; i += blockDim.x) {
    const int r = i / vpr, x = (i % vpr) * VE;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        src + static_cast<long long>(row0 + r) * row_stride + col0 + x);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * pitch + x;
#pragma unroll
    for (int j = 0; j < VE; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(to_f(e[j]), to_f(e[j + 1]), to_f(e[j + 2]),
                      to_f(e[j + 3]));
  }
}

// the inverse: a float tile into rows of a contiguous (.., C) output
template <typename T>
__device__ void unstage(T* dst, const float* src, int row0, int nrows,
                        int width, int col0, int c, int pitch) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = width / VE;
  for (int i = threadIdx.x; i < nrows * vpr; i += blockDim.x) {
    const int r = i / vpr, x = (i % vpr) * VE;
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
    const float* s = src + r * pitch + x;
#pragma unroll
    for (int j = 0; j < VE; ++j) e[j] = from_f<T>(s[j]);
    *reinterpret_cast<uint4*>(
        dst + static_cast<long long>(row0 + r) * c + col0 + x) = raw;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// TM: capacity of a lane's score array, at least t (1, 8, 16, 32 or 64).
template <typename T, int TM>
__global__ void __launch_bounds__(512)
    tiny_seq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int t, int c,
                    int heads, int dh, int group, int chunk,
                    long long seq_stride, long long row_stride, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = pitch_of(group * chunk);
  float* as = smem;                       // q rows of a row set, then output
  float* bs = smem + min(t, 32) * pitch;  // k or v rows

  const int h0 = blockIdx.y * group;
  const int ng = min(group, heads - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long in = static_cast<long long>(blockIdx.x) * seq_stride;
  T* out = o + static_cast<long long>(blockIdx.x) * t * c;
  const int n_chunks = (dh + chunk - 1) / chunk;

  for (int r0 = 0; r0 < t; r0 += 32) {
    const int nr = min(32, t - r0);
    const bool active = warp < ng && lane < nr;
    float s[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) s[j] = 0.f;

    // scores of query row r0 + lane against every key, summed over chunks
    for (int ch = 0; ch < n_chunks; ++ch) {
      // one chunk of every head of the group: contiguous columns, because
      // either the group is one head or the chunk is a whole head
      const int cw = min(chunk, dh - ch * chunk);
      const int col0 = h0 * dh + ch * chunk;
      __syncthreads();  // the previous chunk's readers are done
      stage(as, q + in, r0, nr, ng * cw, col0, row_stride, pitch);
      stage(bs, k + in, 0, t, ng * cw, col0, row_stride, pitch);
      __syncthreads();
      if (active) {
        const float* qr = as + lane * pitch + warp * cw;
        const float* kc = bs + warp * cw;
        for (int x = 0; x < cw; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + x);
#pragma unroll
          for (int j = 0; j < TM; ++j)
            if (j < t)
              s[j] = dot4(qv,
                          *reinterpret_cast<const float4*>(kc + j * pitch + x),
                          s[j]);
        }
      }
    }

    // softmax weights, normalisation deferred
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < TM; ++j)
      if (j < t) {
        s[j] *= scale;
        m = fmaxf(m, s[j]);
      }
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < TM; ++j)
      if (j < t) {
        s[j] = round_t<T>(expf(round_t<T>(s[j] - m)));
        z += s[j];
      }

    // output rows: weights times V, chunk by chunk
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int cw = min(chunk, dh - ch * chunk);
      const int col0 = h0 * dh + ch * chunk;
      __syncthreads();  // q (or the previous output chunk) has been read
      stage(bs, v + in, 0, t, ng * cw, col0, row_stride, pitch);
      __syncthreads();
      if (active) {
        float* orow = as + lane * pitch + warp * cw;
        const float* vc = bs + warp * cw;
        for (int x = 0; x < cw; x += 4) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < TM; ++j)
            if (j < t) {
              const float4 vv =
                  *reinterpret_cast<const float4*>(vc + j * pitch + x);
              acc.x = fmaf(s[j], vv.x, acc.x);
              acc.y = fmaf(s[j], vv.y, acc.y);
              acc.z = fmaf(s[j], vv.z, acc.z);
              acc.w = fmaf(s[j], vv.w, acc.w);
            }
          *reinterpret_cast<float4*>(orow + x) =
              make_float4(acc.x / z, acc.y / z, acc.z / z, acc.w / z);
        }
      }
      __syncthreads();
      unstage(out, as, r0, nr, ng * cw, col0, c, pitch);
    }
  }
}

template <typename T, int TM>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bd, int t, int c, int heads, long long seq_stride,
                   long long row_stride, float scale, cudaStream_t stream) {
  const int dh = c / heads;
  const Plan p = plan(heads, dh);
  const dim3 grid(bd, (heads + p.group - 1) / p.group);
  const size_t bytes =
      sizeof(float) * ((t < 32 ? t : 32) + t) * pitch_of(p.group * p.chunk);
  auto kern = tiny_seq_kernel<T, TM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  kern<<<grid, 32 * p.group, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, c, heads, dh, p.group,
      p.chunk, seq_stride, row_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bd, int t, int c, int heads, long long seq_stride,
                     long long row_stride, float scale, cudaStream_t st) {
  if (t == 1)
    return launch<T, 1>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                        scale, st);
  if (t <= 8)
    return launch<T, 8>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                        scale, st);
  if (t <= 16)
    return launch<T, 16>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                         scale, st);
  if (t <= 32)
    return launch<T, 32>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                         scale, st);
  return launch<T, 64>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                       scale, st);
}

}  // namespace

// The kernel above at any shape the entry point admits, bf16 or fp32.
cudaError_t tiny_seq_sm80(const void* q, const void* k, const void* v,
                          void* o, int bd, int t, int c, int heads,
                          long long seq_stride, long long row_stride,
                          float scale, bool is_bf16, cudaStream_t st) {
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bd, t, c, heads, seq_stride,
                                   row_stride, scale, st);
  return dispatch<float>(q, k, v, o, bd, t, c, heads, seq_stride, row_stride,
                         scale, st);
}

}  // namespace vda

// The code vda_tiny_seq_attention runs at this shape: 90 (the Hopper code of
// tiny_seq_sm90.cuh) or 80 (the kernel above).
extern "C" int vda_tiny_seq_loop(int t, int c, int heads, int is_bf16) {
  return is_bf16 && vda::tiny90::takes(t, c, heads) ? 90 : 80;
}

extern "C" int vda_tiny_seq_attention(const void* q, const void* k,
                                      const void* v, void* o, int bd, int t,
                                      int c, int heads, long long seq_stride,
                                      long long row_stride, float scale,
                                      int is_bf16, void* stream) {
  const int align = is_bf16 ? 8 : 4;  // elements in 16 bytes
  if (bd <= 0 || t <= 0 || t > 64 || heads <= 0 || c % heads ||
      (c / heads) % 8 || seq_stride % align || row_stride % align)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vda_tiny_seq_loop(t, c, heads, is_bf16) == 90)
    return vda::tiny90::launch<vda::tiny90::Mode::kFull>(
        q, k, v, o, bd, t, c, heads, seq_stride, row_stride, scale, 0, st);
  return vda::tiny_seq_sm80(q, k, v, o, bd, t, c, heads, seq_stride,
                            row_stride, scale, is_bf16 != 0, st);
}
