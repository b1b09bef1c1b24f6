// K10's Hopper kernel: bf16 NHWC bilinear upsample with align_corners=True.
//
// The function, as the TPU kernel computes it: output row i is the fp32
// lerp r0 * (1 - t) + r1 * t of input rows i0 and i1 (t the fp32 weight of
// the row tables, not rounded), rounded to bf16; output column j then sums
// the two taps of that row at columns j0 and j1 weighted by the bf16-rounded
// entries of the (W_out, W_in) interpolation matrix (one tap of weight 1 at
// the clipped edge), accumulated in fp32 and rounded once.  The TPU ran the
// W pass as a dense MXU matmul because that is how a TPU does a 2-tap
// filter; the matrix has two nonzeros a row, so here the two taps are read
// directly.  Both products of the W pass are exact in fp32 (bf16 times
// bf16), so the sum has one rounding whatever its order; every step uses
// __fmul_rn/__fadd_rn, so nvcc contracts nothing into an FMA and the kernel
// is bit-exact with its plain twin.
//
// What bounds it on the H100: bytes (a few operations an element), most of
// them the output's (vitl: 717 MB written for 179 MB read at 148 -> 296).
// The design follows the TPU kernel's two passes: a block lerps an output
// row's two input rows once into a bf16 row in shared memory (a channel
// slice of 37.9 KB at both vitl shapes: 128 channels at 148 -> 296, 64 at
// 296 -> 518), each thread with 4 input vectors of each row in flight;
// then makes each output pixel of the slice from two taps of that row and
// writes it with 16-byte streaming stores (st.global.cs: the output is not
// read again here).  Blocks are persistent and walk the (batch, output
// row, slice) units in order, so the blocks in flight share their input
// rows through L2 and one block's loads overlap another's stores; the
// column tables live in shared memory for the whole run.  At most 3
// blocks of 256 threads run on an SM (4-5 would fit and ran 3-8% slower),
// the shared memory carved out for just those, so L1 keeps the rest.  The
// input may be strided along B, H and W.
//
// The parts the design-step probe times (resize_sm90_variants.cu) are
// configurations of the same kernel: kLoads reads the input rows and
// writes nothing, kStores writes zeros to every output vector and reads
// nothing.
#pragma once

#include "common.cuh"

namespace vda {
namespace resize90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory

enum Part : int { kFull = 0, kLoads = 1, kStores = 2 };

// The widest channel slice (128 down to 8) whose lerped row fits 40 KB:
// 128 channels at 148 -> 296, 64 at 296 -> 518, 37.9 KB each (80 KB
// slices ran 0.3-1.4% slower, 20 KB slices with no cap on the blocks
// 10-13%).
constexpr size_t kSliceBudget = 40 * 1024;
// Blocks an SM (5 fit at the vitl shapes; 2 ran 10-11% slower).
constexpr int kMaxBlocks = 3;

// x: (B, H, W, C) bf16 with element strides sb, sh, sw and unit channel
// stride; out: contiguous (B, OH, OW, C); itab: i0 (oh) | i1 (oh) | j0 (ow)
// | j1 (ow); ftab: w1 (oh) | m0 (ow) | m1 (ow).
struct Args {
  const bf16* x;
  bf16* out;
  const int* itab;
  const float* ftab;
  int b, w, oh, ow, c;
  long long sb, sh, sw;
  int keep;  // 0: the parts' results are kept alive on a branch no run takes
};

// Shared memory: the lerped row slice (w x cs bf16), then per output column
// its two tap offsets (int2) and weights (float2).
__host__ __device__ inline size_t slice_bytes(int w, int cs) {
  return (static_cast<size_t>(w) * cs * sizeof(bf16) + 15) / 16 * 16;
}

__device__ __forceinline__ float lerp_row(bf16 a, bf16 b, float s, float t) {
  return round_t<bf16>(
      __fadd_rn(__fmul_rn(to_f(a), s), __fmul_rn(to_f(b), t)));
}

// 8 channels of the lerped row from 8 of each input row.
__device__ __forceinline__ uint4 lerp8(const uint4& ra, const uint4& rb,
                                       float s, float t) {
  const bf16* e0 = reinterpret_cast<const bf16*>(&ra);
  const bf16* e1 = reinterpret_cast<const bf16*>(&rb);
  uint4 res;
  bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    r[e] = from_f<bf16>(lerp_row(e0[e], e1[e], s, t));
  return res;
}

// Output vector ch of column j: the two taps of the lerped row at tap
// offsets tp (elements) with weights m, summed in fp32, rounded once.
__device__ __forceinline__ uint4 tap8(const bf16* row, int2 tp, float2 m,
                                      int ch) {
  const uint4 ua = *reinterpret_cast<const uint4*>(row + tp.x + ch);
  const uint4 ub = *reinterpret_cast<const uint4*>(row + tp.y + ch);
  const bf16* ea = reinterpret_cast<const bf16*>(&ua);
  const bf16* eb = reinterpret_cast<const bf16*>(&ub);
  uint4 res;
  bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    r[e] = from_f<bf16>(
        __fadd_rn(__fmul_rn(m.x, to_f(ea[e])), __fmul_rn(m.y, to_f(eb[e]))));
  return res;
}

__device__ __forceinline__ uint32_t fold(const uint4& u) {
  return u.x ^ u.y ^ u.z ^ u.w;
}

__device__ __forceinline__ void store_streaming(bf16* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The column tables in shared memory: tap offsets j0 * cs, j1 * cs and the
// weights m0, m1 of each output column.
template <int CS>
__device__ __forceinline__ void stage_tables(const Args& a, int2* taps,
                                             float2* wts, int threads) {
  const int* j0 = a.itab + 2 * a.oh;
  const int* j1 = j0 + a.ow;
  const float* m0 = a.ftab + a.oh;
  const float* m1 = m0 + a.ow;
  for (int j = threadIdx.x; j < a.ow; j += threads) {
    taps[j] = make_int2(j0[j] * CS, j1[j] * CS);
    wts[j] = make_float2(m0[j], m1[j]);
  }
}

// Unit u is (batch b, output row i, slice s), slices fastest.
template <int CS, int PART>
__global__ void __launch_bounds__(kThreads) resize90_kernel(const Args a) {
  constexpr int CV = CS / 8;  // 16-byte vectors of a pixel's slice
  constexpr int UNROLL = 4;   // input vectors of a row a thread keeps in
                              // flight
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* row = reinterpret_cast<bf16*>(smem);
  int2* taps = reinterpret_cast<int2*>(smem + slice_bytes(a.w, CS));
  float2* wts = reinterpret_cast<float2*>(taps + a.ow);
  stage_tables<CS>(a, taps, wts, kThreads);
  __syncthreads();

  const int* i0 = a.itab;
  const int* i1 = i0 + a.oh;
  const float* w1 = a.ftab;
  const int slices = a.c / CS;
  const long long units = static_cast<long long>(a.b) * a.oh * slices;
  const int n_in = a.w * CV, n_out = a.ow * CV;
  uint32_t keep = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int s = static_cast<int>(u % slices);
    const long long bi = u / slices;
    const int i = static_cast<int>(bi % a.oh);
    const long long b = bi / a.oh;
    if (PART != kStores) {
      // lerp the slice of input rows i0, i1 into the shared row
      const bf16* x0 = a.x + b * a.sb + i0[i] * a.sh + s * CS;
      const bf16* x1 = a.x + b * a.sb + i1[i] * a.sh + s * CS;
      const float t = w1[i], sf = __fsub_rn(1.f, t);
      for (int v0 = threadIdx.x; v0 < n_in; v0 += UNROLL * kThreads) {
        uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int v = v0 + k * kThreads;
          if (v < n_in) {
            const long long off = (v / CV) * a.sw + (v % CV) * 8;
            ra[k] = __ldg(reinterpret_cast<const uint4*>(x0 + off));
            rb[k] = __ldg(reinterpret_cast<const uint4*>(x1 + off));
          }
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int v = v0 + k * kThreads;
          if (v >= n_in) continue;
          if (PART == kLoads)
            keep ^= fold(ra[k]) ^ fold(rb[k]);
          else
            *reinterpret_cast<uint4*>(row + 8 * v) =
                lerp8(ra[k], rb[k], sf, t);
        }
      }
      if (PART == kLoads) continue;
      __syncthreads();
    }
    // the slice of output row i: two taps of the shared row a vector
    bf16* o = a.out + ((b * a.oh + i) * a.ow) * a.c + s * CS;
    for (int v = threadIdx.x; v < n_out; v += kThreads) {
      const int j = v / CV, ch = (v % CV) * 8;
      store_streaming(o + static_cast<long long>(j) * a.c + ch,
                      PART == kStores ? make_uint4(0, 0, 0, 0)
                                      : tap8(row, taps[j], wts[j], ch));
    }
    if (PART != kStores) __syncthreads();  // the row is rewritten next
  }
  if (a.keep) reinterpret_cast<uint32_t*>(a.out)[threadIdx.x] = keep;
}

template <int CS, int PART>
cudaError_t launch_cs(const Args& a, cudaStream_t st) {
  const size_t smem = slice_bytes(a.w, CS) + static_cast<size_t>(a.ow) * 16;
  const int sms = device_sms();
  if (smem > kMaxSmem || sms < 1) return cudaErrorInvalidValue;
  auto kern = resize90_kernel<CS, PART>;
  int per_sm = 0;
  const cudaError_t e =
      fit_blocks(kern, kThreads, smem, kMaxBlocks, &per_sm);
  if (e != cudaSuccess) return e;
  const long long units = static_cast<long long>(a.b) * a.oh * (a.c / CS);
  const long long fit = static_cast<long long>(per_sm) * sms;
  kern<<<static_cast<int>(units < fit ? units : fit), kThreads, smem, st>>>(
      a);
  return cudaGetLastError();
}

inline bool valid_args(const Args& a) {
  return a.b > 0 && a.w > 0 && a.oh > 0 && a.ow > 0 && a.c > 0 &&
         a.c % 8 == 0 && a.sb % 8 == 0 && a.sh % 8 == 0 && a.sw % 8 == 0;
}

// Launch configuration PART of the kernel: the widest channel slice (128
// down to 8) that divides C and whose lerped row fits kSliceBudget, the
// narrowest if none does.
template <int PART>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if (!valid_args(a)) return cudaErrorInvalidValue;
  const auto fits = [&](int cs) {
    return a.c % cs == 0 && slice_bytes(a.w, cs) <= kSliceBudget;
  };
  if (fits(128)) return launch_cs<128, PART>(a, st);
  if (fits(64)) return launch_cs<64, PART>(a, st);
  if (fits(32)) return launch_cs<32, PART>(a, st);
  if (fits(16)) return launch_cs<16, PART>(a, st);
  return launch_cs<8, PART>(a, st);
}

}  // namespace resize90
}  // namespace vda
