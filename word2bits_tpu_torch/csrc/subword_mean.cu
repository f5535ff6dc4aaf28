// Ragged gather-mean of the subword model's input rows, for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no subword model.  For each
// word b of a list, its rows G (fastText's subword rows: the word's own
// row and one bucket row per n-gram, a CSR of offsets and ids) are read
// from the input table, each quantized on read, summed in float32 in the
// CSR's order and divided by |G|:
//
//   h[b] = (sum_{j < |G|} quantize(u[ids[off[w_b] + j]])) / |G|   (float32)
//
// the hidden vector of fastText's computeHidden, and its getWordVector
// when the words are a block of the vocabulary (the export).
//
// Bound on the H100 (3.35 TB/s): bytes.  Each word's |G| rows read once,
// its ids and offsets, h written once: at B = 8192, D = 300, float32 and
// a mean |G| of 18.9 (the fasttext cell; 153,585 rows), 195 MB, 58 us.
//
// Time (NVIDIA H100 80GB HBM3, 700 W; CUDA events over 20 launches behind
// a sleep kernel, chip_smoke.py's [subword]): 177 us at that shape, 3.0x
// its bound, 122 registers and no spill; the plain version 4.24 ms.
//
// Design.  One warp a word, eight words a CTA.  A lane owns columns four
// at a time (float4 loads where the width and alignment allow, else one
// at a time), up to 512 columns a pass; the warp walks the word's rows in
// the CSR's order, four rows' loads in flight, and each lane adds its
// quantized columns in that order with plain float32 adds, then divides
// by |G| once (__fdiv_rn): the same bits as the plain version's sum row by
// row (kernels/subword_mean.py).  The ids are read by every lane of the
// warp (one broadcast load); no shared memory, no atomics, no allocation
// and no synchronisation with the host.
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "w2b_common.cuh"

namespace {

constexpr int THREADS = 256;              // 8 warps, one word each
constexpr int WARPS = THREADS / 32;
constexpr int VEC_PER_LANE = 4;           // float4 a lane a pass: 512 cols
constexpr int SCALAR_PER_LANE = 16;       // scalars a lane a pass: 512 cols
constexpr int ROWS_IN_FLIGHT = 4;

struct Args {
  const int64_t* words;
  const int64_t* offsets;
  const int32_t* ids;
  float* out;
  int B, D, bitlevel;
};

__device__ __forceinline__ float4 quantize4(float4 x, int bl) {
  return make_float4(w2b::quantize(x.x, bl), w2b::quantize(x.y, bl),
                     w2b::quantize(x.z, bl), w2b::quantize(x.w, bl));
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// float32 rows, D % 4 == 0, 16-byte aligned: a lane's columns as float4
__global__ void __launch_bounds__(THREADS)
subword_mean_kernel_vec(const float* __restrict__ table, const Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int64_t w = a.words[b];
  const int64_t r0 = a.offsets[w], n = a.offsets[w + 1] - r0;
  const int nv = a.D / 4;
  const float fn = (float)n;
  for (int v0 = 0; v0 < nv; v0 += 32 * VEC_PER_LANE) {
    float4 acc[VEC_PER_LANE];
#pragma unroll
    for (int k = 0; k < VEC_PER_LANE; ++k) acc[k] = make_float4(0, 0, 0, 0);
    for (int64_t j0 = 0; j0 < n; j0 += ROWS_IN_FLIGHT) {
      float4 x[ROWS_IN_FLIGHT][VEC_PER_LANE];
#pragma unroll
      for (int t = 0; t < ROWS_IN_FLIGHT; ++t) {
        if (j0 + t < n) {
          const float4* row = reinterpret_cast<const float4*>(
              table + (int64_t)a.ids[r0 + j0 + t] * a.D);
#pragma unroll
          for (int k = 0; k < VEC_PER_LANE; ++k) {
            const int v = v0 + lane + 32 * k;
            if (v < nv) x[t][k] = __ldg(row + v);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < ROWS_IN_FLIGHT; ++t) {
        if (j0 + t < n) {
#pragma unroll
          for (int k = 0; k < VEC_PER_LANE; ++k)
            if (v0 + lane + 32 * k < nv)
              add4(acc[k], quantize4(x[t][k], a.bitlevel));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < VEC_PER_LANE; ++k) {
      const int v = v0 + lane + 32 * k;
      if (v < nv) {
        float4 o;
        o.x = __fdiv_rn(acc[k].x, fn);
        o.y = __fdiv_rn(acc[k].y, fn);
        o.z = __fdiv_rn(acc[k].z, fn);
        o.w = __fdiv_rn(acc[k].w, fn);
        reinterpret_cast<float4*>(a.out + (int64_t)b * a.D)[v] = o;
      }
    }
  }
}

// any width and storage type: a lane's columns one at a time
template <typename T>
__global__ void __launch_bounds__(THREADS)
subword_mean_kernel(const T* __restrict__ table, const Args a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int64_t w = a.words[b];
  const int64_t r0 = a.offsets[w], n = a.offsets[w + 1] - r0;
  const float fn = (float)n;
  for (int c0 = 0; c0 < a.D; c0 += 32 * SCALAR_PER_LANE) {
    float acc[SCALAR_PER_LANE];
#pragma unroll
    for (int k = 0; k < SCALAR_PER_LANE; ++k) acc[k] = 0.0f;
    for (int64_t j0 = 0; j0 < n; j0 += ROWS_IN_FLIGHT) {
      float x[ROWS_IN_FLIGHT][SCALAR_PER_LANE];
#pragma unroll
      for (int t = 0; t < ROWS_IN_FLIGHT; ++t) {
        if (j0 + t < n) {
          const T* row = table + (int64_t)a.ids[r0 + j0 + t] * a.D;
#pragma unroll
          for (int k = 0; k < SCALAR_PER_LANE; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c < a.D) x[t][k] = w2b::to_f32(row[c]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < ROWS_IN_FLIGHT; ++t) {
        if (j0 + t < n) {
#pragma unroll
          for (int k = 0; k < SCALAR_PER_LANE; ++k)
            if (c0 + lane + 32 * k < a.D)
              acc[k] = __fadd_rn(acc[k], w2b::quantize(x[t][k], a.bitlevel));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SCALAR_PER_LANE; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < a.D) a.out[(int64_t)b * a.D + c] = __fdiv_rn(acc[k], fn);
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// table [rows, D] (dtype 0 float32, 1 bfloat16), words [B] int64 (ids of
// the CSR's words), offsets [V + 1] int64, ids [offsets[V]] int32,
// out [B, D] float32: all contiguous.  Returns cudaGetLastError() after
// the launch (0 = launched).
int w2b_subword_mean(const void* table, int dtype, const int64_t* words,
                     const int64_t* offsets, const int32_t* ids, float* out,
                     int B, int D, int bitlevel, void* stream) {
  if (B < 0 || D < 1 || bitlevel < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{words, offsets, ids, out, B, D, bitlevel};
  const dim3 grid((B + WARPS - 1) / WARPS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D % 4 == 0 && aligned16(table) && aligned16(out))
    subword_mean_kernel_vec<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(table), a);
  else if (dtype == 0)
    subword_mean_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(table), a);
  else
    subword_mean_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), a);
  return (int)cudaGetLastError();
}

}  // extern "C"
