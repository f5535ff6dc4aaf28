// Elementwise quantize of a float32 or bfloat16 array, for sm_90a: kernel 4,
// the pass the export, `cli convert` and `cli nearest` run when
// quantization IS the operation (kernels/quantize_pallas.py).
//
// Replaces the TPU kernel of the JAX package's kernels/quantize_pallas.py
// (`_quantize_kernel`, called through `quantize_pallas`): [block_rows, C]
// tiles streamed HBM -> VMEM -> HBM, quantize_values on each tile.  On the
// card there is nothing to tile: each thread takes 16 bytes (4 float32 or 8
// bfloat16 values) per iteration of a grid-stride loop over the flat array,
// so every load and store is one 16-byte access on neighbouring addresses.
//
// Numerics (bit-equal to ops/quantize.quantize and the JAX op):
//   * float32: w2b::quantize, every multiply, add and divide rounded on its
//     own (no fused multiply-add);
//   * bfloat16: the JAX op and the plain PyTorch version round EVERY
//     intermediate to bfloat16 (mag * seg, + 0.5, casted / seg, and 1 / 3
//     at bitlevel 1), so this path rounds after each operation as well.
//     Computing in float32 and rounding once differs at bitlevel >= 4 (at
//     bitlevel 9, in about one value in eight: odd integers above 128 plus
//     0.5 tie to even in bfloat16).
// Every bitlevel launches, 0 (a copy) and the bitlevel-3 hole (x * 0)
// included, as the Pallas call does.
//
// Bound on the H100 (3.35 TB/s): bytes, the input read once and the output
// written once: 0.040 ms for one 20,971 x 800 float32 export block, 7.07 ms
// for the whole 3,699,941 x 800 float32 sum of the capacity export.
#include <stdint.h>

#include "w2b_common.cuh"

namespace {

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ops/quantize.quantize on a bfloat16 value, each intermediate rounded to
// bfloat16 as the per-op PyTorch version rounds it (the products and the
// division by a power of two are exact; the rounding that matters is of
// mag * seg + 0.5).
__device__ __forceinline__ float quantize_bf16(float x, int bitlevel) {
  if (bitlevel == 0) return x;
  const float sign = x < 0.0f ? -1.0f : 1.0f;
  const float mag = fabsf(x);
  if (bitlevel == 1) return __fmul_rn(sign, bf16_round(__fdiv_rn(1.0f, 3.0f)));
  if (bitlevel == 2) return __fmul_rn(sign, mag <= 0.5f ? 0.25f : 0.75f);
  if (bitlevel == 3) return __fmul_rn(x, 0.0f);  // the reference hole
  const float seg = ldexpf(1.0f, bitlevel - 1);
  float casted = bf16_round(__fadd_rn(bf16_round(__fmul_rn(mag, seg)), 0.5f));
  casted = fminf(floorf(casted), bf16_round(seg));
  return __fmul_rn(sign, bf16_round(__fdiv_rn(casted, bf16_round(seg))));
}

template <typename T>
__device__ __forceinline__ T quantize_one(T x, int bitlevel);
template <>
__device__ __forceinline__ float quantize_one<float>(float x, int bitlevel) {
  return w2b::quantize(x, bitlevel);
}
template <>
__device__ __forceinline__ __nv_bfloat16 quantize_one<__nv_bfloat16>(
    __nv_bfloat16 x, int bitlevel) {
  return __float2bfloat16_rn(quantize_bf16(__bfloat162float(x), bitlevel));
}

// VEC values of T per 16-byte access (VEC == 1: one value, any alignment)
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                int bitlevel) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_vec = n / VEC;
  if constexpr (VEC > 1) {
    static_assert(sizeof(T) * VEC == 16, "one 16-byte access per vector");
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (int64_t i = first; i < n_vec; i += stride) {
      uint4 raw = xv[i];
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) vals[k] = quantize_one<T>(vals[k], bitlevel);
      ov[i] = raw;
    }
  }
  // the tail past the last whole vector (all of it when VEC == 1)
  for (int64_t i = n_vec * VEC + first; i < n; i += stride)
    out[i] = quantize_one<T>(x[i], bitlevel);
}

template <typename T>
int launch(const void* x, void* out, int64_t n, int bitlevel,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(out);
  const int64_t items = vec ? n / VEC : n;
  const int threads = 256;
  // enough CTAs for every SM many times over; the loop covers the rest
  int64_t ctas = (items + threads - 1) / threads;
  if (ctas > 132 * 32) ctas = 132 * 32;
  if (ctas < 1) ctas = 1;
  if (vec)
    quantize_kernel<T, VEC><<<(int)ctas, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, bitlevel);
  else
    quantize_kernel<T, 1><<<(int)ctas, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, bitlevel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = quantize(x[i], bitlevel) for n values; dtype 0 = float32,
// 1 = bfloat16; x and out do not overlap.  Returns
// cudaGetLastError() after the launch (0 = launched).
int w2b_quantize(const void* x, void* out, long long n, int bitlevel,
                 int dtype, void* stream) {
  if (n < 0 || bitlevel < 0 || bitlevel > 126)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, n, bitlevel, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, n, bitlevel, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
