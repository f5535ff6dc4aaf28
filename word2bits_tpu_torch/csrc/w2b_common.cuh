// Shared __device__ building blocks of the port's kernels: dtype
// conversion, the reference quantizer and the reference's two sigmoids.
//
// Bit-equality with the plain PyTorch versions (ops/quantize.py,
// ops/sigmoid.py): every multiply, add and divide that the plain version
// rounds separately is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts
// into a fused multiply-add.  `mag*seg + 0.5` and `(f + 6)*83` would
// otherwise round once instead of twice.  Everything is computed in float32
// (at bitlevel 1, q = +-1/3 is not exact in bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace w2b {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ops/quantize.quantize (reference src/word2bits.cpp:73-108).  x == -0.0
// takes sign +1 (`x < 0` is false), as the reference's `num < 0 ? -1 : 1`.
__device__ __forceinline__ float quantize(float x, int bitlevel) {
  if (bitlevel == 0) return x;
  const float sign = x < 0.0f ? -1.0f : 1.0f;
  const float mag = fabsf(x);
  if (bitlevel == 1) return __fmul_rn(sign, __fdiv_rn(1.0f, 3.0f));
  if (bitlevel == 2) return __fmul_rn(sign, mag <= 0.5f ? 0.25f : 0.75f);
  if (bitlevel == 3) return __fmul_rn(x, 0.0f);  // the reference hole
  const float seg = ldexpf(1.0f, bitlevel - 1);
  float casted = floorf(__fadd_rn(__fmul_rn(mag, seg), 0.5f));
  casted = fminf(casted, seg);
  return __fmul_rn(sign, __fdiv_rn(casted, seg));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// ops/sigmoid.sigmoid_lut: the reference expTable lookup
// (src/word2bits.cpp:473-475, integer-division scale 83), +-6 saturation.
// Its bin of f in [-6, 6] is 0 .. 996 (LUT_BINS bins); a kernel may hold
// the bins' values in a table (sigmoid_lut_value of each) with the same bits.
constexpr int LUT_BINS = 997;

__device__ __forceinline__ float sigmoid_lut_bin(float f) {
  return floorf(__fmul_rn(__fadd_rn(f, 6.0f), 83.0f));
}

__device__ __forceinline__ float sigmoid_lut_value(float idx) {
  const float x_bin = __fmul_rn(
      __fsub_rn(__fmul_rn(__fdiv_rn(idx, 1000.0f), 2.0f), 1.0f), 6.0f);
  return sigmoid(x_bin);
}

__device__ __forceinline__ float sigmoid_lut(float f) {
  if (f > 6.0f) return 1.0f;
  if (f < -6.0f) return 0.0f;
  return sigmoid_lut_value(sigmoid_lut_bin(f));
}

// ops/sigmoid.sigmoid_exact: 1 above +6, 1e-9 below -6 (src :67-71).
__device__ __forceinline__ float sigmoid_exact(float f) {
  if (f > 6.0f) return 1.0f;
  if (f < -6.0f) return 1e-9f;
  return sigmoid(f);
}

}  // namespace w2b
