// Row access of the port's scatter kernels (csrc/span_scatter.cu,
// csrc/group_rmw.cu): VEC adjacent columns per thread, loaded and stored
// in one 16-byte float32 / 8-byte bfloat16 access when VEC == 4 (the
// caller checks alignment), always widened to float32 in registers.
#pragma once

#include <stdint.h>

#include "w2b_common.cuh"

namespace w2b {

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(h[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __bfloat162float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = x[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    uint2 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(x[i]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(x[i]);
  }
}

// acc += the VEC values at p, each first rounded to the table dtype
template <typename TableT, typename RowT, int VEC>
__device__ __forceinline__ void add_row(const RowT* p, float (&acc)[VEC]) {
  float x[VEC];
  load_vec<VEC>(p, x);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += to_f32(from_f32<TableT>(x[i]));
}

// true when every row start of both buffers allows one VEC = 4 access
template <typename TableT, typename RowT>
inline bool rows_vec4(const void* table, const void* rows, int C) {
  return C % 4 == 0 &&
         reinterpret_cast<uintptr_t>(table) % (4 * sizeof(TableT)) == 0 &&
         reinterpret_cast<uintptr_t>(rows) % (4 * sizeof(RowT)) == 0;
}

}  // namespace w2b
