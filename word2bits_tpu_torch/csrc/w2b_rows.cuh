// Row access of the port's scatter kernels (csrc/span_scatter.cu,
// csrc/group_rmw.cu): VEC adjacent columns per thread, loaded and stored
// in one 16-byte float32 / 8-byte bfloat16 access when VEC == 4 (the
// caller checks alignment), always widened to float32 in registers; and
// the sorted scatters' three row sources (materialized rows, rank-1 rows,
// the fused CBOW step's rows from their parts).
#pragma once

#include <stdint.h>

#include <type_traits>

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

// Row sources of the span scatter: fetch(o, c, x) sets x to columns
// c..c+VEC-1 of update row o (a source index of the unsorted row set),
// rounded to the table dtype and widened to float32.  Every load of a
// fetch depends on o alone, so a caller that unrolls several fetches has
// all their loads in flight at once.
//
// DenseRows: the rows are materialized, [N, C].
template <typename TableT, typename RowT, int VEC>
struct DenseRows {
  const RowT* rows;
  int C;
  __device__ __forceinline__ void fetch(int o, int c, float (&x)[VEC]) const {
    load_vec<VEC>(rows + (size_t)o * C + c, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(from_f32<TableT>(x[i]));
  }
};

// Rank1Rows: rows o < nd are dense[o]; row nd + j is g[j] * cavg[j /
// per_src], formed in float32 and then rounded to the table dtype (the
// per-center CBOW negative update at reg == 0), so the [N - nd, C] block is
// never materialized.  With float32 dense rows either kind is one vector
// load times a scale (1 for a dense row: exact), so g[j] and the row are
// loaded together without a branch.
template <typename TableT, typename RowT, int VEC>
struct Rank1Rows {
  const RowT* dense;   // [nd, C]
  const float* g;      // [N - nd]
  const float* cavg;   // [(N - nd) / per_src, C]
  int nd, per_src, C;
  __device__ __forceinline__ void fetch(int o, int c, float (&x)[VEC]) const {
    const int j = o - nd;
    if constexpr (std::is_same<RowT, float>::value) {
      const bool d = o < nd;
      const float s = d ? 1.0f : __ldg(g + j);
      load_vec<VEC>(d ? dense + (size_t)o * C + c
                      : cavg + (size_t)(j / per_src) * C + c, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        x[i] = to_f32(from_f32<TableT>(__fmul_rn(s, x[i])));
    } else {
      if (o < nd) {
        load_vec<VEC>(dense + (size_t)o * C + c, x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[i] = to_f32(from_f32<TableT>(x[i]));
        return;
      }
      const float gj = __ldg(g + j);
      load_vec<VEC>(cavg + (size_t)(j / per_src) * C + c, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        x[i] = to_f32(from_f32<TableT>(__fmul_rn(gj, x[i])));
    }
  }
};

// SlabParts: the fused CBOW step's update rows [n_slab + n_neg, 2D]
// (models/cbow_fused.py) read from the three buffers its phases wrote, so
// that the rows are never assembled: slab row o < n_slab is [du[o],
// dvc[o - W]], its v half zero outside the B = n_slab - 2W centers W ..
// W + B - 1; negative row n_slab + j is [0, dvn[j]].  A zero half is 0.0f
// with no load, the value a materialized zero takes after its rounding, so
// the sums are DenseRows' on the assembled rows, bit for bit.  With VEC ==
// 4 the caller checks D % 4 == 0, so that no vector straddles column D.
template <typename TableT, typename RowT, int VEC>
struct SlabParts {
  const RowT* du;    // [n_slab, D]
  const RowT* dvc;   // [n_slab - 2W, D]
  const RowT* dvn;   // [N - n_slab, D]
  int n_slab, W, D;
  __device__ __forceinline__ void fetch(int o, int c, float (&x)[VEC]) const {
    const RowT* p = nullptr;
    if (c < D) {
      if (o < n_slab) p = du + (size_t)o * D + c;
    } else if (o >= n_slab) {
      p = dvn + (size_t)(o - n_slab) * D + (c - D);
    } else if (o >= W && o < n_slab - W) {
      p = dvc + (size_t)(o - W) * D + (c - D);
    }
    if (p == nullptr) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.0f;
      return;
    }
    load_vec<VEC>(p, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(from_f32<TableT>(x[i]));
  }
};

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// true when every row start of both buffers allows one VEC = 4 access
template <typename TableT, typename RowT>
inline bool rows_vec4(const void* table, const void* rows, int C) {
  return C % 4 == 0 && aligned(table, 4 * sizeof(TableT)) &&
         aligned(rows, 4 * sizeof(RowT));
}

}  // namespace w2b
