// Hot-row head accumulation of the hot/cold split, for sm_90a:
//   table[h] = round(round(table[h] + extra[h]) + sum_{ids[k] == h} round(rows[k]))
// for every h in [0, H), the sum in float32 (`round` = to the table dtype;
// without `extra` the first rounding is skipped).
//
// Replaces the TPU kernel of the JAX package's kernels/hot_pallas.py
// (`_hot_kernel`, called by hot_slice_add_pallas).  The contract is kept:
//   * each row is rounded to the table dtype before the sum (the TPU
//     kernel's bf16 product operands at a bf16 table);
//   * `extra` is added to the head and rounded once before the rows' sum
//     (the TPU wrapper folds it into the head before its kernel);
//   * ids outside [0, H) contribute nothing;
//   * every head row is stored, once.
//
// The TPU mechanism is not.  The TPU kernel builds one-hot [rows x head]
// tiles in VMEM so that the MXU does the segmented sum.  Here the function
// is what it is: a segmented sum.  The wrapper's plan (plain PyTorch) is a
// stable sort of the ids with the ids outside [0, H) sent to the end, and
// the start of each head row's run; one CTA takes one head row h, its ROWS
// row lanes gather rows[order[k]], k = y, y+ROWS, ... of the run straight
// from the unsorted row buffer (UNROLL loads in flight each, VEC columns
// per thread), summing in float32 registers; lane 0 adds the lane sums in
// lane order and does the head row's one read-modify-write.  The order of
// every sum is fixed: the result is deterministic, with no atomics.
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the [hot]
// path (H = 2048 head rows of 400 bf16 columns, the hot part of 8,208
// float32 slab rows) that is the hot rows read once, the head read and
// written once (3.3 MB) and `extra` read once (3.3 MB, dense-hot only): a
// few microseconds.  The Zipf head's runs are long (the most frequent word
// holds a few hundred rows of a step), and one CTA sums each run over its
// row lanes, so the longest run sets a floor the bytes do not show.
#include "w2b_rows.cuh"

namespace {

using w2b::add_row;
using w2b::from_f32;
using w2b::load_vec;
using w2b::store_vec;
using w2b::to_f32;

constexpr int ROWS = 4;     // row lanes per CTA
constexpr int UNROLL = 4;   // row loads in flight per lane

template <typename TableT, typename RowT, int VEC>
__global__ void __launch_bounds__(1024)
hot_slice_kernel(TableT* __restrict__ table, const RowT* __restrict__ rows,
                 const float* __restrict__ extra,
                 const int* __restrict__ order,
                 const int* __restrict__ starts, int C) {
  extern __shared__ float part[];  // [ROWS][C] lane sums
  const int h = blockIdx.x;
  const int b = starts[h], e = starts[h + 1];
  const int CV = C / VEC;
  const int y = threadIdx.y;
  for (int cv = threadIdx.x; cv < CV; cv += blockDim.x) {
    const int c = cv * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    int k = b + y;
    for (; k + (UNROLL - 1) * ROWS < e; k += UNROLL * ROWS) {
      int src[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) src[u] = order[k + u * ROWS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        add_row<TableT, RowT, VEC>(rows + (size_t)src[u] * C + c, acc);
    }
    for (; k < e; k += ROWS)
      add_row<TableT, RowT, VEC>(rows + (size_t)order[k] * C + c, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i) part[y * C + c + i] = acc[i];
  }
  __syncthreads();
  if (y != 0) return;
  for (int cv = threadIdx.x; cv < CV; cv += blockDim.x) {
    const int c = cv * VEC;
    float sum[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) sum[i] = part[c + i];
    for (int l = 1; l < ROWS; ++l) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] += part[l * C + c + i];
    }
    TableT* p = table + (size_t)h * C + c;
    float cur[VEC];
    load_vec<VEC>(p, cur);
    if (extra != nullptr) {
      float ex[VEC];
      load_vec<VEC>(extra + (size_t)h * C + c, ex);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        cur[i] = to_f32(from_f32<TableT>(cur[i] + ex[i]));
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] += sum[i];
    store_vec<VEC>(p, cur);
  }
}

template <typename TableT, typename RowT, int VEC>
int launch(void* table, const void* rows, const float* extra,
           const int* order, const int* starts, int H, int C,
           cudaStream_t stream) {
  const int CV = C / VEC;
  // the fewest passes of at most 256 column threads, split evenly
  const int passes = (CV + 255) / 256;
  const int tx = ((CV + passes - 1) / passes + 31) / 32 * 32;
  const dim3 threads(tx, ROWS);
  const size_t smem = (size_t)ROWS * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hot_slice_kernel<TableT, RowT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hot_slice_kernel<TableT, RowT, VEC><<<H, threads, smem, stream>>>(
      static_cast<TableT*>(table), static_cast<const RowT*>(rows), extra,
      order, starts, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT>
int launch_vec(void* table, const void* rows, const float* extra,
               const int* order, const int* starts, int H, int C,
               cudaStream_t stream) {
  if (H == 0) return 0;
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C) &&
      (extra == nullptr || w2b::aligned(extra, 16)))
    return launch<TableT, RowT, 4>(table, rows, extra, order, starts, H, C,
                                   stream);
  return launch<TableT, RowT, 1>(table, rows, extra, order, starts, H, C,
                                 stream);
}

}  // namespace

extern "C" {

// table: [>= H, C] (only the first H rows are read and written);
// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or in
// the table dtype); rows: [N, C]; extra: [H, C] float32 or null; order:
// [N] int32, the rows sorted by head id (ids outside [0, H) last); starts:
// [H+1] int32, the start of head row h's run in `order`, starts[H] = the
// end of the hot ids.  Returns cudaGetLastError() after the launch
// (0 = launched).
int w2b_hot_slice(void* table, const void* rows, const float* extra,
                  const int* order, const int* starts, int H, int C,
                  int table_dtype, int row_dtype, void* stream) {
  if (H < 0 || C < 1 || C > 12288) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(table, rows, extra, order, starts,
                                            H, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(table, rows, extra, order,
                                                    starts, H, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_vec<float, float>(table, rows, extra, order, starts, H, C,
                                    s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
