// Sorted in-place scatter-add of the training step's update rows, for
// sm_90a: table[ids] += rows.
//
// Replaces the TPU kernel of the JAX package's kernels/span_scatter.py
// (`_span_kernel`, called through `_span_call` by scatter_add_span and
// scatter_add_span_planned).  The contract is kept, not the TPU mechanism
// (its window accumulators, wfirst/wlast/edges tables and one-hot MXU
// placement exist for Mosaic's DMA and VMEM):
//   * each row is first rounded to the table dtype (the JAX wrapper casts
//     rows to the table dtype before its kernel);
//   * duplicates of an id are summed in float32;
//   * each touched table row gets exactly ONE add in the table dtype, by
//     one block, with no atomics: the result is deterministic;
//   * ids outside [0, V) (the 0x7FFFFFF0 drop sentinel) are dropped;
//   * the table is updated in place; no temporary the size of the table.
//
// The plan (sorted ids, their source rows, and the start of each run of
// equal in-range ids) is built by plain PyTorch, hoisted per chunk.  One
// block takes one run (grid-stride over runs).  The block is ROWS row
// lanes by CV column threads, each column thread holding VEC adjacent
// columns (16-byte float32 / 8-byte bfloat16 accesses when the pointers
// allow).  Row lane y gathers rows[order[k]] for k = y, y+ROWS, ... of the
// run straight from the unsorted row buffer (no permuted copy) and sums
// them in float32; lane 0 then adds the lanes' sums in lane order and does
// the one read-modify-write of table[id].  The summation order is fixed,
// so the result does not depend on scheduling.
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the main path
// (N = 14,352 float32 rows of 400 columns into a 70,000 x 400 bf16 table)
// it reads the rows (23 MB) and the plan, and reads and writes each touched
// table row once (0.8 KB each way per distinct id; ~7,300 of them):
// ~10 us.  The Zipf head makes a few runs hundreds of rows long; the row
// lanes cut the serial
// chain of dependent loads per thread by ROWS, and the head's runs come
// first in the sorted stream, so their blocks start first.
#include "w2b_rows.cuh"

namespace {

using w2b::add_row;
using w2b::load_vec;
using w2b::store_vec;

constexpr int ROWS = 4;     // row lanes per block
constexpr int UNROLL = 4;   // row loads in flight per lane

template <typename TableT, typename RowT, int VEC>
__global__ void span_scatter_kernel(TableT* __restrict__ table,
                                    const RowT* __restrict__ rows,
                                    const int* __restrict__ sids,
                                    const int* __restrict__ order,
                                    const int* __restrict__ run_start,
                                    const int* __restrict__ n_runs_p, int V,
                                    int C) {
  extern __shared__ float part[];  // [ROWS][C] lane sums
  const int n_runs = *n_runs_p;
  const int CV = C / VEC;
  const int y = threadIdx.y;
  for (int r = blockIdx.x; r < n_runs; r += gridDim.x) {
    const int b = run_start[r], e = run_start[r + 1];
    const int id = sids[b];
    if (id < 0 || id >= V) continue;  // uniform across the block
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
    if (y == 0) {
      for (int cv = threadIdx.x; cv < CV; cv += blockDim.x) {
        const int c = cv * VEC;
        float sum[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] = part[c + i];
        for (int l = 1; l < ROWS; ++l) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) sum[i] += part[l * C + c + i];
        }
        TableT* p = table + (size_t)id * C + c;
        float cur[VEC];
        load_vec<VEC>(p, cur);
#pragma unroll
        for (int i = 0; i < VEC; ++i) cur[i] += sum[i];
        store_vec<VEC>(p, cur);
      }
    }
    __syncthreads();  // part is reused by the block's next run
  }
}

template <typename TableT, typename RowT, int VEC>
int launch(void* table, const void* rows, const int* sids, const int* order,
           const int* run_start, const int* n_runs, int N, int V, int C,
           cudaStream_t stream) {
  const int CV = C / VEC;
  const dim3 threads(CV < 256 ? CV : 256, ROWS);
  const int blocks = N < 8192 ? N : 8192;
  const size_t smem = (size_t)ROWS * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      span_scatter_kernel<TableT, RowT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  span_scatter_kernel<TableT, RowT, VEC><<<blocks, threads, smem, stream>>>(
      static_cast<TableT*>(table), static_cast<const RowT*>(rows), sids,
      order, run_start, n_runs, V, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT>
int launch_vec(void* table, const void* rows, const int* sids,
               const int* order, const int* run_start, const int* n_runs,
               int N, int V, int C, cudaStream_t stream) {
  if (N == 0) return 0;
  // 4 columns per thread when every row start is aligned for one access
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C))
    return launch<TableT, RowT, 4>(table, rows, sids, order, run_start,
                                   n_runs, N, V, C, stream);
  return launch<TableT, RowT, 1>(table, rows, sids, order, run_start, n_runs,
                                 N, V, C, stream);
}

}  // namespace

extern "C" {

// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or
// in the table dtype).  sids/order: [N] int32; run_start: [N+1] int32 with
// run_start[n_runs] = end of the in-range ids; n_runs: one int32 on the
// device.  Returns cudaGetLastError() after the launch (0 = launched).
int w2b_span_scatter(void* table, const void* rows, const int* sids,
                     const int* order, const int* run_start,
                     const int* n_runs, int N, int V, int C, int table_dtype,
                     int row_dtype, void* stream) {
  if (N < 0 || V < 0 || C < 1 || C > 12288) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(table, rows, sids, order,
                                            run_start, n_runs, N, V, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(
        table, rows, sids, order, run_start, n_runs, N, V, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_vec<float, float>(table, rows, sids, order, run_start,
                                    n_runs, N, V, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
