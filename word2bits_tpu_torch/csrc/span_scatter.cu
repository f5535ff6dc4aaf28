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
// w2b_span_scatter_rank1 is the same kernel with another row source
// (csrc/w2b_rows.cuh Rank1Rows), replacing the JAX package's
// scatter_add_span_rank1 (kernels/span_scatter.py:268): the trailing rows
// g[j] * cavg[j / per_src] of the per-center step's negative update are
// formed in registers as they are gathered, so the [B*K, D] float32 block
// (78.6 MB at B = 4096, K = 24, D = 200) is never written or read; the
// kernel reads g and cavg instead (0.4 + 3.3 MB, cavg rows from L2).
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

using w2b::DenseRows;
using w2b::load_vec;
using w2b::Rank1Rows;
using w2b::store_vec;

constexpr int ROWS = 4;     // row lanes per block
constexpr int UNROLL = 4;   // row loads in flight per lane

template <typename TableT, typename Src, int VEC>
__global__ void span_scatter_kernel(TableT* __restrict__ table, const Src src,
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
        int o[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) o[u] = order[k + u * ROWS];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) src.add(o[u], c, acc);
      }
      for (; k < e; k += ROWS) src.add(order[k], c, acc);
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

template <typename TableT, int VEC, typename Src>
int launch(void* table, const Src& src, const int* sids, const int* order,
           const int* run_start, const int* n_runs, int N, int V, int C,
           cudaStream_t stream) {
  const int CV = C / VEC;
  const dim3 threads(CV < 256 ? CV : 256, ROWS);
  const int blocks = N < 8192 ? N : 8192;
  const size_t smem = (size_t)ROWS * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      span_scatter_kernel<TableT, Src, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  span_scatter_kernel<TableT, Src, VEC><<<blocks, threads, smem, stream>>>(
      static_cast<TableT*>(table), src, sids, order, run_start, n_runs, V, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT>
int launch_dense(void* table, const void* rows, const int* sids,
                 const int* order, const int* run_start, const int* n_runs,
                 int N, int V, int C, cudaStream_t stream) {
  if (N == 0) return 0;
  const RowT* r = static_cast<const RowT*>(rows);
  // 4 columns per thread when every row start is aligned for one access
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C))
    return launch<TableT, 4>(table, DenseRows<TableT, RowT, 4>{r, C}, sids,
                          order, run_start, n_runs, N, V, C, stream);
  return launch<TableT, 1>(table, DenseRows<TableT, RowT, 1>{r, C}, sids, order,
                        run_start, n_runs, N, V, C, stream);
}

template <typename TableT, typename RowT>
int launch_rank1(void* table, const void* dense, const float* g,
                 const float* cavg, const int* sids, const int* order,
                 const int* run_start, const int* n_runs, int N, int nd,
                 int per_src, int V, int C, cudaStream_t stream) {
  if (N == 0) return 0;
  const RowT* d = static_cast<const RowT*>(dense);
  if (w2b::rows_vec4<TableT, RowT>(table, dense, C) &&
      w2b::aligned(cavg, 16))
    return launch<TableT, 4>(table,
                             Rank1Rows<TableT, RowT, 4>{d, g, cavg, nd, per_src,
                                                     C},
                          sids, order, run_start, n_runs, N, V, C, stream);
  return launch<TableT, 1>(
      table, Rank1Rows<TableT, RowT, 1>{d, g, cavg, nd, per_src, C}, sids,
      order, run_start, n_runs, N, V, C, stream);
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
    return launch_dense<__nv_bfloat16, float>(table, rows, sids, order,
                                              run_start, n_runs, N, V, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_dense<__nv_bfloat16, __nv_bfloat16>(
        table, rows, sids, order, run_start, n_runs, N, V, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_dense<float, float>(table, rows, sids, order, run_start,
                                      n_runs, N, V, C, s);
  return (int)cudaErrorInvalidValue;
}

// The same scatter with rank-1 trailing rows: the plan is of the N = nd + nn
// ids [dense ids; rank-1 ids]; dense [nd, C] (row_dtype), g [nn] float32,
// cavg [nn / per_src, C] float32.
int w2b_span_scatter_rank1(void* table, const void* dense, const float* g,
                           const float* cavg, const int* sids,
                           const int* order, const int* run_start,
                           const int* n_runs, int N, int nd, int per_src,
                           int V, int C, int table_dtype, int row_dtype,
                           void* stream) {
  if (N < 0 || nd < 0 || nd > N || per_src < 1 || (N - nd) % per_src ||
      V < 0 || C < 1 || C > 12288)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_rank1<__nv_bfloat16, float>(table, dense, g, cavg, sids,
                                              order, run_start, n_runs, N, nd,
                                              per_src, V, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_rank1<__nv_bfloat16, __nv_bfloat16>(
        table, dense, g, cavg, sids, order, run_start, n_runs, N, nd, per_src,
        V, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_rank1<float, float>(table, dense, g, cavg, sids, order,
                                      run_start, n_runs, N, nd, per_src, V, C,
                                      s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
