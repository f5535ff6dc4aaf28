// Sorted group-RMW scatter-adds of the capacity paths' update rows, for
// sm_90a: table[ids] += rows.  Two entry points share one kernel template:
// w2b_group_rmw (kernel 7, `-scatter-impl grmw`) and w2b_scatter_rmw
// (kernel 8, `-rmw-scatter`), whose epilogue differs (ROUND_SUM below).
//
// Replaces the TPU kernel of the JAX package's kernels/group_rmw.py
// (`_group_kernel`, called through `_group_call` by scatter_add_grmw and
// scatter_add_grmw_planned).  The contract is kept:
//   * each row is first rounded to the table dtype (the JAX wrapper casts
//     the rows before its kernel; here the float32 rows are rounded in
//     registers, with no rounded copy in device memory);
//   * duplicates of an id are summed in float32;
//   * each touched table row gets exactly ONE add in the table dtype, with
//     no atomics: the result is deterministic;
//   * ids outside [0, V) (the 0x7FFFFFF0 drop sentinel) are dropped;
//   * the table is updated in place; no temporary the size of the table.
//
// The TPU mechanism is not.  There a visit is the read-place-write of one
// 16-row sublane group (8 for float32) within one `chunk`-row block of the
// sorted stream, placed by a one-hot MXU matmul; a group straddling two
// blocks is visited twice, which is correct only because the TPU grid runs
// its blocks in order and drains each block's writes before the next.  On
// Hopper the blocks run at once, so two CTAs on one group would race.  The
// port's plan (kernels/group_rmw.py, group_plan) therefore makes ONE visit
// per touched group over the whole sorted stream, and one CTA takes one
// visit (grid-stride over visits): no two CTAs ever touch the same rows.
// A visit holds the runs of equal ids that fall in its group; a group of
// more than SPLIT_ROWS rows (the Zipf head: group 0 holds the 16 most
// frequent ids) is cut into one visit per id, so the head's ids are summed
// by CTAs side by side instead of by one CTA in turn.  For each run
// the CTA's ROWS row lanes gather rows[order[k]], k = y, y+ROWS, ... of the
// run, straight from the unsorted row buffer, UNROLL loads in flight each,
// VEC columns per thread (16-byte float32 loads), summing in float32
// registers; lane 0 adds the lane sums in lane order and does the one
// read-modify-write of table[id].  The order of every sum is fixed.
//
// Kernel 8 replaces the TPU kernel of the JAX package's
// kernels/scatter_pallas.py (`_rmw_kernel`, called through `_scatter_rmw`
// by scatter_add_rmw): per `block` of rows a duplicate combine on 16-row
// groups, then pipelined DMA read-add-write chains, the blocks in order.
// Its numerics differ from kernel 7's in one rounding: the combined sum of
// an id's rows is rounded to the table dtype BEFORE the one add into the
// table (the TPU combine returns rows in the table dtype, and its kernel
// adds them in that dtype).  ROUND_SUM = true keeps that rounding.  The
// TPU kernel combines per block and visits an id once per block that holds
// it; this one combines over the whole call and visits each id once, so
// the two agree to a few roundings of the table dtype (the tests state the
// tolerance).
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the flagship
// (22,544 float32 rows of 1,600 columns into a 3,699,941 x 1,600 bf16
// table) that is the rows (144 MB), the plan, and each touched row read
// and written once (3.2 KB each way): ~50 us.  The longest visit (the
// most frequent id's run, tens of rows at the flagship) is summed by one
// CTA over its row lanes, and that CTA's time is a floor the bytes do not
// show.
#include "w2b_rows.cuh"

namespace {

using w2b::add_row;
using w2b::from_f32;
using w2b::load_vec;
using w2b::store_vec;
using w2b::to_f32;

constexpr int ROWS = 4;     // row lanes per CTA
constexpr int UNROLL = 4;   // row loads in flight per lane
constexpr int MAX_CTAS = 8192;

template <typename TableT, typename RowT, int VEC, bool ROUND_SUM>
__global__ void __launch_bounds__(1024)
group_rmw_kernel(TableT* __restrict__ table, const RowT* __restrict__ rows,
                 const int* __restrict__ sids, const int* __restrict__ order,
                 const int* __restrict__ run_start,
                 const int* __restrict__ vis_run,
                 const int* __restrict__ n_vis_p, int V, int C) {
  extern __shared__ float part[];  // [ROWS][C] lane sums
  const int n_vis = *n_vis_p;
  const int CV = C / VEC;
  const int y = threadIdx.y;
  for (int v = blockIdx.x; v < n_vis; v += gridDim.x) {
    const int r_end = vis_run[v + 1];
    for (int r = vis_run[v]; r < r_end; ++r) {
      const int b = run_start[r], e = run_start[r + 1];
      const int id = sids[b];
      if (id < 0 || id >= V) continue;  // uniform across the CTA
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
          for (int i = 0; i < VEC; ++i)
            cur[i] += ROUND_SUM ? to_f32(from_f32<TableT>(sum[i])) : sum[i];
          store_vec<VEC>(p, cur);
        }
      }
      __syncthreads();  // part is reused by the next run
    }
  }
}

template <typename TableT, typename RowT, int VEC, bool ROUND_SUM>
int launch(void* table, const void* rows, const int* sids, const int* order,
           const int* run_start, const int* vis_run, const int* n_vis, int N,
           int V, int C, cudaStream_t stream) {
  const int CV = C / VEC;
  // the fewest passes of at most 256 column threads, split evenly
  const int passes = (CV + 255) / 256;
  const int tx = ((CV + passes - 1) / passes + 31) / 32 * 32;
  const dim3 threads(tx, ROWS);
  const int ctas = N < MAX_CTAS ? N : MAX_CTAS;
  const size_t smem = (size_t)ROWS * C * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      group_rmw_kernel<TableT, RowT, VEC, ROUND_SUM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  group_rmw_kernel<TableT, RowT, VEC, ROUND_SUM>
      <<<ctas, threads, smem, stream>>>(
      static_cast<TableT*>(table), static_cast<const RowT*>(rows), sids, order,
      run_start, vis_run, n_vis, V, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT, bool ROUND_SUM>
int launch_vec(void* table, const void* rows, const int* sids,
               const int* order, const int* run_start, const int* vis_run,
               const int* n_vis, int N, int V, int C, cudaStream_t stream) {
  if (N == 0) return 0;
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C))
    return launch<TableT, RowT, 4, ROUND_SUM>(
        table, rows, sids, order, run_start, vis_run, n_vis, N, V, C, stream);
  return launch<TableT, RowT, 1, ROUND_SUM>(
      table, rows, sids, order, run_start, vis_run, n_vis, N, V, C, stream);
}

template <bool ROUND_SUM>
int dispatch(void* table, const void* rows, const int* sids, const int* order,
             const int* run_start, const int* vis_run, const int* n_vis,
             int N, int V, int C, int table_dtype, int row_dtype,
             void* stream) {
  if (N < 0 || V < 0 || C < 1 || C > 12288) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_vec<__nv_bfloat16, float, ROUND_SUM>(
        table, rows, sids, order, run_start, vis_run, n_vis, N, V, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16, ROUND_SUM>(
        table, rows, sids, order, run_start, vis_run, n_vis, N, V, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_vec<float, float, ROUND_SUM>(
        table, rows, sids, order, run_start, vis_run, n_vis, N, V, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or
// in the table dtype).  sids/order: [N] int32; run_start: [N+1] int32, the
// start of each run of equal ids, run_start[n_runs] = end of the runs;
// vis_run: [N+1] int32, the first run of each visit, vis_run[n_vis] =
// n_runs; n_vis: one int32 on the device.  Returns cudaGetLastError()
// after the launch (0 = launched).
int w2b_group_rmw(void* table, const void* rows, const int* sids,
                  const int* order, const int* run_start, const int* vis_run,
                  const int* n_vis, int N, int V, int C, int table_dtype,
                  int row_dtype, void* stream) {
  return dispatch<false>(table, rows, sids, order, run_start, vis_run, n_vis,
                         N, V, C, table_dtype, row_dtype, stream);
}

// Kernel 8: the same arguments and plan; each id's summed rows are rounded
// to the table dtype before the add.
int w2b_scatter_rmw(void* table, const void* rows, const int* sids,
                    const int* order, const int* run_start,
                    const int* vis_run, const int* n_vis, int N, int V, int C,
                    int table_dtype, int row_dtype, void* stream) {
  return dispatch<true>(table, rows, sids, order, run_start, vis_run, n_vis,
                        N, V, C, table_dtype, row_dtype, stream);
}

}  // extern "C"
