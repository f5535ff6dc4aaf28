// Sorted scatter-adds of the capacity paths' update rows, for sm_90a:
// table[ids] += rows.  Two entry points: w2b_group_rmw (kernel 7,
// `-scatter-impl grmw`) and w2b_scatter_rmw (kernel 8, `-rmw-scatter`).
//
// Kernel 7 replaces the TPU kernel of the JAX package's kernels/group_rmw.py
// (`_group_kernel` at :73, called through `_group_call` at :160 and its
// pl.pallas_call at :184 by scatter_add_grmw and scatter_add_grmw_planned).
// The contract is kept:
//   * each row is first rounded to the table dtype (the JAX wrapper casts
//     the rows before its kernel; here the float32 rows are rounded in
//     registers, with no rounded copy in device memory);
//   * duplicates of an id are summed in float32;
//   * each touched table row gets exactly ONE add in the table dtype, with
//     no atomics on the table or on a sum: the result is deterministic;
//   * ids outside [0, V) (negative ids, the 0x7FFFFFF0 drop sentinel) are
//     dropped;
//   * the table is updated in place; no temporary the size of the table.
// The TPU mechanism is not.  There a visit is the read-place-write of one
// 16-row sublane group (8 for float32) within one `chunk`-row block of the
// sorted stream, placed by a one-hot MXU matmul, the blocks in order.
//
// Kernel 7 is the tiled template of csrc/w2b_tiles.cuh (kernels 2 and 3
// run it too), fed by the group plan's sorted ids and source rows
// (kernels/group_rmw.py group_plan; it reads no visit or run table): the
// sorted stream is cut into tiles of L slots and the row's columns into
// groups of at most GROUP, one CTA each, all at once; each chunk of at most
// SUB rows of a run goes to one thread, with the rows and the table row in
// flight together; a run cut by tile edges (the Zipf head) is summed piece
// by piece into float32 partials of a per-device workspace, and the CTA
// whose piece arrives last adds them in tile order and makes the row's one
// read-modify-write.  Its constants (GrmwCfg below: tiles of L = 32 slots,
// 128 threads, chunks of 4 rows, 2 in flight, groups of at most 256
// columns) were chosen by timing 14 variants at the flagship's
// 1,600-column rows (tools/tune_kernels.py): L of 32 to 128, 128 or 256
// threads, chunks of 2 to 8 rows, 1 to 4 in flight, groups of 128 to 800
// columns; the kept one and L = 32 with 800-column groups were 2% faster
// than kernel 2's constants, the rest slower.  Its shorter tiles cut a
// run into twice as many pieces: a run cut over hundreds of tiles (one id
// holding most of a call's rows, which no capacity step has) is slower
// than with kernel 2's constants, its pieces being added by one CTA.
// Asynchronous staging of a tile's rows (cp.async.bulk) was not tried:
// every thread already has its chunks' rows and table row in flight.
//
// What the earlier design (one CTA of 4 row lanes x 224 column threads per
// visit, a touched 16-row group or one id of a group above 64 rows) lost,
// and what this one does about it: a visit's CTA followed a chain of
// dependent loads per run (the run table, the ids, the order, then the
// rows) and two barriers, with at most two CTAs an SM; most runs of a
// 3.7M-word Zipf tail hold one row, so three of its four row lanes idled;
// and the most frequent id's run was summed by one CTA.  Here the runs are
// found from neighbouring ids in shared memory, a one-row run is one
// thread's load and read-modify-write, and the head's run is summed by as
// many CTAs as it has tiles.
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the flagship
// (22,544 float32 rows of 1,600 columns into a 3,699,941 x 1,600 bf16
// table) that is the rows (144 MB), the plan, and each touched row read and
// written once (3.2 KB each way): 70.2 us.  What is left: each CTA's
// dependent phases (staging the tile, the chunk loads, a cut run's
// arrival); PERF.md section 6 has the times.
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
// tolerance).  It keeps the earlier design of kernel 7: the group plan
// (kernels/group_rmw.py) makes ONE visit per touched group over the whole
// sorted stream, and one CTA takes one visit (grid-stride over visits): no
// two CTAs ever touch the same rows.  A group of more than SPLIT_ROWS rows
// (the Zipf head) is cut into one visit per id.  For each run the CTA's
// ROWS row lanes gather rows[order[k]], k = y, y+ROWS, ... of the run,
// straight from the unsorted row buffer, UNROLL loads in flight each, VEC
// columns per thread, summing in float32 registers; lane 0 adds the lane
// sums in lane order and does the one read-modify-write of table[id].
// Bound at the `-rmw-scatter` step's two calls (16,400 and 6,144 float32
// rows into the same table): 71.4 us.
#include "w2b_tiles.cuh"

// kernel 7's tile constants (tools/tune_kernels.py builds variants)
#ifndef W2B_GRMW_L
#define W2B_GRMW_L 32
#endif
#ifndef W2B_GRMW_THREADS
#define W2B_GRMW_THREADS 128
#endif
#ifndef W2B_GRMW_SUB
#define W2B_GRMW_SUB 4
#endif
#ifndef W2B_GRMW_IB
#define W2B_GRMW_IB 2
#endif
#ifndef W2B_GRMW_GROUP
#define W2B_GRMW_GROUP 256
#endif

namespace {

using GrmwCfg = w2b::TileCfg<W2B_GRMW_L, W2B_GRMW_THREADS, W2B_GRMW_SUB,
                             W2B_GRMW_IB, W2B_GRMW_GROUP>;

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

// Kernel 7.  table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in
// float32 or in the table dtype).  sids/order: [N] int32 (group_plan);
// part/count: the workspace (w2b_group_rmw_partials / _counters floats and
// counters, the counters zero between calls).  Returns cudaGetLastError()
// after the launch (0 = launched).
int w2b_group_rmw(void* table, const void* rows, const int* sids,
                  const int* order, float* part, int* count, int N, int V,
                  int C, int table_dtype, int row_dtype, void* stream) {
  return w2b::tile_scatter_dense<GrmwCfg>(table, rows, sids, order, part,
                                          count, N, V, C, table_dtype,
                                          row_dtype, stream);
}

// Kernel 7's tile constants (L, THREADS, SUB, IB, GROUP) and workspace.
void w2b_group_rmw_config(int* out) {
  out[0] = GrmwCfg::L;
  out[1] = GrmwCfg::THREADS;
  out[2] = GrmwCfg::SUB;
  out[3] = GrmwCfg::IB;
  out[4] = GrmwCfg::GROUP;
}
long long w2b_group_rmw_partials(int N, int C) {
  return GrmwCfg::partials(N, C);
}
long long w2b_group_rmw_counters(int N, int C) {
  return GrmwCfg::counters(N, C);
}

// Kernel 8.  table_dtype / row_dtype as above.  sids/order: [N] int32;
// run_start: [N+1] int32, the start of each run of equal ids,
// run_start[n_runs] = end of the runs; vis_run: [N+1] int32, the first run
// of each visit, vis_run[n_vis] = n_runs; n_vis: one int32 on the device.
// Each id's summed rows are rounded to the table dtype before the add.
int w2b_scatter_rmw(void* table, const void* rows, const int* sids,
                    const int* order, const int* run_start,
                    const int* vis_run, const int* n_vis, int N, int V, int C,
                    int table_dtype, int row_dtype, void* stream) {
  return dispatch<true>(table, rows, sids, order, run_start, vis_run, n_vis,
                        N, V, C, table_dtype, row_dtype, stream);
}

}  // extern "C"
