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
//     one thread per column vector, never an atomic on the table or on a
//     sum: the summation order is fixed by the plan, so the result does not
//     depend on scheduling and two launches give bit-equal tables;
//   * ids outside [0, V) (the 0x7FFFFFF0 drop sentinel) are dropped;
//   * the table is updated in place; no temporary the size of the table.
//
// w2b_span_scatter_rank1 is the same kernel with another row source
// (csrc/w2b_rows.cuh Rank1Rows), replacing the JAX package's
// scatter_add_span_rank1 (kernels/span_scatter.py:268): the trailing rows
// g[j] * cavg[j / per_src] of the per-center step's negative update are
// formed in registers as they are gathered, so the [B*K, D] float32 block
// (78.6 MB at B = 4096, K = 24, D = 200) is never written or read; the
// kernel reads g and cavg instead (0.4 + 3.3 MB, cavg rows from L2).  Both
// entry points sum in the same order, so on the same rows they are
// bit-equal.  w2b_span_scatter_parts is the same kernel again with the fused
// CBOW step's rows read from the three buffers its phases wrote
// (csrc/w2b_rows.cuh SlabParts): the [N, 2D] float32 rows are never
// assembled (two zero fills, a copy and three concatenations, about 116 MB
// of traffic a step at the shipped shape: B = 8192, D = 200, 6,144
// negatives), and the halves that are zero are not read.
//
// The plan (sorted ids and their source rows; kernels/span_scatter.py
// sort_plan) is built by plain PyTorch, hoisted per chunk.  The Zipf head
// makes a few runs of equal ids long (2,214 of 102,400 rows at the exact
// mode's shape) and most runs one to three rows; a run summed by one CTA
// would set the kernel's time by its length.  So the sorted stream is cut
// into tiles of L slots and the columns into groups of at most GROUP, one
// CTA each, all at once: the template of csrc/w2b_tiles.cuh (its note has
// the design), which kernel 7 (csrc/group_rmw.cu) shares with other
// constants.  The workspace (2 * ceil(N / L) * C floats and ceil(N / L)
// counters per column group, zero between calls) is allocated once per
// device by the wrapper.  L, GROUP, SUB and IB (Cfg below) were chosen by
// timing variants at the three shapes below (L of 32, 64 and 128; 128 or
// 256 threads; IB of 1, 2 and 4; SUB of 2, 4 and 8; groups of 64 to 512
// columns; an L2 prefetch of the rows read after a barrier).
//
// Bound on the H100 (3.35 TB/s): the bytes it must move, the rows and the
// plan read once and each touched table row read and written once; 10.4
// us at the main path (N = 14,352 float32 rows of 400 columns into a
// 70,000 x 400 bf16 table), 41.9 us for the exact mode's 102,400 float32
// rows into a 69,998 x 200 float32 table, 19.5 us for the same through the
// rank-1 source.  The partials of cut runs add at most 2 * C floats per
// tile.  What is left: each CTA's dependent phases (staging, the chunk
// loads, the longer runs' adds, a cut run's arrival), not its bytes
// (PERF.md section 6 has the times).
#include "w2b_tiles.cuh"

namespace {

using w2b::Rank1Rows;

// L = 64 slots a tile, 128 threads, chunks of SUB = 4 rows, IB = 2 chunks
// in flight a thread, groups of at most 128 columns
using Cfg = w2b::TileCfg<64, 128, 4, 2, 128>;

template <typename TableT, typename RowT>
int launch_rank1(void* table, const void* dense, const float* g,
                 const float* cavg, const int* sids, const int* order,
                 float* part, int* count, int N, int nd, int per_src, int V,
                 int C, cudaStream_t stream) {
  if (N == 0) return 0;
  const RowT* d = static_cast<const RowT*>(dense);
  if (w2b::rows_vec4<TableT, RowT>(table, dense, C) &&
      w2b::aligned(cavg, 16) && w2b::aligned(part, 16))
    return w2b::tile_launch<Cfg, TableT, 4>(
        table, Rank1Rows<TableT, RowT, 4>{d, g, cavg, nd, per_src, C}, sids,
        order, part, count, N, V, C, stream);
  return w2b::tile_launch<Cfg, TableT, 1>(
      table, Rank1Rows<TableT, RowT, 1>{d, g, cavg, nd, per_src, C}, sids,
      order, part, count, N, V, C, stream);
}

}  // namespace

extern "C" {

// Slots of a tile.
int w2b_span_tile(void) { return Cfg::L; }

// The workspace of a call with N ids of C columns (w2b::TileCfg).
long long w2b_span_partials(int N, int C) { return Cfg::partials(N, C); }
long long w2b_span_counters(int N, int C) { return Cfg::counters(N, C); }

// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or
// in the table dtype).  sids/order: [N] int32 (sort_plan); part/count: the
// workspace.  Returns cudaGetLastError() after the launch (0 = launched).
int w2b_span_scatter(void* table, const void* rows, const int* sids,
                     const int* order, float* part, int* count, int N, int V,
                     int C, int table_dtype, int row_dtype, void* stream) {
  return w2b::tile_scatter_dense<Cfg>(table, rows, sids, order, part, count,
                                      N, V, C, table_dtype, row_dtype,
                                      stream);
}

// The same scatter with rank-1 trailing rows: the plan is of the N = nd + nn
// ids [dense ids; rank-1 ids]; dense [nd, C] (row_dtype), g [nn] float32,
// cavg [nn / per_src, C] float32.
int w2b_span_scatter_rank1(void* table, const void* dense, const float* g,
                           const float* cavg, const int* sids,
                           const int* order, float* part, int* count, int N,
                           int nd, int per_src, int V, int C, int table_dtype,
                           int row_dtype, void* stream) {
  if (N < 0 || nd < 0 || nd > N || per_src < 1 || (N - nd) % per_src ||
      V < 0 || C < 1 || C > 12288)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_rank1<__nv_bfloat16, float>(table, dense, g, cavg, sids,
                                              order, part, count, N, nd,
                                              per_src, V, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_rank1<__nv_bfloat16, __nv_bfloat16>(
        table, dense, g, cavg, sids, order, part, count, N, nd, per_src, V, C,
        s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_rank1<float, float>(table, dense, g, cavg, sids, order,
                                      part, count, N, nd, per_src, V, C, s);
  return (int)cudaErrorInvalidValue;
}

// The same scatter of the fused CBOW step's rows read from their three parts
// (w2b::SlabParts), never assembled: the plan is of the N ids [slab ids;
// negative ids]; du [n_slab, D], dvc [n_slab - 2W, D] and dvn [N - n_slab,
// D] in row_dtype; the table [V, 2D].
int w2b_span_scatter_parts(void* table, const void* du, const void* dvc,
                           const void* dvn, const int* sids, const int* order,
                           float* part, int* count, int N, int n_slab, int W,
                           int V, int D, int table_dtype, int row_dtype,
                           void* stream) {
  return w2b::tile_scatter_parts<Cfg>(table, du, dvc, dvn, sids, order, part,
                                      count, N, n_slab, W, V, D, table_dtype,
                                      row_dtype, stream);
}

}  // extern "C"
