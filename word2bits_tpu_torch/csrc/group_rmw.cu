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
// Kernel 7 is the tiled template of csrc/w2b_tiles.cuh (kernels 2, 3, 6 and 8
// run it too) with the plain AddSum epilogue, fed by the sort plan's sorted
// ids and source rows (kernels/span_scatter.py sort_plan, as kernels 2, 3 and
// 8 are): the sorted stream is cut into tiles of L slots and the row's
// columns into groups of at most GROUP, one CTA each, all at once; each chunk
// of at most SUB rows of a run goes to one thread, with the rows and the table
// row in flight together; a run cut by tile edges (the Zipf head) is summed
// piece by piece into float32 partials of a per-device workspace, and the CTA
// whose piece arrives last adds them in tile order and makes the row's one
// read-modify-write.  Its constants (GrmwCfg below: tiles of L = 32 slots, 128
// threads, chunks of 4 rows, 2 in flight, groups of at most 256 columns) were
// chosen by timing 14 variants at the flagship's 1,600-column rows
// (tools/tune_kernels.py): L of 32 to 128, 128 or 256 threads, chunks of 2 to
// 8 rows, 1 to 4 in flight, groups of 128 to 800 columns; the kept one and L =
// 32 with 800-column groups were 2% faster than kernel 2's constants, the rest
// slower.  Its shorter tiles cut a run into twice as many pieces: a run cut
// over hundreds of tiles (one id holding most of a call's rows, which no
// capacity step has) is slower than with kernel 2's constants, its pieces
// being added by one CTA.  Asynchronous staging of a tile's rows
// (cp.async.bulk) was not tried: every thread already has its chunks' rows and
// table row in flight.
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
// written once (3.2 KB each way): 70.2 us.  The training step launches
// w2b_group_rmw_parts, the same kernel reading those rows from the three
// buffers its phases wrote (csrc/w2b_rows.cuh SlabParts): the halves that
// are zero are not read, 124.6 of the 144 MB are.  What is left: each CTA's
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
// adds them in that dtype).  The TPU kernel combines per block and visits
// an id once per block that holds it; this one combines over the whole
// call and adds once, so the two agree to a few roundings of the table
// dtype (the tests state the tolerance).  It is kernel 7's template with
// the AddRoundedSum epilogue, which rounds the whole id's float32 sum,
// after a cut run's pieces are added in tile order, never a piece.  It
// reads the sorted ids and their source rows (one stable sort per call,
// kernels/scatter_pallas.py) and the workspace.  Its constants (RmwCfg
// below: kernel 7's but for groups of at most 512 columns, and the
// template's batched loads, which issue all of a thread's loads before it
// uses any) were chosen by timing variants at the step's two calls
// (tools/tune_kernels.py --kernel rmw; PERF.md section 6).
// The earlier design (one CTA of 4 row lanes per visit of a 16-row group)
// lost what kernel 7's did (above): 0.26565 ms for one step's two
// calls against a 0.07142 ms bound (PERF.md section 6).  Bound at the
// `-rmw-scatter` step's two calls (16,400 and 6,144 float32 rows into the
// same table): the rows, the sorted ids and order, and each touched row
// read and written once per call.
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

// kernel 8's tile constants (tools/tune_kernels.py --kernel rmw)
#ifndef W2B_RMW_L
#define W2B_RMW_L 32
#endif
#ifndef W2B_RMW_THREADS
#define W2B_RMW_THREADS 128
#endif
#ifndef W2B_RMW_SUB
#define W2B_RMW_SUB 4
#endif
#ifndef W2B_RMW_IB
#define W2B_RMW_IB 2
#endif
#ifndef W2B_RMW_GROUP
#define W2B_RMW_GROUP 512
#endif

namespace {

using GrmwCfg = w2b::TileCfg<W2B_GRMW_L, W2B_GRMW_THREADS, W2B_GRMW_SUB,
                             W2B_GRMW_IB, W2B_GRMW_GROUP>;
using RmwCfg = w2b::TileCfg<W2B_RMW_L, W2B_RMW_THREADS, W2B_RMW_SUB,
                            W2B_RMW_IB, W2B_RMW_GROUP, true>;

}  // namespace

extern "C" {

// Kernel 7.  table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in
// float32 or in the table dtype).  sids/order: [N] int32 (sort_plan);
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

// Kernel 7 on the fused CBOW step's rows read from their three parts
// (w2b::SlabParts), never assembled: the plan is of the N ids [slab ids;
// negative ids]; du [n_slab, D], dvc [n_slab - 2W, D] and dvn [N - n_slab,
// D] in row_dtype; the table [V, 2D].
int w2b_group_rmw_parts(void* table, const void* du, const void* dvc,
                        const void* dvn, const int* sids, const int* order,
                        float* part, int* count, int N, int n_slab, int W,
                        int V, int D, int table_dtype, int row_dtype,
                        void* stream) {
  return w2b::tile_scatter_parts<GrmwCfg>(table, du, dvc, dvn, sids, order,
                                          part, count, N, n_slab, W, V, D,
                                          table_dtype, row_dtype, stream);
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

// Kernel 8.  As kernel 7, with its own constants and workspace; each id's
// summed rows are rounded to the table dtype before the add.
int w2b_scatter_rmw(void* table, const void* rows, const int* sids,
                    const int* order, float* part, int* count, int N, int V,
                    int C, int table_dtype, int row_dtype, void* stream) {
  return w2b::tile_scatter_dense<RmwCfg>(table, rows, sids, order, part,
                                         count, N, V, C, table_dtype,
                                         row_dtype, stream,
                                         w2b::AddRoundedSum{});
}

// Kernel 8's tile constants (L, THREADS, SUB, IB, GROUP) and workspace.
void w2b_scatter_rmw_config(int* out) {
  out[0] = RmwCfg::L;
  out[1] = RmwCfg::THREADS;
  out[2] = RmwCfg::SUB;
  out[3] = RmwCfg::IB;
  out[4] = RmwCfg::GROUP;
}
long long w2b_scatter_rmw_partials(int N, int C) {
  return RmwCfg::partials(N, C);
}
long long w2b_scatter_rmw_counters(int N, int C) {
  return RmwCfg::counters(N, C);
}

}  // extern "C"
