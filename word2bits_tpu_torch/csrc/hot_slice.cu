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
//   * with `extra` every head row is stored, once; without it a head row
//     that no row reaches is left as it is (the same value).
//
// The TPU mechanism is not.  The TPU kernel builds one-hot [rows x head]
// tiles in VMEM so that the MXU does the segmented sum.  Here the function
// is what it is: a sorted scatter-add into the head, run on the tiled
// template of csrc/w2b_tiles.cuh (kernels 2, 3, 7 and 8 run it too).  The
// wrapper's plan (kernels/hot_pallas.py hot_plan, plain PyTorch, hoisted
// to the chunk's entry) is one stable sort of the ids keyed H outside
// [0, H): the sorted keys `sids` and their source rows `order` are the
// template's sorted stream, with V = H, so the cold tail is dropped like
// any id outside [0, V).  Tiles of L slots and groups of at most GROUP
// columns, one CTA each, all at once; a run of at most SUB rows is one
// thread's loads and read-modify-write; the Zipf head's long runs are cut
// by tile edges and summed piece by piece into float32 partials of the
// per-device workspace, the last-arriving piece's CTA adding them in tile
// order.  With `extra` the epilogue is HeadFold: each touched head row is
// folded as it is read (its table and extra loads in flight with the
// rows'), and ceil(H / L) more CTAs per column group fold the head rows
// whose run is empty (`starts`, the plan's run starts, says which), their
// loads in flight together; without it the epilogue is the plain AddSum.
// The order of every sum is fixed: deterministic, no atomics on the table
// or a sum.
//
// The constants (HotCfg below: tiles of 32 slots, 128 threads, chunks of
// 2 rows, 1 in flight, groups of at most 128 columns, with the template's
// batched loads) were chosen by timing variants at [hotk]'s shape
// (tools/tune_kernels.py --kernel hot; PERF.md section 6).  The batched
// loads matter most: without them each row load of step 1 sits in its own
// branch with its rounding, and a thread's loads go out one after another.
//
// What the earlier design (one CTA of 4 row lanes x up to 256 column
// threads per head row, H = 2,048 CTAs of 512 threads at C = 400, about
// 3.9 waves) lost: the 8,208 rows of a step hold about 5,470 head rows, so
// most CTAs owned a run of 0 to 3 rows and still paid the whole dependent
// chain (starts, order, the rows, a barrier, the lane sums, the table row);
// the longest Zipf run was summed by one CTA's 4 lanes in series.  Its
// time was 2.5x the bound.  What this one loses in turn, at that shape: a
// tile of one-row runs gives each of its threads several (chunk, column)
// items in series, each a round trip, while the head's ~5,470 rows keep
// only a few hundred CTAs busy; it is not faster than the earlier design
// there (PERF.md section 6 has both times).
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the [hot]
// path (H = 2048 head rows of 400 bf16 columns, the hot part of 8,208
// float32 slab rows) that is the ids and the hot rows read once and the
// touched head rows read and written once; with `extra`, extra read once
// and every head row read and written once: a few microseconds.
#include "w2b_tiles.cuh"

// the tile constants (tools/tune_kernels.py --kernel hot builds variants)
#ifndef W2B_HOT_L
#define W2B_HOT_L 32
#endif
#ifndef W2B_HOT_THREADS
#define W2B_HOT_THREADS 128
#endif
#ifndef W2B_HOT_SUB
#define W2B_HOT_SUB 2
#endif
#ifndef W2B_HOT_IB
#define W2B_HOT_IB 1
#endif
#ifndef W2B_HOT_GROUP
#define W2B_HOT_GROUP 128
#endif

namespace {

using HotCfg = w2b::TileCfg<W2B_HOT_L, W2B_HOT_THREADS, W2B_HOT_SUB,
                            W2B_HOT_IB, W2B_HOT_GROUP, true>;

}  // namespace

extern "C" {

// table: [>= H, C] (only the first H rows are read and written);
// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or in
// the table dtype); rows: [N, C]; extra: [H, C] float32 or null; sids: [N]
// int32, the ids sorted with those outside [0, H) keyed H; order: [N]
// int32, their source rows; starts: [H+1] int32, the start of head row h's
// run in the sorted stream (read only with `extra`); part/count: the
// workspace (w2b_hot_slice_partials / _counters floats and counters, the
// counters zero between calls).  Returns cudaGetLastError() after the
// launch (0 = launched).
int w2b_hot_slice(void* table, const void* rows, const float* extra,
                  const int* sids, const int* order, const int* starts,
                  float* part, int* count, int N, int H, int C,
                  int table_dtype, int row_dtype, void* stream) {
  if (extra == nullptr)
    return w2b::tile_scatter_dense<HotCfg>(table, rows, sids, order, part,
                                           count, N, H, C, table_dtype,
                                           row_dtype, stream);
  return w2b::tile_scatter_dense<HotCfg>(table, rows, sids, order, part,
                                         count, N, H, C, table_dtype,
                                         row_dtype, stream,
                                         w2b::HeadFold{extra, starts, C});
}

// The tile constants (L, THREADS, SUB, IB, GROUP) and workspace.
void w2b_hot_slice_config(int* out) {
  out[0] = HotCfg::L;
  out[1] = HotCfg::THREADS;
  out[2] = HotCfg::SUB;
  out[3] = HotCfg::IB;
  out[4] = HotCfg::GROUP;
}
long long w2b_hot_slice_partials(int N, int C) {
  return HotCfg::partials(N, C);
}
long long w2b_hot_slice_counters(int N, int C) {
  return HotCfg::counters(N, C);
}

}  // extern "C"
