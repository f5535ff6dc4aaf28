// Swept scatter-add of sorted update rows, for sm_90a: kernel 9,
// table[ids] += rows through the per-(chunk, window) sweep plan of
// kernels/sweep_scatter.py (`-scatter-impl sweep` of the fused chunk).
//
// Replaces the TPU kernel of the JAX package's kernels/sweep_scatter.py
// (`_sweep_kernel`, called through `_sweep_call` by scatter_add_sweep and
// scatter_add_sweep_planned).  The contract is kept:
//   * each row is first rounded to the table dtype (the JAX wrapper casts
//     the rows before its kernel; here the float32 rows are rounded in
//     registers);
//   * within one `chunk`-slot block of the plan (all of it in one table
//     window), the rows of one id are summed in float32;
//   * the table gets ONE add in its dtype per chunk, the chunks applied in
//     order, so an id whose rows span two chunks is rounded twice, as on
//     the TPU;
//   * ids >= V (the 0x7FFFFFF0 drop sentinel) fall in no window and are
//     dropped;
//   * in place, no atomics: the result is deterministic.
//
// The TPU mechanism is not.  There the grid runs the chunks in order on one
// core, each chunk placed into its VMEM-resident window by a one-hot MXU
// matmul.  On Hopper blocks run at once, so the chunk order has to live
// inside one block: a CTA takes one window (windows never overlap, so no
// two CTAs touch one row) and walks that window's chunks in order, with a
// barrier between chunks.  Inside a chunk the block stages the chunk's
// slots in shared memory, finds the runs of equal offsets (warp ballots, in
// slot order), and gives each (run, VEC-column) item to one thread, so
// neighbouring threads read neighbouring columns of one run and a long run
// (the Zipf head) is spread over the block's threads.  A thread sums its
// run's rows in slot order, UNROLL row loads in flight (16-byte float32
// loads), then does the read-modify-write of its table columns.  The order
// of every sum is fixed: slot order, starting from 0.0f, which is what the
// plain version computes.
//
// Bound on the H100 (3.35 TB/s): bytes, the rows and the plan read once and
// each touched row read and written once.  A window's chunks run one after
// another in one CTA, so the window holding the Zipf head (the most
// frequent ids) is a floor the bytes do not show.
#include "w2b_rows.cuh"

namespace {

using w2b::add_row;
using w2b::load_vec;
using w2b::store_vec;

constexpr int THREADS = 256;
constexpr int UNROLL = 8;        // row loads in flight per thread
constexpr int MAX_CHUNK = 1024;  // slots of one block staged in shared memory

template <typename TableT, typename RowT, int VEC>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(TableT* __restrict__ table, const RowT* __restrict__ rows,
             const int* __restrict__ slot_row, const int* __restrict__ offs,
             const int* __restrict__ win_chunk, int window, int chunk, int C) {
  __shared__ int s_row[MAX_CHUNK];       // source row of each slot
  __shared__ int s_off[MAX_CHUNK];       // window offset of each slot
  __shared__ int s_run[MAX_CHUNK + 1];   // run starts; s_run[n_runs] = end
  __shared__ int s_nruns;
  const int w = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const int CV = C / VEC;
  const int k_end = win_chunk[w + 1];
  for (int k = win_chunk[w]; k < k_end; ++k) {
    const int s0 = k * chunk;
    for (int i = tid; i < chunk; i += THREADS) {
      s_row[i] = slot_row[s0 + i];
      s_off[i] = offs[s0 + i];
    }
    __syncthreads();
    // the runs of equal offsets, compacted in slot order by warp 0 (the
    // valid slots are a prefix of the block; padding is -1)
    if (tid < 32) {
      int n = 0, n_valid = 0;
      for (int base = 0; base < chunk; base += 32) {
        const int i = base + lane;
        const int off = i < chunk ? s_off[i] : -1;
        const bool start = off >= 0 && (i == 0 || s_off[i - 1] != off);
        const unsigned m = __ballot_sync(0xffffffffu, start);
        if (start) s_run[n + __popc(m & ((1u << lane) - 1u))] = i;
        n += __popc(m);
        n_valid += __popc(__ballot_sync(0xffffffffu, off >= 0));
      }
      if (lane == 0) {
        s_run[n] = n_valid;
        s_nruns = n;
      }
    }
    __syncthreads();
    // one item per (run, column vector): neighbouring threads take
    // neighbouring columns of one run, so a long run (the Zipf head) is
    // spread over the block; each item sums its rows in slot order
    const int items = s_nruns * CV;
    for (int it = tid; it < items; it += THREADS) {
      const int r = it / CV;
      const int c = (it - r * CV) * VEC;
      const int b = s_run[r], e = s_run[r + 1];
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      int t = b;
      for (; t + UNROLL <= e; t += UNROLL) {
        float x[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[u][i] = 0.0f;
          add_row<TableT, RowT, VEC>(rows + (size_t)s_row[t + u] * C + c,
                                     x[u]);
        }
        // in slot order: 0 + r_b + r_{b+1} + ... as the plain version
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += x[u][i];
        }
      }
      for (; t < e; ++t)
        add_row<TableT, RowT, VEC>(rows + (size_t)s_row[t] * C + c, acc);
      TableT* p = table + ((size_t)w * window + s_off[b]) * C + c;
      float cur[VEC];
      load_vec<VEC>(p, cur);
#pragma unroll
      for (int i = 0; i < VEC; ++i) cur[i] += acc[i];
      store_vec<VEC>(p, cur);
    }
    __syncthreads();  // the next block may add to the same rows
  }
}

template <typename TableT, typename RowT, int VEC>
int launch(void* table, const void* rows, const int* slot_row, const int* offs,
           const int* win_chunk, int nwin, int window, int chunk, int C,
           cudaStream_t stream) {
  sweep_kernel<TableT, RowT, VEC><<<nwin, THREADS, 0, stream>>>(
      static_cast<TableT*>(table), static_cast<const RowT*>(rows), slot_row,
      offs, win_chunk, window, chunk, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT>
int launch_vec(void* table, const void* rows, const int* slot_row,
               const int* offs, const int* win_chunk, int nwin, int window,
               int chunk, int C, cudaStream_t stream) {
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C))
    return launch<TableT, RowT, 4>(table, rows, slot_row, offs, win_chunk,
                                   nwin, window, chunk, C, stream);
  return launch<TableT, RowT, 1>(table, rows, slot_row, offs, win_chunk, nwin,
                                 window, chunk, C, stream);
}

}  // namespace

extern "C" {

// table [nwin * window (or fewer), C]; rows [N + 1, C] or [N, C] (slot_row
// names a row only where offs >= 0); slot_row, offs: [K * chunk] int32 per
// plan slot, the source row and the in-window offset (-1 = padding);
// win_chunk: [nwin + 1] int32, the first chunk of each window.
// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or
// in the table dtype).  Returns cudaGetLastError() after the launch
// (0 = launched).
int w2b_sweep_scatter(void* table, const void* rows, const int* slot_row,
                      const int* offs, const int* win_chunk, int nwin,
                      int window, int chunk, int C, int table_dtype,
                      int row_dtype, void* stream) {
  if (nwin < 0 || window < 1 || chunk < 1 || chunk > MAX_CHUNK || C < 1)
    return (int)cudaErrorInvalidValue;
  if (nwin == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(table, rows, slot_row, offs,
                                            win_chunk, nwin, window, chunk, C,
                                            s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(
        table, rows, slot_row, offs, win_chunk, nwin, window, chunk, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_vec<float, float>(table, rows, slot_row, offs, win_chunk,
                                    nwin, window, chunk, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
