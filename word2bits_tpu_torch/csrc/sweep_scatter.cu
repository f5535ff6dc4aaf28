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
//     window), the rows of one id are summed in float32, in slot order,
//     from 0;
//   * the table gets ONE add in its dtype per block, an id's blocks applied
//     in order, so an id whose rows span two blocks is rounded twice, as on
//     the TPU;
//   * ids >= V (the 0x7FFFFFF0 drop sentinel) fall in no window and are
//     dropped;
//   * in place, no atomics: the result is deterministic, and bit-equal to
//     scatter_add_sweep_plain.
//
// The TPU mechanism is not.  There the grid runs the blocks in order on one
// core, each placed into its VMEM-resident window by a one-hot MXU matmul.
// The first Hopper version kept that order inside one CTA per window, which
// walked the window's blocks with a barrier between blocks: 137 CTAs for
// 132 SMs, the busiest window 47 blocks long, 0.776 ms where index_add_
// takes 0.043 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py [sweepk],
// PERF.md section 6).  But only one row's blocks need that order: an id's
// runs are adjacent in the sorted plan and already in block order, and
// rows of different ids never interact.  So all K blocks run at once, one
// CTA each (more only for rows wider than 4,096 values):
//   * The CTA stages its block's slots in shared memory and finds the runs
//     of equal offsets (warp ballots, in slot order).
//   * The run holding an id's first slot owns the id.  A run at slot 0 that
//     continues the previous block's last run (same window, same offset) is
//     skipped: its owner is in an earlier block.  If the block's last run
//     reaches the block's end and the id goes on at the start of the next
//     block (same window only: the same offset in the next window is
//     another row), the run walks: its slots up to the id's end are cut at
//     the block edges into segments, whose sums (each from 0, in slot
//     order) the CTA's threads take in parallel into shared memory; then
//     one thread per column vector adds them to the row in block order,
//     each with its own rounding.  So the table row is touched by one
//     thread only, and the serial part is one add per block.
//   * The block's other runs: each (run, 4-column vector) item goes to one
//     thread, neighbouring threads on neighbouring columns.  Short runs
//     (at most SHORT rows) are taken IB items at a time, their table reads
//     and rows in flight together; longer ones UNROLL rows in flight.
// Bound on the H100 (3.35 TB/s): bytes, the rows and the plan read once and
// each touched row read and written once: 0.0104 ms at the [sweepk] shape
// (14,352 f32 rows into a [70,000, 400] bf16 table), where this design
// takes 0.041 ms against index_add_'s 0.043 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, PERF.md section 6).
// What is left: each CTA's few dependent load phases (the block's busiest
// runs, a walk's 128-row segments), not its bytes; splitting a block over
// two or four CTAs measured slower, and so did pairing a walk's segments.
#include "w2b_rows.cuh"

namespace {

using w2b::load_vec;
using w2b::store_vec;

constexpr int THREADS = 256;
constexpr int IB = 4;            // short-run items in flight per thread
constexpr int SHORT = 4;         // rows of a short run
constexpr int UNROLL = 16;       // row loads in flight in a longer sum
constexpr int MAX_CHUNK = 1024;  // slots of one block staged in shared memory
constexpr int WALK_FLOATS = 4096;  // segment sums of a walk, per pass

// the source row of slot ts of the block at s0 (ts may pass the block: a
// walk's later segments)
__device__ __forceinline__ int slot_src(const int* s_row,
                                        const int* __restrict__ slot_row,
                                        size_t s0, int chunk, int ts) {
  return ts < chunk ? s_row[ts] : __ldg(slot_row + s0 + ts);
}

// 0 + the rows of slots [b, e), each rounded to the table dtype, in slot
// order: UNROLL loads in flight
template <typename TableT, typename RowT, int VEC>
__device__ __forceinline__ void sum_slots(const RowT* __restrict__ rows,
                                          const int* s_row,
                                          const int* __restrict__ slot_row,
                                          size_t s0, int chunk, int b, int e,
                                          int c, int C, float (&acc)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int t = b; t < e; t += UNROLL) {
    float x[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (t + u < e)
        load_vec<VEC>(rows + (size_t)slot_src(s_row, slot_row, s0, chunk,
                                              t + u) * C + c, x[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t + u < e) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] += w2b::to_f32(w2b::from_f32<TableT>(x[u][i]));
      }
    }
  }
}

template <typename TableT, typename RowT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
sweep_kernel(TableT* __restrict__ table, const RowT* __restrict__ rows,
             const int* __restrict__ slot_row, const int* __restrict__ offs,
             const int* __restrict__ meta, int nblocks, int window, int chunk,
             int C) {
  __shared__ int s_row[MAX_CHUNK];       // source row of each slot
  __shared__ int s_off[MAX_CHUNK];       // window offset of each slot
  __shared__ int s_run[MAX_CHUNK + 1];   // run starts; s_run[n_runs] = end
  __shared__ __align__(16) float s_wacc[WALK_FLOATS];
  __shared__ int s_nruns, s_first, s_end;
  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const size_t s0 = (size_t)k * chunk;
  const int w = meta[k];
  for (int i = tid; i < chunk; i += THREADS) {
    s_row[i] = slot_row[s0 + i];
    s_off[i] = offs[s0 + i];
  }
  __syncthreads();
  // warp 0: the runs of equal offsets, compacted in slot order (the valid
  // slots are a prefix of the block; padding is -1); whether the first run
  // continues the previous block's id; how far the last run's id goes on
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
    const int off0 = s_off[0];
    const bool cont_in = k > 0 && off0 >= 0 && meta[k - 1] == w &&
                         offs[s0 - 1] == off0;
    int end = n_valid;  // slots (from s0) of the last run's id
    if (n > 0 && n_valid == chunk && !(n == 1 && cont_in)) {
      const int off = s_off[s_run[n - 1]];
      for (int nb = k + 1; nb < nblocks && meta[nb] == w &&
                           offs[(size_t)nb * chunk] == off; ++nb) {
        int len = chunk;  // the leading slots of block nb with this offset
        for (int base = 0; base < chunk; base += 32) {
          const int i = base + lane;
          const bool other = i >= chunk || offs[(size_t)nb * chunk + i] != off;
          const unsigned m = __ballot_sync(0xffffffffu, other);
          if (m) {
            len = base + __ffs(m) - 1;
            break;
          }
        }
        end += len;
        if (len < chunk) break;
      }
    }
    if (lane == 0) {
      s_run[n] = n_valid;
      s_nruns = n;
      s_first = cont_in ? 1 : 0;
      s_end = end;
    }
  }
  __syncthreads();
  const int n_runs = s_nruns, first = s_first, end = s_end;
  // CTA (k, y) of Y: the block's runs first + y, first + y + Y, ... whole,
  // and the y-th share [cw0, cw0 + ncw) of a walk's column vectors (Y = 1
  // unless a walk's segment sums of the whole row would not fit s_wacc)
  const int y = blockIdx.y, Y = gridDim.y;
  const int CV = C / VEC;
  const int perw = (CV + Y - 1) / Y;
  const int cw0 = y * perw, ncw = min(CV, cw0 + perw) - cw0;
  const bool walk = end > chunk && ncw > 0;  // the last run walks
  const int n_own = n_runs - (end > chunk ? 1 : 0);  // runs [first, n_own)
  const int items = max(0, (n_own - first - y + Y - 1) / Y) * CV;

  // 1. short runs, IB items a thread at a time: every table read and row
  // of the batch in flight together
  for (int it0 = tid; it0 < items; it0 += IB * THREADS) {
    int b[IB], e[IB], c[IB];
    TableT* p[IB];
    float cur[IB][VEC], acc[IB][VEC];
#pragma unroll
    for (int u = 0; u < IB; ++u) {
      const int it = it0 + u * THREADS;
      b[u] = e[u] = c[u] = 0;
      p[u] = nullptr;
      if (it < items) {
        const int r = first + y + it / CV * Y;
        if (s_run[r + 1] - s_run[r] <= SHORT) {
          b[u] = s_run[r];
          e[u] = s_run[r + 1];
          c[u] = it % CV * VEC;
          p[u] = table + ((size_t)w * window + s_off[b[u]]) * C + c[u];
          load_vec<VEC>(p[u], cur[u]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[u][i] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < SHORT; ++t) {
      float x[IB][VEC];
#pragma unroll
      for (int u = 0; u < IB; ++u)
        if (b[u] + t < e[u])
          load_vec<VEC>(rows + (size_t)s_row[b[u] + t] * C + c[u], x[u]);
#pragma unroll
      for (int u = 0; u < IB; ++u) {
        if (b[u] + t < e[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[u][i] += w2b::to_f32(w2b::from_f32<TableT>(x[u][i]));
        }
      }
    }
    // one add in the table dtype per block
#pragma unroll
    for (int u = 0; u < IB; ++u) {
      if (p[u] == nullptr) continue;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        cur[u][i] = w2b::to_f32(w2b::from_f32<TableT>(cur[u][i] + acc[u][i]));
      store_vec<VEC>(p[u], cur[u]);
    }
  }
  // 2. longer runs of this block, one item at a time
  for (int it = tid; it < items; it += THREADS) {
    const int r = first + y + it / CV * Y;
    const int rb = s_run[r], re = s_run[r + 1];
    if (re - rb <= SHORT) continue;
    const int c = it % CV * VEC;
    TableT* p = table + ((size_t)w * window + s_off[rb]) * C + c;
    float cur[VEC], acc[VEC];
    load_vec<VEC>(p, cur);
    sum_slots<TableT, RowT, VEC>(rows, s_row, slot_row, s0, chunk, rb, re, c,
                                 C, acc);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      cur[i] = w2b::to_f32(w2b::from_f32<TableT>(cur[i] + acc[i]));
    store_vec<VEC>(p, cur);
  }
  if (!walk) return;  // CTA-uniform
  // 3. the walk, over this CTA's share of the columns: segment j covers
  // slots [max(b_last, j * chunk), min(end, (j + 1) * chunk)) from s0; P
  // segments' sums a pass, in parallel, then added in order by one thread
  // per column vector (the row it stores is reloaded by the same thread on
  // the next pass: exact, every value is already in the table dtype)
  const int b_last = s_run[n_runs - 1];
  const int nseg = (end + chunk - 1) / chunk;
  const int P = WALK_FLOATS / (ncw * VEC);
  TableT* row = table + ((size_t)w * window + s_off[b_last]) * C;
  for (int j0 = 0; j0 < nseg; j0 += P) {
    const int nj = min(P, nseg - j0);
    for (int it = tid; it < nj * ncw; it += THREADS) {
      const int j = j0 + it / ncw, cl = it % ncw;
      float acc[VEC];
      sum_slots<TableT, RowT, VEC>(rows, s_row, slot_row, s0, chunk,
                                   max(b_last, j * chunk),
                                   min(end, (j + 1) * chunk),
                                   (cw0 + cl) * VEC, C, acc);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_wacc[((j - j0) * ncw + cl) * VEC + i] = acc[i];
    }
    __syncthreads();
    for (int cl = tid; cl < ncw; cl += THREADS) {
      TableT* p = row + (cw0 + cl) * VEC;
      float cur[VEC];
      load_vec<VEC>(p, cur);
      for (int jj = 0; jj < nj; ++jj) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          cur[i] = w2b::to_f32(w2b::from_f32<TableT>(
              cur[i] + s_wacc[(jj * ncw + cl) * VEC + i]));
      }
      store_vec<VEC>(p, cur);
    }
    __syncthreads();
  }
}

template <typename TableT, typename RowT, int VEC>
int launch(void* table, const void* rows, const int* slot_row, const int* offs,
           const int* meta, int nblocks, int window, int chunk, int C,
           cudaStream_t stream) {
  // one CTA a block, or more where a walk's segment sums of the whole row
  // would not fit the shared buffer (more CTAs were slower at C = 400)
  const int split = (C + WALK_FLOATS - 1) / WALK_FLOATS;
  if (split > 65535) return (int)cudaErrorInvalidValue;
  sweep_kernel<TableT, RowT, VEC><<<dim3(nblocks, split), THREADS, 0,
                                    stream>>>(
      static_cast<TableT*>(table), static_cast<const RowT*>(rows), slot_row,
      offs, meta, nblocks, window, chunk, C);
  return (int)cudaGetLastError();
}

template <typename TableT, typename RowT>
int launch_vec(void* table, const void* rows, const int* slot_row,
               const int* offs, const int* meta, int nblocks, int window,
               int chunk, int C, cudaStream_t stream) {
  if (w2b::rows_vec4<TableT, RowT>(table, rows, C))
    return launch<TableT, RowT, 4>(table, rows, slot_row, offs, meta, nblocks,
                                   window, chunk, C, stream);
  return launch<TableT, RowT, 1>(table, rows, slot_row, offs, meta, nblocks,
                                 window, chunk, C, stream);
}

}  // namespace

extern "C" {

// table [nwin * window (or fewer), C]; rows [N + 1, C] or [N, C] (slot_row
// names a row only where offs >= 0); slot_row, offs: [nblocks * chunk]
// int32 per plan slot, the source row and the in-window offset (-1 =
// padding); meta: [nblocks] int32, the window of each block.
// table_dtype / row_dtype: 0 = float32, 1 = bfloat16 (rows in float32 or
// in the table dtype).  Returns cudaGetLastError() after the launch
// (0 = launched).
int w2b_sweep_scatter(void* table, const void* rows, const int* slot_row,
                      const int* offs, const int* meta, int nblocks,
                      int window, int chunk, int C, int table_dtype,
                      int row_dtype, void* stream) {
  if (nblocks < 0 || window < 1 || chunk < 1 || chunk > MAX_CHUNK || C < 1)
    return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(table, rows, slot_row, offs, meta,
                                            nblocks, window, chunk, C, s);
  if (table_dtype == 1 && row_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(
        table, rows, slot_row, offs, meta, nblocks, window, chunk, C, s);
  if (table_dtype == 0 && row_dtype == 0)
    return launch_vec<float, float>(table, rows, slot_row, offs, meta,
                                    nblocks, window, chunk, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
