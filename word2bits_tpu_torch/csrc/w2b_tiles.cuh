// The tiled sorted scatter-add template, table[ids] += rows, of kernels 2
// and 3 (csrc/span_scatter.cu), kernel 6 (csrc/hot_slice.cu) and kernels 7
// and 8 (csrc/group_rmw.cu).  Each entry point instantiates it with its own
// constants (TileCfg), chosen by timing at its own shapes, a row source
// (csrc/w2b_rows.cuh: kernels 2 and 7 read the fused CBOW step's rows either
// materialized or from their three parts) and one of three
// epilogues, which say what a run's one read-modify-write does with the
// table row's values `cur` and the run's float32 sum:
//   * AddSum (kernels 2, 3 and 7): cur += sum;
//   * AddRoundedSum (kernel 8): cur += the sum rounded to the table dtype,
//     the whole id's sum (a cut run's pieces added first), never a piece;
//   * HeadFold (kernel 6 with `extra`): cur = round(cur + extra[id]) as
//     the row is read, then cur += sum; it also stores the head rows that
//     no row reaches (below).
// Each stores cur with one rounding to the table dtype.
//
// The contract:
//   * each row is first rounded to the table dtype;
//   * duplicates of an id are summed in float32;
//   * each touched table row gets exactly ONE add in the table dtype, by
//     one thread per column vector, never an atomic on the table or on a
//     sum: the summation order is fixed by the plan (the stable sort of the
//     ids), so the result does not depend on scheduling and two launches
//     give bit-equal tables;
//   * ids outside [0, V) (negative ids, the 0x7FFFFFF0 drop sentinel, the
//     cold key H of kernel 6's plan) are dropped;
//   * the table is updated in place; no temporary the size of the table.
//
// The sorted stream is cut into tiles of L slots and the columns into
// groups of at most GROUP, one CTA each, all at once (column groups never
// meet):
//   * The CTA stages its tile's ids and source rows in shared memory; warp
//     0 finds the runs in it (ballots on neighbouring ids) and cuts each
//     into chunks of at most SUB rows.
//   * Every (chunk, column vector) item goes to one thread, IB at a time,
//     neighbouring threads on neighbouring columns; the thread sums the
//     chunk's rows from 0 in slot order.  With TileCfg::BATCH (kernels 6
//     and 8) all the loads of a thread's IB items (rows and table rows) go
//     out together, branch-free at clamped addresses, before any is used.
//     Without it (kernels 2, 3 and 7) each row's load sits in its own
//     branch with its rounding, so that the compiled code waits for each
//     load before it issues the next: SUB * IB round trips an item batch.
//     A run of one chunk (most runs) is finished by that thread: its table
//     row's read was in flight with the rows, and it makes the row's one
//     read-modify-write.  A longer run's chunk sums go to shared memory,
//     and after a barrier one thread per column vector adds them in chunk
//     order and makes the row's read-modify-write.  So no thread sums more
//     than SUB of a run's rows in series, and no CTA more than L.
//   * A run cut by tile edges leaves one piece in each tile it touches,
//     summed as above into a float32 partial of the workspace (slot 2t + 1
//     for the piece in the run's first tile t, 2t in a later tile t).  Each
//     piece's CTA writes its partial, fences, and bumps the run's arrival
//     counter (one per first tile and column group; the kernel's only
//     atomics); the CTA that arrives last adds the partials in tile order,
//     one thread per column vector, makes the run's one read-modify-write
//     of the table row and resets the counter to 0 for the next call.  No
//     CTA waits for another.  A warp of probes a tile apart finds the
//     run's first and last tile from neighbouring ids.
//   * HeadFold with `extra`: ceil(V / L) more CTAs per column group, past
//     the tiles, each fold the head rows of its L whose run is empty
//     (starts[h] == starts[h + 1]) and store them; a row with a run is
//     folded by its run's one read-modify-write.  So every head row is
//     folded and stored once, by one CTA.
// The workspace (TileCfg::partials floats and TileCfg::counters int32
// counters, the counters zero between calls) is allocated by the caller.
#pragma once

#include "w2b_rows.cuh"

// W2B_TILE_STOP = 1, 2 or 3 builds a kernel that returns after staging its
// tile and finding the runs, after step 1 or after step 2 below, leaving
// the table incomplete (tools/tune_kernels.py times such builds to see
// where the time goes); 0, the default, compiles none of it.
#ifndef W2B_TILE_STOP
#define W2B_TILE_STOP 0
#endif

namespace w2b {

template <int L_, int THREADS_, int SUB_, int IB_, int GROUP_,
          bool BATCH_ = false>
struct TileCfg {
  static constexpr int L = L_;              // slots of a tile
  static constexpr int THREADS = THREADS_;
  static constexpr int SUB = SUB_;          // rows of a chunk: the most a
                                            // thread sums
  static constexpr int IB = IB_;            // chunks in flight per thread
  static constexpr int GROUP = GROUP_;      // columns of a CTA, at most
  // step 1 issues all of a thread's loads (its IB chunks' rows and table
  // rows, at clamped addresses, without a branch) before it uses any;
  // without it each row's load sits in its own branch with its rounding,
  // so that the loads of a thread go out one after another
  static constexpr bool BATCH = BATCH_;
  // shared slots: the chunks of the tile's runs of more than SUB rows (at
  // most 2 per SUB + 1 rows), and those runs
  static constexpr int MAX_SLOTS = 2 * L / (SUB + 1);
  static constexpr int MAX_MULTI = L / (SUB + 1);
  static_assert(L % 32 == 0 && L + 2 <= THREADS && THREADS >= 96,
                "staging and the three setup warps need these");

  // The width of C columns' groups: ceil(C / GROUP) groups of equal width
  // (a multiple of 4, so that 16-byte accesses stay aligned), the last
  // narrower.
  static int group_width(int C) {
    const int Y = (C + GROUP - 1) / GROUP;
    return ((C + Y - 1) / Y + 3) / 4 * 4;
  }
  // The workspace of a call with N ids of C columns: 2 * ceil(N / L) * C
  // float32 partials and ceil(N / L) int32 arrival counters per column
  // group, the counters zero before the first call (each call leaves them
  // zero).
  static long long partials(int N, int C) {
    return 2LL * ((N + L - 1) / L) * C;
  }
  static long long counters(int N, int C) {
    const int gw = group_width(C);
    return (long long)((N + L - 1) / L) * ((C + gw - 1) / gw);
  }
};

__device__ __forceinline__ bool in_range(int id, int V) {
  return id >= 0 && id < V;
}

// float32 partials written by other CTAs in this launch: read from L2
template <int VEC>
__device__ __forceinline__ void load_partial(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = __ldcg(p + i);
  }
}

// The first (dir = -1) or last (dir = +1) tile of the run of `id` that
// goes on past tile t's start (dir = -1) or end (dir = +1).  Lane i of the
// calling warp probes tile t + dir * (i + 1) (then 32 tiles further): the
// run fills a tile's last slot before t, its first slot after t.
template <int L>
__device__ __forceinline__ int run_edge_tile(const int* __restrict__ sids,
                                             int id, int t, int dir,
                                             int n_tiles, int lane) {
  for (int base = 0;; base += 32) {
    const int j = t + dir * (base + lane + 1);
    const bool out = dir < 0
        ? j < 0 || __ldg(sids + (size_t)(j + 1) * L - 1) != id
        : j >= n_tiles || __ldg(sids + (size_t)j * L) != id;
    const unsigned m = __ballot_sync(0xffffffffu, out);
    if (m) return t + dir * (base + __ffs(m) - 1);
  }
}

// inclusive prefix sum over the warp
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The epilogues.  load(p, id, c, cur): cur = the values entering row id's
// add at columns c .. c + VEC - 1 (p points there in the table); apply(cur,
// sum): the add of the run's float32 sum.  fold_ctas(V, L): the CTAs
// launched past the tiles (FOLD only).
struct AddSum {
  static constexpr bool FOLD = false;
  bool vec4_ok() const { return true; }
  int fold_ctas(int, int) const { return 0; }
  template <int VEC, typename TableT>
  __device__ __forceinline__ void load(const TableT* p, int, int,
                                       float (&cur)[VEC]) const {
    load_vec<VEC>(p, cur);
  }
  template <typename TableT, int VEC>
  __device__ __forceinline__ void apply(float (&cur)[VEC],
                                        const float (&sum)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] += sum[i];
  }
};

struct AddRoundedSum : AddSum {
  template <typename TableT, int VEC>
  __device__ __forceinline__ void apply(float (&cur)[VEC],
                                        const float (&sum)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] += to_f32(from_f32<TableT>(sum[i]));
  }
};

// The head fold happens as the row is read: its table and extra loads go
// out together, with the rows' loads.  (Without `extra`, kernel 6 is a
// plain AddSum.)
struct HeadFold {
  static constexpr bool FOLD = true;
  const float* extra;   // [V, C] float32
  const int* starts;    // [V + 1] run starts, read by the fold CTAs
  int C;
  bool vec4_ok() const { return aligned(extra, 16); }
  int fold_ctas(int V, int L) const { return (V + L - 1) / L; }
  template <int VEC, typename TableT>
  __device__ __forceinline__ void load(const TableT* p, int id, int c,
                                       float (&cur)[VEC]) const {
    float ex[VEC];
    load_vec<VEC>(p, cur);
    load_vec<VEC>(extra + (size_t)id * C + c, ex);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      cur[i] = to_f32(from_f32<TableT>(cur[i] + ex[i]));
  }
  template <typename TableT, int VEC>
  __device__ __forceinline__ void apply(float (&cur)[VEC],
                                        const float (&sum)[VEC]) const {
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] += sum[i];
  }
};

template <class Cfg, typename TableT, typename Src, int VEC, typename Epi>
__global__ void __launch_bounds__(Cfg::THREADS)
tile_scatter_kernel(TableT* __restrict__ table, const Src src,
                    const int* __restrict__ sids,
                    const int* __restrict__ order, float* __restrict__ part,
                    int* __restrict__ count, int N, int V, int C, int GC,
                    const Epi epi) {
  constexpr int L = Cfg::L, THREADS = Cfg::THREADS, SUB = Cfg::SUB;
  constexpr int IB = Cfg::IB, GROUP = Cfg::GROUP;
  __shared__ __align__(16) float s_acc[Cfg::MAX_SLOTS * GROUP];  // chunk sums
  __shared__ int s_id[L], s_ord[L];  // the tile's sorted ids, source rows
  __shared__ int s_run[L + 1];       // run starts; s_run[n] = end of ids < V
  __shared__ int s_cb[L], s_cu[L], s_cs[L];  // chunk: first slot, run,
                                             // shared slot (-1: none)
  __shared__ int s_mu[Cfg::MAX_MULTI], s_ms[Cfg::MAX_MULTI];  // runs of >
                                                    // SUB rows: run, first slot
  __shared__ int s_n, s_nc, s_nm, s_prev, s_next, s_first, s_last_tile;
  __shared__ int s_done[2];          // this CTA finishes the head/tail run
  // the fold CTAs (HeadFold with extra) come after the tiles
  const int t = blockIdx.x;
  const int n_tiles = Epi::FOLD ? (N + L - 1) / L : (int)gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32;
  // this CTA's columns [c0, c0 + GC) of the tile; column groups never meet
  const int c0 = blockIdx.y * GC, cw = min(GC, C - c0);
  if constexpr (Epi::FOLD) {
    if (t >= n_tiles) {
      // fold the head rows [h0, h0 + L) whose run is empty, no row added:
      // warp 0 lists them, then every (row, column vector) item, IB a
      // thread with their loads in flight together
      const int h0 = (t - n_tiles) * L, pv = cw / VEC;
      if (tid < L) {
        const int h = h0 + tid;
        s_ord[tid] = h < V && __ldg(epi.starts + h) ==
                                  __ldg(epi.starts + h + 1);
      }
      __syncthreads();
      if (tid < 32) {
        int ne = 0;
        for (int base = 0; base < L; base += 32) {
          const bool e = s_ord[base + lane];
          const unsigned m = __ballot_sync(0xffffffffu, e);
          if (e) s_id[ne + __popc(m & ((1u << lane) - 1u))] = h0 + base + lane;
          ne += __popc(m);
        }
        if (lane == 0) s_n = ne;
      }
      __syncthreads();
      const int items = s_n * pv;
      for (int it0 = tid; it0 < items; it0 += IB * THREADS) {
        TableT* p[IB];
        float cur[IB][VEC];
#pragma unroll
        for (int u = 0; u < IB; ++u) {
          // past the end: a repeat of the last item, not stored
          const int it = min(it0 + u * THREADS, items - 1);
          const int r = it / pv, c = c0 + (it - r * pv) * VEC;
          p[u] = table + (size_t)s_id[r] * C + c;
          epi.template load<VEC>(p[u], s_id[r], c, cur[u]);
        }
#pragma unroll
        for (int u = 0; u < IB; ++u) {
          if (it0 + u * THREADS >= items) continue;
          float zero[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) zero[i] = 0.0f;
          epi.template apply<TableT, VEC>(cur[u], zero);
          store_vec<VEC>(p[u], cur[u]);
        }
      }
      return;
    }
  }
  const size_t s0 = (size_t)t * L;
  const int nt = min(L, N - (int)s0);  // slots in this tile
  int* const cnt = count + (size_t)blockIdx.y * n_tiles;
  if (tid < L) {
    s_id[tid] = tid < nt ? sids[s0 + tid] : -1;
    s_ord[tid] = tid < nt ? order[s0 + tid] : 0;
  } else if (tid == L) {
    s_prev = t > 0 ? sids[s0 - 1] : -1;
  } else if (tid == L + 1) {
    s_next = t + 1 < n_tiles ? sids[s0 + L] : -1;
  }
  __syncthreads();
  const int head_id = s_id[0], tail_id = s_id[L - 1];
  // the first run began in an earlier tile; the last goes on in a later one
  const bool hc = in_range(head_id, V) && s_prev == head_id;
  const bool tc = in_range(tail_id, V) && s_next == tail_id;
  if (tid < 32) {
    // warp 0: the runs (the ids in [0, V) are one stretch of the sorted
    // stream, so they end at the last in-range slot), then their chunks
    int n = 0, end = 0;
    for (int base = 0; base < L; base += 32) {
      const int i = base + lane;
      const int id = s_id[i];
      const bool inr = in_range(id, V);
      const bool start = inr && (i == 0 || s_id[i - 1] != id);
      const unsigned m = __ballot_sync(0xffffffffu, start);
      if (start) s_run[n + __popc(m & ((1u << lane) - 1u))] = i;
      n += __popc(m);
      const unsigned mi = __ballot_sync(0xffffffffu, inr);
      if (mi) end = base + 32 - __clz(mi);
    }
    if (lane == 0) s_run[n] = end;
    __syncwarp();
    int nc = 0, ns = 0, nm = 0;
    for (int base = 0; base < n; base += 32) {
      const int r = base + lane;
      const int b = r < n ? s_run[r] : 0;
      const int k = r < n ? (s_run[r + 1] - b + SUB - 1) / SUB : 0;
      const int multi = k > 1 ? 1 : 0;
      const int ck = warp_scan(k, lane), cs = warp_scan(multi * k, lane);
      const int cm = warp_scan(multi, lane);
      const int q0 = nc + ck - k, sl0 = ns + cs - multi * k;
      for (int j = 0; j < k; ++j) {
        s_cb[q0 + j] = b + j * SUB;
        s_cu[q0 + j] = r;
        s_cs[q0 + j] = multi ? sl0 + j : -1;
      }
      if (multi) {
        s_mu[nm + cm - 1] = r;
        s_ms[nm + cm - 1] = sl0;
      }
      nc += __shfl_sync(0xffffffffu, ck, 31);
      ns += __shfl_sync(0xffffffffu, cs, 31);
      nm += __shfl_sync(0xffffffffu, cm, 31);
    }
    if (lane == 0) {
      s_n = n;
      s_nc = nc;
      s_nm = nm;
    }
  } else if (tid < 64) {
    if (hc) s_first = run_edge_tile<L>(sids, head_id, t, -1, n_tiles, lane);
  } else if (tid < 96) {
    if (tc) {
      s_last_tile = run_edge_tile<L>(sids, tail_id, t, 1, n_tiles, lane);
    }
  }
  __syncthreads();
  const int n = s_n, nc = s_nc, nm = s_nm;
  if (n == 0) return;  // CTA-uniform: no id of this tile is in [0, V)
  if constexpr (W2B_TILE_STOP == 1) return;
  const int pv = cw / VEC;  // column vectors of this CTA
  // where run r's sum goes: its table row (-1) or its piece's partial
  auto dest = [&](int r) {
    return r == 0 && hc ? 2 * t : r == n - 1 && tc ? 2 * t + 1 : -1;
  };
  // column c (of the table): the row's one add (the epilogue), rounded to
  // TableT, or the piece's partial
  auto finish = [&](int dst, int c, TableT* p, float (&cur)[VEC],
                    const float (&acc)[VEC]) {
    if (dst < 0) {
      epi.template apply<TableT, VEC>(cur, acc);
      store_vec<VEC>(p, cur);
    } else {
      store_vec<VEC>(part + (size_t)dst * C + c, acc);
    }
  };

  // 1. every chunk, IB a thread at a time, each summed from 0 in slot order
  // with all its rows in flight: a run of one chunk goes straight to its
  // row (whose read is in flight with the rows) or partial, a longer run's
  // chunks to their shared slots
  const int items = nc * pv;
  if constexpr (Cfg::BATCH) {
    for (int it0 = tid; it0 < items; it0 += IB * THREADS) {
      int len[IB], c[IB], dst[IB], sl[IB];
      TableT* p[IB];
      float cur[IB][VEC], x[IB][SUB][VEC];
      // every load first: an item past the end repeats the last item, a
      // chunk's slots past its end repeat its last row (both masked)
#pragma unroll
      for (int u = 0; u < IB; ++u) {
        const int it = min(it0 + u * THREADS, items - 1);
        const int q = it / pv, r = s_cu[q], b = s_cb[q], id = s_id[b];
        len[u] = min(SUB, s_run[r + 1] - b);
        c[u] = (it - q * pv) * VEC;  // within the group
        sl[u] = s_cs[q];
        dst[u] = dest(r);
        p[u] = table + (size_t)id * C + c0 + c[u];
        epi.template load<VEC>(p[u], id, c0 + c[u], cur[u]);
#pragma unroll
        for (int k = 0; k < SUB; ++k)
          src.fetch(s_ord[b + min(k, len[u] - 1)], c0 + c[u], x[u][k]);
      }
#pragma unroll
      for (int u = 0; u < IB; ++u) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[i] = 0.0f;
#pragma unroll
          for (int k = 0; k < SUB; ++k)
            acc[i] = k < len[u] ? acc[i] + x[u][k][i] : acc[i];
        }
        if (it0 + u * THREADS >= items) continue;
        if (sl[u] >= 0) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            s_acc[sl[u] * GROUP + c[u] + i] = acc[i];
        } else {
          finish(dst[u], c0 + c[u], p[u], cur[u], acc);
        }
      }
    }
  } else {
  for (int it0 = tid; it0 < items; it0 += IB * THREADS) {
    int b[IB], e[IB], c[IB], dst[IB], sl[IB];
    TableT* p[IB];
    float cur[IB][VEC], acc[IB][VEC];
#pragma unroll
    for (int u = 0; u < IB; ++u) {
      const int it = it0 + u * THREADS;
      b[u] = e[u] = c[u] = 0;
      dst[u] = sl[u] = -1;
      p[u] = nullptr;
      if (it < items) {
        const int q = it / pv, r = s_cu[q];
        b[u] = s_cb[q];
        e[u] = min(b[u] + SUB, s_run[r + 1]);
        c[u] = (it - q * pv) * VEC;  // within the group
        sl[u] = s_cs[q];
        if (sl[u] < 0) {
          dst[u] = dest(r);
          const int id = s_id[b[u]];
          p[u] = table + (size_t)id * C + c0 + c[u];
          if (dst[u] < 0)
            epi.template load<VEC>(p[u], id, c0 + c[u], cur[u]);
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[u][i] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      float x[IB][VEC];
#pragma unroll
      for (int u = 0; u < IB; ++u)
        if (b[u] + k < e[u]) src.fetch(s_ord[b[u] + k], c0 + c[u], x[u]);
#pragma unroll
      for (int u = 0; u < IB; ++u) {
        if (b[u] + k < e[u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[u][i] += x[u][i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < IB; ++u) {
      if (e[u] <= b[u]) continue;
      if (sl[u] >= 0) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          s_acc[sl[u] * GROUP + c[u] + i] = acc[u][i];
      } else {
        finish(dst[u], c0 + c[u], p[u], cur[u], acc[u]);
      }
    }
  }
  }
  if constexpr (W2B_TILE_STOP == 2) return;
  if (nm > 0) {  // CTA-uniform
    __syncthreads();
    // 2. the runs of more than SUB rows: their chunk sums added in chunk
    // order, one thread per column vector
    for (int it = tid; it < nm * pv; it += THREADS) {
      const int m = it / pv, r = s_mu[m], sl0 = s_ms[m];
      const int k = (s_run[r + 1] - s_run[r] + SUB - 1) / SUB;
      const int c = (it - m * pv) * VEC;
      const int dst = dest(r), id = s_id[s_run[r]];
      TableT* p = table + (size_t)id * C + c0 + c;
      float cur[VEC], sum[VEC];
      if (dst < 0) epi.template load<VEC>(p, id, c0 + c, cur);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
      for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          sum[i] += s_acc[(sl0 + j) * GROUP + c + i];
      }
      finish(dst, c0 + c, p, cur, sum);
    }
  }
  if constexpr (W2B_TILE_STOP == 3) return;
  if (!hc && !tc) return;  // CTA-uniform: no run of this tile is cut

  // 3. the cut runs: arrive, and finish the runs whose last piece this is
  __threadfence();  // this thread's partials, before the arrival
  __syncthreads();
  const bool whole = hc && tc && n == 1;  // one run fills the tile
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s_done[k] = 0;
      if (k == 0 ? !hc : !tc || whole) continue;
      const int f = k == 0 ? s_first : t;
      const int l = k == 0 && !whole ? t : s_last_tile;
      if (atomicAdd(cnt + f, 1) == l - f) {
        cnt[f] = 0;
        s_done[k] = 1;
      }
    }
    __threadfence();  // the arrivals, before the other pieces are read
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!s_done[k]) continue;  // CTA-uniform
    const int f = k == 0 ? s_first : t;
    const int l = k == 0 && !whole ? t : s_last_tile;
    const int id = k == 0 ? head_id : tail_id;
    for (int cv = tid; cv < pv; cv += THREADS) {
      const int c = c0 + cv * VEC;
      float sum[VEC], cur[VEC];
      TableT* p = table + (size_t)id * C + c;
      epi.template load<VEC>(p, id, c, cur);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sum[i] = 0.0f;
      // the pieces in tile order: 2f + 1, then 2j for j = f + 1 .. l
#pragma unroll 4
      for (int j = f; j <= l; ++j) {
        float x[VEC];
        load_partial<VEC>(part + (size_t)(j == f ? 2 * f + 1 : 2 * j) * C + c,
                          x);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sum[i] += x[i];
      }
      finish(-1, c, p, cur, sum);
    }
  }
}

// One launch: the tiles of the N sorted ids and the epilogue's fold CTAs,
// times the column groups.
template <class Cfg, typename TableT, int VEC, typename Src,
          typename Epi = AddSum>
int tile_launch(void* table, const Src& src, const int* sids,
                const int* order, float* part, int* count, int N, int V,
                int C, cudaStream_t stream, const Epi& epi = Epi{}) {
  const int GC = Cfg::group_width(C);
  const int ctas = (N + Cfg::L - 1) / Cfg::L + epi.fold_ctas(V, Cfg::L);
  if (ctas == 0) return 0;
  tile_scatter_kernel<Cfg, TableT, Src, VEC, Epi>
      <<<dim3(ctas, (C + GC - 1) / GC), Cfg::THREADS, 0, stream>>>(
          static_cast<TableT*>(table), src, sids, order, part, count, N, V, C,
          GC, epi);
  return (int)cudaGetLastError();
}

template <class Cfg, typename TableT, typename RowT, typename Epi>
int tile_launch_dense(void* table, const void* rows, const int* sids,
                      const int* order, float* part, int* count, int N, int V,
                      int C, cudaStream_t stream, const Epi& epi) {
  const RowT* r = static_cast<const RowT*>(rows);
  // 4 columns per thread when every row start is aligned for one access
  if (rows_vec4<TableT, RowT>(table, rows, C) && aligned(part, 16) &&
      epi.vec4_ok())
    return tile_launch<Cfg, TableT, 4>(table, DenseRows<TableT, RowT, 4>{r, C},
                                       sids, order, part, count, N, V, C,
                                       stream, epi);
  return tile_launch<Cfg, TableT, 1>(table, DenseRows<TableT, RowT, 1>{r, C},
                                     sids, order, part, count, N, V, C,
                                     stream, epi);
}

// The dense-row scatter in the three (table, row) dtype pairs: 0 = float32,
// 1 = bfloat16 (rows in float32 or in the table dtype).
template <class Cfg, typename Epi = AddSum>
int tile_scatter_dense(void* table, const void* rows, const int* sids,
                       const int* order, float* part, int* count, int N,
                       int V, int C, int table_dtype, int row_dtype,
                       void* stream, const Epi& epi = Epi{}) {
  if (N < 0 || V < 0 || C < 1 || C > 12288) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return tile_launch_dense<Cfg, __nv_bfloat16, float>(
        table, rows, sids, order, part, count, N, V, C, s, epi);
  if (table_dtype == 1 && row_dtype == 1)
    return tile_launch_dense<Cfg, __nv_bfloat16, __nv_bfloat16>(
        table, rows, sids, order, part, count, N, V, C, s, epi);
  if (table_dtype == 0 && row_dtype == 0)
    return tile_launch_dense<Cfg, float, float>(table, rows, sids, order,
                                                part, count, N, V, C, s, epi);
  return (int)cudaErrorInvalidValue;
}

template <class Cfg, typename TableT, typename RowT>
int tile_launch_parts(void* table, const void* du, const void* dvc,
                      const void* dvn, const int* sids, const int* order,
                      float* part, int* count, int N, int n_slab, int W,
                      int V, int D, cudaStream_t stream) {
  const RowT* u = static_cast<const RowT*>(du);
  const RowT* c = static_cast<const RowT*>(dvc);
  const RowT* n = static_cast<const RowT*>(dvn);
  const size_t rb = 4 * sizeof(RowT);
  // 4 columns per thread when no vector straddles column D and every row
  // start of every part is aligned for one access
  if (D % 4 == 0 && aligned(table, 4 * sizeof(TableT)) && aligned(du, rb) &&
      aligned(dvc, rb) && aligned(dvn, rb) && aligned(part, 16))
    return tile_launch<Cfg, TableT, 4>(
        table, SlabParts<TableT, RowT, 4>{u, c, n, n_slab, W, D}, sids, order,
        part, count, N, V, 2 * D, stream);
  return tile_launch<Cfg, TableT, 1>(
      table, SlabParts<TableT, RowT, 1>{u, c, n, n_slab, W, D}, sids, order,
      part, count, N, V, 2 * D, stream);
}

// The fused CBOW step's scatter from its three parts (SlabParts), in the
// dtype pairs of tile_scatter_dense: the plan is of the N = n_slab + n_neg
// ids [slab ids; negative ids], du [n_slab, D], dvc [n_slab - 2W, D] and
// dvn [n_neg, D] in row_dtype, the table [V, 2D].
template <class Cfg>
int tile_scatter_parts(void* table, const void* du, const void* dvc,
                       const void* dvn, const int* sids, const int* order,
                       float* part, int* count, int N, int n_slab, int W,
                       int V, int D, int table_dtype, int row_dtype,
                       void* stream) {
  if (N < 0 || W < 0 || n_slab < 2 * W || n_slab > N || V < 0 || D < 1 ||
      D > 6144)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && row_dtype == 0)
    return tile_launch_parts<Cfg, __nv_bfloat16, float>(
        table, du, dvc, dvn, sids, order, part, count, N, n_slab, W, V, D, s);
  if (table_dtype == 1 && row_dtype == 1)
    return tile_launch_parts<Cfg, __nv_bfloat16, __nv_bfloat16>(
        table, du, dvc, dvn, sids, order, part, count, N, n_slab, W, V, D, s);
  if (table_dtype == 0 && row_dtype == 0)
    return tile_launch_parts<Cfg, float, float>(
        table, du, dvc, dvn, sids, order, part, count, N, n_slab, W, V, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace w2b
