// Fused shared-negative phase of the slab and fused CBOW steps, for sm_90a.
//
// Replaces the TPU kernel `quantized_scores_pallas` (the JAX package's
// kernels/score_pallas.py: body `_kernel` at :36, entry point at :87,
// pl.pallas_call at :110).  Per tile t of G centers that share P*K
// negatives (P pools of K; center g uses pool g % P):
//
//   q        = quantize(v_rows[t])                          [PK, D]
//   f[g, k]  = sum_d cavg[t, g, d] * q[k, d]                [G, PK]
//   m[g, k]  = (negs[k] != centers[g]) * af[g] * (g % P == k / K)
//   g[g, k]  = (0 - sigma_LUT(f)) * alpha * m
//   cavge    = g @ q                                        [G, D]
//   dv       = g^T @ cavg[t] - 2*alpha*reg * v_rows * visits,
//              visits[k] = sum_g m[g, k]                    [PK, D]
//   loss[t]  = sum (log sigma_exact(-f) - reg * ||q[k]||^2) * m
//
// Bound on the H100: about equal parts bytes and operations.  At the
// shipped shape (T = 128 tiles, G = 64, PK = 48, D = 200, float32) it reads
// cavg (6.6 MB) and v_rows (4.9 MB) and writes cavge (6.6 MB) and dv
// (4.9 MB): 23.1 MB, 6.9 us at 3.35 TB/s; the three products are 0.47
// GFLOP, 7.0 us at the 67 TFLOP/s float32 rate outside the tensor cores.
//
// Design.  A tile runs on a thread-block cluster of `cl` CTAs split along
// D (the wrapper's cluster_size: one CTA at the shipped shape, where 1, 2
// and 4 were timed and 1 was the fastest; the smallest cluster whose CTA
// fits in shared memory at wider rows, 2 at D = 800), so the grid has
// T * cl CTAs of 512 threads, each holding Dc = ceil(D / cl) columns
// (rounded up to 4) of the tile:
//   1. Each CTA stages its columns of the tile's cavg block [G, D] and
//      v_rows block [PK, D] with cp.async (16-byte copies where the rows
//      allow, all in flight at once), computes the 997 values of the LUT
//      sigmoid's bins into a table meanwhile, then quantizes its own copies
//      of v_rows in shared memory.  Rows are padded to a stride of Dp
//      floats, Dp / 4 odd, so that 16-byte loads of 8 neighbouring rows hit
//      8 distinct bank groups.
//   2. It computes the partial scores of every (g, k) pair over its columns,
//      each thread a 4 x 4 block of pairs (rows g = gb + i * G/4, so that
//      neighbouring threads read neighbouring rows), with 16-byte shared
//      loads for both operands: 8 loads per 64 multiply-adds.  Each partial
//      is pushed (a store into distributed shared memory) to the CTA of the
//      cluster that owns the pair's row g (rank g / ceil(G / cl)), into the
//      slot of the pushing rank; so are the partial ||q[k]||^2 when reg != 0.
//   3. After a cluster barrier, the owner of row g adds the cl partials of
//      each of its pairs in rank order (the same float order for every
//      launch), computes g (the LUT sigmoid read from the table, the same
//      bits as computing it) and, for an unmasked pair, its loss term, and
//      pushes g to every CTA of the cluster; the loss partial goes to rank
//      0.
//   4. After a second cluster barrier every CTA holds the whole g and
//      writes cavge and dv for its own columns only: no output needs a
//      reduction across CTAs.  Both products give each thread a 4 x 4
//      output block with 16-byte shared loads (8 loads per 64 multiply-adds
//      for cavge, 2 per 16 for dv).  Rank 0 writes the tile's loss, the sum
//      of the ranks' partials in rank order.
// There are no atomics; two launches give bit-equal outputs.  The product
// loops are unrolled by 4 (W2B_SCORE_UNROLL).  Tried and not kept
// (tools/tune_kernels.py, PERF.md): clusters of 2, 4 and 8 at the shipped
// shape; 128 to 768 threads; staging in 2 or 4 pieces of columns, each
// piece's scores started as it lands; the three products on the tensor
// cores as 3xTF32 mma.sync (each operand split in two TF32 parts), slower
// than the CUDA cores here for its scalar fragment loads and splits.
//
// What the earlier design (one 256-thread CTA per tile, the whole tile in
// shared memory) lost, and what this one does about it: one 8-warp CTA an
// SM with nothing to hide its load latency (here 16 warps); staging with
// 4-byte loads, an integer divide per element and an odd row stride that
// ruled out 16-byte shared stores (here cp.async with 16-byte copies and a
// padded stride that is a multiple of 4); an output product that issued 8
// scalar shared loads of g and one of q for every 8 multiply-adds (here
// 16-byte loads of both, four times fewer per multiply-add); and two
// exponentials, two divisions and a logarithm for every pair (here one
// table read, and the logarithm only for the unmasked pairs).  What is
// left: four phases per CTA separated by barriers, each a few us, one CTA
// an SM (PERF.md section 6 has their times).
//
// Every multiply the plain version rounds before an add or subtract is
// written with __fmul_rn/__fsub_rn (no contraction into an FMA); the dot
// products are FMA chains in their own order, as cuBLAS's are.
#include <cooperative_groups.h>

#include "w2b_common.cuh"

// CTA threads and the unrolling of the product loops (the next shared
// loads in flight), chosen by timing (tools/tune_kernels.py)
#ifndef W2B_SCORE_THREADS
#define W2B_SCORE_THREADS 512
#endif
#ifndef W2B_SCORE_UNROLL
#define W2B_SCORE_UNROLL 4
#endif
// (in the kernel's 16-byte instantiation; the other, for ragged widths,
// runs out of registers unrolled)
#define W2B_PRAGMA(x) _Pragma(#x)
#define W2B_UNROLL_N(n) W2B_PRAGMA(unroll (VEC == 4 ? n : 1))
#define W2B_UNROLL W2B_UNROLL_N(W2B_SCORE_UNROLL)
// tools/tune_kernels.py only: a build that returns after phase 1, 2 or 3
// (every CTA at the same point, its outputs unwritten), to time the phases
#ifndef W2B_SCORE_STOP
#define W2B_SCORE_STOP 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = W2B_SCORE_THREADS;
constexpr int MAX_CLUSTER = 8;
constexpr int LUT_SLOTS = 1000;  // w2b::LUT_BINS, rounded up to 4

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ inline int ceil_div(int x, int m) {
  return (x + m - 1) / m;
}

// One CTA's shared memory: int64 ids first (8-byte aligned), then float32
// arrays whose sizes are multiples of 4, so each starts 16-byte aligned.
// G, P*K and a CTA's columns are padded to 4; the row stride Dp is 4 times
// an odd number, so that 16-byte loads of 8 neighbouring rows fall in 8
// distinct bank groups.
struct Layout {
  int Gp, PKp, Gr, Dc, Dp, cl;
  __host__ __device__ Layout(int G, int PK, int D, int cl_)
      : Gp(round_up(G, 4)), PKp(round_up(PK, 4)), Gr(ceil_div(G, cl_)),
        Dc(round_up(ceil_div(D, cl_), 4)), Dp(0), cl(cl_) {
    Dp = (Dc / 4) % 2 ? Dc : Dc + 4;
  }
  __host__ __device__ size_t floats() const {
    return (size_t)(Gp + PKp) * Dp            // cavg, q columns
           + (size_t)cl * Gr * PKp            // partial scores pushed here
           + (size_t)Gp * PKp                 // g
           + (size_t)cl * PKp                 // partial ||q[k]||^2 pushed here
           + (size_t)PKp + Gp                 // visits, af
           + MAX_CLUSTER                      // loss partials (rank 0)
           + LUT_SLOTS;                       // the LUT sigmoid's values
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)(Gp + PKp) * 8 + floats() * 4;
  }
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += a[i] . b[j] over the 4 components, in component order
__device__ __forceinline__ void fma_block(float (&acc)[4][4],
                                          const float4 (&a)[4],
                                          const float4 (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = acc[i][j];
      s = fmaf(a[i].x, b[j].x, s);
      s = fmaf(a[i].y, b[j].y, s);
      s = fmaf(a[i].z, b[j].z, s);
      s = fmaf(a[i].w, b[j].w, s);
      acc[i][j] = s;
    }
  }
}

// Stage rows [0, n) of a [rows, D] block's columns [d0, d0 + w) into
// dst [np][Dp] (zero past n rows and past w columns, up to wp = w rounded up
// to 4); VEC = 4: 16-byte copies (w is then a multiple of 4).  The copies
// complete at cp_async_wait_all.
template <int VEC>
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int np, int D, int w, int wp, int Dp,
                                      int tid) {
  const int nv = wp / VEC;
  for (int i = tid; i < np * nv; i += THREADS) {
    const int r = i / nv, c = (i - r * nv) * VEC;
    float* s = dst + (size_t)r * Dp + c;
    if (r < n && c < w) {
      if constexpr (VEC == 4) cp_async16(s, src + (size_t)r * D + c);
      else cp_async4(s, src + (size_t)r * D + c);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) s[v] = 0.0f;
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ cavg, const float* __restrict__ vrows,
             const long long* __restrict__ centers,
             const long long* __restrict__ negs, const float* __restrict__ af,
             const float* __restrict__ alpha_p, float* __restrict__ cavge_o,
             float* __restrict__ dv_o, float* __restrict__ loss_o, int G,
             int PK, int D, int P, int bitlevel, float reg) {
  extern __shared__ __align__(16) unsigned char raw[];
  __shared__ float red[THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const Layout L(G, PK, D, cl);
  const int Gp = L.Gp, PKp = L.PKp, Gr = L.Gr, Dp = L.Dp;
  long long* cid = reinterpret_cast<long long*>(raw);  // [Gp]
  long long* nid = cid + Gp;                           // [PKp]
  float* cs = reinterpret_cast<float*>(nid + PKp);     // [Gp][Dp] cavg
  float* qs = cs + (size_t)Gp * Dp;                    // [PKp][Dp] q
  float* recv = qs + (size_t)PKp * Dp;                 // [cl][Gr][PKp]
  float* gs = recv + (size_t)cl * Gr * PKp;            // [Gp][PKp] g
  float* vqr = gs + (size_t)Gp * PKp;                  // [cl][PKp]
  float* vis = vqr + (size_t)cl * PKp;                 // [PKp] visits
  float* afs = vis + PKp;                              // [Gp]
  float* lossp = afs + Gp;                             // [MAX_CLUSTER]
  float* lut = lossp + MAX_CLUSTER;                    // [LUT_SLOTS]

  const int t = blockIdx.x / cl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = rank * L.Dc;
  const int w = max(0, min(L.Dc, D - d0));  // this CTA's columns
  const int wp = round_up(w, 4);
  const float alpha = *alpha_p;
  const int K = PK / P;
  const float* cav = cavg + (size_t)t * G * D + d0;
  const float* vr = vrows + (size_t)t * PK * D + d0;
  // every CTA of the cluster must have started before any writes to its
  // shared memory: arrive now, wait before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. stage this CTA's columns (all copies in flight), the ids, af and
  // the LUT sigmoid's values; padding rows are zero and padding ids match
  // nothing
  stage<VEC>(cs, cav, G, Gp, D, w, wp, Dp, tid);
  stage<VEC>(qs, vr, PK, PKp, D, w, wp, Dp, tid);
  for (int i = tid; i < Gp; i += THREADS) {
    cid[i] = i < G ? centers[(size_t)t * G + i] : -1;
    afs[i] = i < G ? af[(size_t)t * G + i] : 0.0f;
  }
  for (int i = tid; i < PKp; i += THREADS)
    nid[i] = i < PK ? negs[(size_t)t * PK + i] : -2;
  for (int i = tid; i < w2b::LUT_BINS; i += THREADS)
    lut[i] = w2b::sigmoid_lut_value((float)i);
  cp_async_wait_all();
  {  // quantize the copies this thread made (stage's loop, same items)
    const int nv = wp / VEC;
    for (int i = tid; i < PK * nv; i += THREADS) {
      const int r = i / nv, c = (i - r * nv) * VEC;
      float* s = qs + (size_t)r * Dp + c;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (c + v < w) s[v] = w2b::quantize(s[v], bitlevel);
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (W2B_SCORE_STOP == 1) return;

  // 2. partial scores over this CTA's columns, 4 x 4 pairs per thread, each
  // pushed to the rank that owns its row
  auto push = [&](int g, int k, float v) {
    if (g < G && k < PK) {
      const int o = g / Gr;
      *cluster.map_shared_rank(
          recv + ((size_t)rank * Gr + (g - o * Gr)) * PKp + k, o) = v;
    }
  };
  // rows g = gb + i * Gp/4: neighbouring threads on neighbouring rows
  const int ngb = Gp / 4, nkb = PKp / 4;
  for (int blk = tid; blk < ngb * nkb; blk += THREADS) {
    const int gb = blk % ngb, kb = blk / ngb;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    W2B_UNROLL
    for (int d = 0; d < wp; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld4(cs + (size_t)(gb + ngb * i) * Dp + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = ld4(qs + (size_t)(kb + nkb * j) * Dp + d);
      fma_block(acc, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) push(gb + ngb * i, kb + nkb * j, acc[i][j]);
  }

  // the mask of pair (g, k), as the plain version's float product
  auto mask = [&](int g, int k) -> float {
    if (g >= G || k >= PK || nid[k] == cid[g]) return 0.0f;
    if (P > 1 && g % P != k / K) return 0.0f;
    return afs[g];
  };

  if (reg != 0.0f) {
    // partial ||q[k]||^2 over this CTA's columns, pushed to every rank
    for (int k = warp; k < PK; k += THREADS / 32) {
      float s = 0.0f;
      for (int d = lane; d < w; d += 32) {
        const float q = qs[(size_t)k * Dp + d];
        s = __fadd_rn(s, __fmul_rn(q, q));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane < cl) *cluster.map_shared_rank(vqr + rank * PKp + k, lane) = s;
    }
    for (int k = tid; k < PK; k += THREADS) {
      float s = 0.0f;
      for (int g = 0; g < G; ++g) s += mask(g, k);
      vis[k] = s;
    }
  }

  cluster.sync();  // every partial has arrived
  if (W2B_SCORE_STOP == 2) return;

  // 3. this rank's rows: the scores (partials added in rank order), g
  // pushed to every rank, the loss
  const int g_lo = rank * Gr, nrow = max(0, min(G - g_lo, Gr));
  float loss = 0.0f;
  W2B_UNROLL
  for (int i = tid; i < nrow * PKp; i += THREADS) {
    const int gl = i / PKp, k = i - gl * PKp, g = g_lo + gl;
    float gv = 0.0f;
    if (k < PK) {
      float f = recv[(size_t)gl * PKp + k];
      for (int s = 1; s < cl; ++s) f += recv[((size_t)s * Gr + gl) * PKp + k];
      const float m = mask(g, k);
      // w2b::sigmoid_lut(f), its bins' values read from the table
      const int bin = min(max((int)w2b::sigmoid_lut_bin(f), 0),
                          w2b::LUT_BINS - 1);
      const float sl = f > 6.0f ? 1.0f : f < -6.0f ? 0.0f : lut[bin];
      gv = __fmul_rn(__fmul_rn(0.0f - sl, alpha), m);
      if (m != 0.0f) {  // a masked pair's term is a zero (its l is finite)
        float l = logf(w2b::sigmoid_exact(-f));
        if (reg != 0.0f) {
          float vq = vqr[k];
          for (int s = 1; s < cl; ++s) vq = __fadd_rn(vq, vqr[s * PKp + k]);
          l = __fsub_rn(l, __fmul_rn(reg, vq));
        }
        loss += __fmul_rn(l, m);
      }
    }
    for (int s = 0; s < cl; ++s)
      *cluster.map_shared_rank(gs + (size_t)g * PKp + k, s) = gv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) loss += __shfl_xor_sync(0xffffffffu, loss, o);
  if (lane == 0) red[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int q = 0; q < THREADS / 32; ++q) s += red[q];
    *cluster.map_shared_rank(lossp + rank, 0) = s;
  }
  cluster.sync();  // g complete in every rank; the loss partials at rank 0
  if (rank == 0 && tid == 0) {
    float s = 0.0f;
    for (int q = 0; q < cl; ++q) s += lossp[q];
    loss_o[t] = s;
  }
  if (W2B_SCORE_STOP == 3) return;

  // 4. this CTA's columns of cavge = g @ q and dv = g^T @ cavg (- the
  // decay)
  const float two_ar = __fmul_rn(__fmul_rn(2.0f, alpha), reg);
  // one output of row `row` (a center for cavge, a negative for dv) and
  // column dd of this CTA
  auto out = [&](bool is_c, int row, int dd, float v) {
    if (row >= (is_c ? G : PK) || dd >= w) return;
    if (!is_c && reg != 0.0f)
      v = __fsub_rn(v, __fmul_rn(__fmul_rn(two_ar, __ldg(vr + (size_t)row * D
                                                         + dd)),
                                 vis[row]));
    (is_c ? cavge_o + ((size_t)t * G + row) * D
          : dv_o + ((size_t)t * PK + row) * D)[d0 + dd] = v;
  };
  // 4 x 4 outputs per thread
  const int ndq = wp / 4, ngq = Gp / 4, nkq = PKp / 4;
  const int n_c = ngq * ndq, n_all = n_c + nkq * ndq;
  for (int it = tid; it < n_all; it += THREADS) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const bool is_c = it < n_c;
    const int j2 = is_c ? it : it - n_c;
    const int rq = j2 / ndq, dq = j2 - rq * ndq;
    const int r0 = 4 * rq, dd = 4 * dq;
    if (is_c) {
      // cavge rows r0..r0+3: sum over k (PKp, g and q zero past PK)
      W2B_UNROLL
      for (int k = 0; k < PKp; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(gs + (size_t)(r0 + i) * PKp + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ld4(qs + (size_t)(k + j) * Dp + dd);
        // acc[i][c] += sum_j a[i][j] * b[j][c], in j order
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(ai[j], b[j].x, acc[i][0]);
            acc[i][1] = fmaf(ai[j], b[j].y, acc[i][1]);
            acc[i][2] = fmaf(ai[j], b[j].z, acc[i][2]);
            acc[i][3] = fmaf(ai[j], b[j].w, acc[i][3]);
          }
        }
      }
    } else {
      // dv rows r0..r0+3 (negatives): sum over the G centers
      W2B_UNROLL
      for (int g = 0; g < G; ++g) {
        const float4 a = ld4(gs + (size_t)g * PKp + r0);
        const float4 b = ld4(cs + (size_t)g * Dp + dd);
        const float ai[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(ai[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(ai[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(ai[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(ai[i], b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + i;
      if (VEC == 4 && row < (is_c ? G : PK) && dd < w &&
          (is_c || reg == 0.0f)) {
        // w is a multiple of 4 here: columns dd..dd+3 are this CTA's
        float* o = (is_c ? cavge_o + ((size_t)t * G + row) * D
                         : dv_o + ((size_t)t * PK + row) * D) + d0 + dd;
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) out(is_c, row, dd + c, acc[i][c]);
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int VEC>
int launch(const float* cavg, const float* vrows, const long long* centers,
           const long long* negs, const float* af, const float* alpha,
           float* cavge, float* dv, float* loss, int T, int G, int PK, int D,
           int P, int bitlevel, float reg, int cl, cudaStream_t stream) {
  const size_t smem = Layout(G, PK, D, cl).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)T * (unsigned)cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, score_kernel<VEC>, cavg, vrows, centers,
                           negs, af, alpha, cavge, dv, loss, G, PK, D, P,
                           bitlevel, reg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs with a cluster of `cluster` CTAs per
// tile (the wrapper checks the card's limit).
long long w2b_score_smem_bytes(int G, int PK, int D, int cluster) {
  return (long long)Layout(G, PK, D, cluster).bytes();
}

// CTA threads (a build constant).
int w2b_score_threads(void) { return THREADS; }

// cavg [T, G, D] f32, vrows [T, PK, D] f32, centers [T, G] int64, negs
// [T, PK] int64, af [T, G] f32, alpha: one f32 on the device.  Outputs
// cavge [T, G, D], dv [T, PK, D] and loss [T] (one partial sum per tile; the
// caller sums them).  P pools must divide PK; each tile runs on a cluster
// of `cluster` CTAs (1 to 8).  Returns the launch's error (0 = launched).
int w2b_scores(const float* cavg, const float* vrows, const long long* centers,
               const long long* negs, const float* af, const float* alpha,
               float* cavge, float* dv, float* loss, int T, int G, int PK,
               int D, int P, int bitlevel, int cluster, float reg,
               void* stream) {
  if (T < 0 || G < 1 || PK < 1 || D < 1 || P < 1 || PK % P || bitlevel < 0 ||
      cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned16(cavg) && aligned16(vrows) && aligned16(cavge) &&
      aligned16(dv))
    return launch<4>(cavg, vrows, centers, negs, af, alpha, cavge, dv, loss,
                     T, G, PK, D, P, bitlevel, reg, cluster, s);
  return launch<1>(cavg, vrows, centers, negs, af, alpha, cavge, dv, loss, T,
                   G, PK, D, P, bitlevel, reg, cluster, s);
}

}  // extern "C"
