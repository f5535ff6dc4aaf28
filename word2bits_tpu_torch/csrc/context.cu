// Fused context + positive forward of the banded CBOW step, for sm_90a.
//
// Replaces the TPU kernel `fused_context_pallas` (the JAX package's
// kernels/context_pallas.py, body `_kernel`).  Per banded tile t and center
// i of that tile (F = tile + 2W window rows, D columns):
//
//   q        = quantize(uwin[t])                       [F, D]
//   csum[i]  = sum_j M[t, i, j] * q[j]                 (any 0/1 M)
//   cw[i]    = sum_j M[t, i, j]
//   af[i]    = valid[i] * (cw[i] > 0)
//   cavg[i]  = csum[i] / max(cw[i], 1)
//   q_vc[i]  = quantize(vc[i])
//   f[i]     = sum_d cavg[i, d] * q_vc[i, d]
//   g[i]     = (1 - sigma_LUT(f[i])) * alpha * af[i]
//   outputs  cavg, cavge = g*q_vc, dv_center = g*cavg, af, and per CTA
//            sum_i log(sigma_exact(f[i])) * af[i]
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At D = 800,
// B = 16384 (the capacity path) it reads uwin (27.9 MB), vc (26.2 MB) and
// the f32 masks (17.8 MB) and writes three f32 [B, D] outputs (157 MB):
// 229 MB, 68 us.  The products the data needs (a banded row has at most 2W
// ones) are 2 * 2W * B * D = 0.42 GFLOP, 6 us at the f32 rate: tensor cores
// would gain nothing.  What pays is moving each byte once, coalesced.
//
// Design.  The first version (one thread per column, the whole band
// multiplied, every window row quantized again by each of a tile's 16
// center groups) took 1.78 ms at D = 800 and 0.182 ms at D = 200, B = 8192
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md section 6).  Now
// one CTA owns G = 16 centers of one tile, whole rows:
//   * Mask rows are read once, coalesced: one warp ballot per 32 entries
//     gives a bit word, kept in shared memory ([G][ceil(F/32)] words, the
//     compacted nonzero columns); cw is its popcount.  A banded row has at
//     most 2W set bits of F.
//   * Only the window rows the group's nonzeros reach are staged, quantized
//     once into shared memory as f32 ([g0, g0 + G + 2W) on the banded path:
//     (G + 2W) / G = 2x re-reading, not 16x).  A mask with ones outside the
//     band spans more rows: the span is staged in pieces of R rows.
//   * A thread owns VEC = 4 adjacent columns of CPT centers (CPT = 16 at
//     D = 800, 4 at D = 200); the ncv = ceil(D / 4) threads of a center
//     group are whole warps, so a CTA is 224 threads at D = 800 and 256 at
//     D = 200.  It takes its centers one at a time (a loop, not unrolled, so
//     no per-center state lives in registers), summing the staged rows of
//     the set bits in ascending j, four 16-byte shared loads in flight,
//     plain adds from 0.0f (fmaf(1, q, acc) of the first version; its zero
//     products were exact no-ops), so the sum does not depend on the launch
//     shape.  Across pieces the running sum waits in cavg's own output row,
//     stored and reloaded exactly.  The next center's v columns are loaded
//     while this one is summed.
//   * cavg is written as soon as it is known; each center's partial score
//     is reduced in its warps (shuffles) and over them in a fixed order;
//     cavge and dv_center follow f, with cavg and v read again (this
//     thread's own writes, and L2), four centers' loads in flight.
//   * Loads of staged rows are 16 bytes, outputs are float4 stores, where
//     the width allows (a scalar path takes any D).
// Shared memory at D = 800 is 103 KB, so two CTAs share an SM; the grid is
// Nt * ceil(tile / G) CTAs (1,024 at D = 800, 512 at D = 200).  This design
// takes 0.27 ms at D = 800 (4x its bound, 4x under its plain version) and
// 0.051 ms at D = 200 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md
// section 6).  What is left is latency, not bytes: each CTA's phases (mask
// words, staging, 16 centers one after another, the re-reads of step 5)
// wait on memory in turn, with 14 warps an SM at D = 800.
//
// Row sources.  The kernel reads its rows through a source, a template
// parameter: DenseRows takes the tile windows [Nt, F, D] and center rows
// [B, D] materialized; TableRows reads the same rows from their tables by
// the slab's ids [B + 2W] (window row p of tile t is u[ids[t * tile + p]],
// center b's v row v[ids[W + b]]), so the fused step gathers and copies
// nothing for the kernel: at D = 800, B = 16384 that is a [16,400, 1,600]
// bf16 gather (105 MB of traffic), the tile windows (27.9 MB written) and
// the center rows (26.2 MB written) that only this kernel read.  A CTA
// turns its rows into pointers once, in shared memory: the ids of its
// window rows [g0, g0 + R) and of its G centers are loaded while the mask
// words are read, so staging and the center loads never wait on an id.
// The values read, and so every output, are the dense source's bit for
// bit.
#include <stdint.h>

#include "w2b_common.cuh"

namespace {

constexpr int G = 16;              // centers per CTA
constexpr int VEC = 4;             // adjacent columns per thread
constexpr int MAX_THREADS = 256;
constexpr int STAGE_BYTES = 104 * 1024;  // staged rows: two CTAs an SM at D = 800
constexpr int SMEM_LIMIT = 227 * 1024;

// 16 bytes of T (4 float32 or 8 bfloat16 values), widened to float32
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw,
                                        float (&x)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(raw.x); x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z); x[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
  }
}

// columns c0..c0+3 of row p, widened to float32 and quantized (zeros past D)
template <typename T>
__device__ __forceinline__ void load_q4(const T* p, int c0, int D, bool vec,
                                        int bitlevel, float (&x)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + c0));
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = c0 + e < D ? p[c0 + e] : 0.0f;
    }
  } else {
    if (vec) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p + c0));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = __bfloat162float(h[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        x[e] = c0 + e < D ? __bfloat162float(p[c0 + e]) : 0.0f;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) x[e] = w2b::quantize(x[e], bitlevel);
}

__device__ __forceinline__ void load4(const float* p, int c0, int D, bool vec,
                                      float (&x)[VEC]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(p + c0);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = c0 + e < D ? p[c0 + e] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* p, int c0, int D, bool vec,
                                       const float (&x)[VEC]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + c0) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (c0 + e < D) p[c0 + e] = x[e];
  }
}

// Row sources: u_key(t, p) and v_key(b) name window row p of tile t and
// center b's v row (for TableRows an id, loaded here); u_at and v_at turn a
// key into a pointer to the row's D values.
//
// DenseRows: the tile windows [Nt, F, D] and the center rows [B, D].
template <typename T>
struct DenseRows {
  const T* uwin;
  const T* vc;
  int F, D;
  __device__ __forceinline__ long long u_key(int t, int p) const {
    return (long long)t * F + p;
  }
  __device__ __forceinline__ long long v_key(size_t b) const {
    return (long long)b;
  }
  __device__ __forceinline__ const T* u_at(long long k) const {
    return uwin + k * D;
  }
  __device__ __forceinline__ const T* v_at(long long k) const {
    return vc + k * D;
  }
};

// TableRows: the rows in their tables u and v ([V, D] with row strides us
// and vs: the halves of one fused table, v = u + D and both strides 2D, or
// two tables), read by the slab's ids [B + 2W] (int32 or int64 I),
// clamped into [0, V).
template <typename T, typename I>
struct TableRows {
  const T* u;
  const T* v;
  const I* ids;
  long long us, vs;
  int tile, W, V;
  __device__ __forceinline__ long long u_key(int t, int p) const {
    return __ldg(ids + (size_t)t * tile + p);
  }
  __device__ __forceinline__ long long v_key(size_t b) const {
    return __ldg(ids + W + b);
  }
  __device__ __forceinline__ long long clamp(long long k) const {
    return k < 0 ? 0 : (k >= V ? V - 1 : k);
  }
  __device__ __forceinline__ const T* u_at(long long k) const {
    return u + clamp(k) * us;
  }
  __device__ __forceinline__ const T* v_at(long long k) const {
    return v + clamp(k) * vs;
  }
};

// Stage n rows, rows[0 .. n), quantized, into qs ([n][D] f32).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* const* rows, float* qs,
                                           int n, int D, bool vec,
                                           int bitlevel) {
  const int nt = blockDim.x;
  if (vec) {  // D * sizeof(T) % 16 == 0 and every row 16-byte aligned
    constexpr int E = 16 / sizeof(T);
    constexpr int U = 4;  // 16-byte loads in flight per thread
    const int per = D / E;  // 16-byte vectors a row
    const int nv = n * per;
    for (int v0 = threadIdx.x; v0 < nv; v0 += U * nt) {
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * nt;
        if (v < nv) {
          const int r = v / per;
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              rows[r] + (size_t)(v - r * per) * E));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * nt;
        if (v < nv) {
          float x[E];
          widen16<T>(raw[u], x);
#pragma unroll
          for (int e = 0; e < E; e += 4)
            *reinterpret_cast<float4*>(qs + (size_t)v * E + e) = make_float4(
                w2b::quantize(x[e], bitlevel),
                w2b::quantize(x[e + 1], bitlevel),
                w2b::quantize(x[e + 2], bitlevel),
                w2b::quantize(x[e + 3], bitlevel));
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += nt) {
      const int r = e / D;
      qs[e] = w2b::quantize(w2b::to_f32(rows[r][e - r * D]), bitlevel);
    }
  }
}

// acc += the staged rows of the set bits of one center's mask words that
// fall in the piece [p0, p1), in ascending j; four loads in flight
__device__ __forceinline__ void sum_piece(const unsigned* rb, const float* qs,
                                          int p0, int p1, int D, int c0,
                                          bool vec, float (&acc)[VEC]) {
  for (int k = p0 >> 5; k <= (p1 - 1) >> 5; ++k) {
    unsigned m = rb[k];
    const int base = k << 5;
    if (base < p0) m &= 0xffffffffu << (p0 - base);
    if (p1 - base < 32) m &= (1u << (p1 - base)) - 1u;
    while (m) {
      int j[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        j[u] = m ? base + __ffs(m) - 1 - p0 : -1;
        m &= m - 1u;
      }
      float x[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j[u] < 0) continue;
        const float* q = qs + (size_t)j[u] * D + c0;
        if (vec) {
          const float4 v = *reinterpret_cast<const float4*>(q);
          x[u][0] = v.x; x[u][1] = v.y; x[u][2] = v.z; x[u][3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) x[u][e] = c0 + e < D ? q[e] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j[u] < 0) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += x[u][e];
      }
    }
  }
}

// Launch shape, fixed per call by the host.
struct Shape {
  int F, D, tile, bitlevel;
  int R;        // window rows staged per piece
  int NW;       // mask words per row, ceil(F / 32)
  int ncv;      // column vectors per row, ceil(D / VEC)
  int ncv_pad;  // ncv rounded up to whole warps
  int cpt;      // centers per thread: G / (threads / ncv_pad)
  int region;   // floats of the staging region, R * D rounded up to 4
  int stage_vec, col_vec;  // 16-byte staging loads; float4 columns
};

template <typename T, typename Src>
__global__ void __launch_bounds__(MAX_THREADS, 2)
context_kernel(const Src src, const float* __restrict__ M,
               const float* __restrict__ valid,
               const float* __restrict__ alpha_p, float* __restrict__ cavg_o,
               float* __restrict__ cavge_o, float* __restrict__ dvc_o,
               float* __restrict__ af_o, float* __restrict__ loss_o,
               const Shape s) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                               // [R][D]
  unsigned* bits = reinterpret_cast<unsigned*>(smem + s.region);  // [G][NW]
  // the rows of window positions [ubase, ubase + R) and of the G centers
  const T** urow = reinterpret_cast<const T**>(bits + G * s.NW);  // [R]
  const T** vrow = urow + s.R;                                    // [G]
  __shared__ int cw_s[G];
  __shared__ float red[G][MAX_THREADS / 32];  // per-warp partial scores
  __shared__ float f_s[G];
  __shared__ int span_s[2];

  const int F = s.F, D = s.D, NW = s.NW;
  const int t = blockIdx.y;
  const int g0 = blockIdx.x * G;
  const int ng = min(G, s.tile - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* Mt = M + ((size_t)t * s.tile + g0) * F;
  const size_t b0 = (size_t)t * s.tile + g0;

  // 1. the keys of window rows [g0, g0 + R) and of the centers, loaded
  // here and made pointers after the mask words; mask bits: bits[i][k] bit
  // l = (M[i, 32k + l] != 0), one warp ballot per word, eight words in
  // flight per warp
  const int nrows = s.R + G, nthreads = blockDim.x;
  // k < R: window row g0 + k; else center k - R
  auto key_of = [&](int k) -> long long {
    if (k < s.R) return g0 + k < F ? src.u_key(t, g0 + k) : 0;
    return k - s.R < ng ? src.v_key(b0 + (k - s.R)) : 0;
  };
  long long key = tid < nrows ? key_of(tid) : 0;
  constexpr int UM = 8;
  const int npairs = G * NW;
  for (int p0 = warp; p0 < npairs; p0 += UM * nwarps) {
    float m[UM];
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      const int p = p0 + u * nwarps;
      const int i = p / NW, j = (p - i * NW) * 32 + lane;
      m[u] = (p < npairs && i < ng && j < F) ? __ldg(Mt + (size_t)i * F + j)
                                             : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UM; ++u) {
      const int p = p0 + u * nwarps;
      const unsigned b = __ballot_sync(0xffffffffu, m[u] != 0.0f);
      if (lane == 0 && p < npairs) bits[p] = b;
    }
  }
  for (int k = tid; k < nrows; k += nthreads) {
    if (k != tid) key = key_of(k);  // more rows than threads
    if (k < s.R)
      urow[k] = g0 + k < F ? src.u_at(key) : nullptr;
    else
      vrow[k - s.R] = k - s.R < ng ? src.v_at(key) : nullptr;
  }
  __syncthreads();

  // 2. cw per row and the group's column span [lo, hi)
  if (warp == 0) {
    int cnt = 0, lo = F, hi = 0;
    if (lane < G) {
      for (int k = 0; k < NW; ++k) {
        const unsigned w = bits[lane * NW + k];
        if (w) {
          cnt += __popc(w);
          lo = min(lo, k * 32 + __ffs(w) - 1);
          hi = k * 32 + 32 - __clz(w);
        }
      }
      cw_s[lane] = cnt;
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      span_s[0] = lo;
      span_s[1] = hi;
    }
  }
  __syncthreads();

  // 3. per center: csum over the set bits, the span staged in pieces (one
  // on the banded path); on the last piece cavg, written, and the center's
  // partial score.  The thread's center group (cg) is whole warps, so the
  // loop over its centers is warp-uniform.
  const int cg = tid / s.ncv_pad, cv = tid - cg * s.ncv_pad;
  const bool col = cv < s.ncv;
  const int c0 = cv * VEC;
  const bool vec = s.col_vec;
  const int i0 = cg * s.cpt;
  const int nmine = max(0, min(s.cpt, ng - i0));  // this group's centers
  const int lo = span_s[0], hi = span_s[1];
  const int npieces = hi > lo ? (hi - lo + s.R - 1) / s.R : 1;
  int ubase = g0;  // urow holds window rows [ubase, ubase + R)
  for (int pc = 0; pc < npieces; ++pc) {
    const int p0 = lo + pc * s.R, p1 = min(hi, p0 + s.R);
    if (pc) __syncthreads();  // the previous piece is consumed
    if (p1 > p0 && (p0 < ubase || p1 > ubase + s.R)) {
      // a span outside the banded rows: this piece's row pointers
      ubase = p0;
      for (int k = tid; k < p1 - p0; k += nthreads)
        urow[k] = src.u_at(src.u_key(t, p0 + k));
      __syncthreads();
    }
    if (p1 > p0)
      stage_rows<T>(urow + (p0 - ubase), qs, p1 - p0, D, s.stage_vec,
                    s.bitlevel);
    __syncthreads();
    const bool last = pc == npieces - 1;
    float qv[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (last && col && nmine > 0)
      load_q4<T>(vrow[i0], c0, D, vec, s.bitlevel, qv);
#pragma unroll 1
    for (int ii = 0; ii < nmine; ++ii) {
      const size_t b = b0 + i0 + ii;
      float qn[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};  // the next center's q_vc
      if (last && col && ii + 1 < nmine)
        load_q4<T>(vrow[i0 + ii + 1], c0, D, vec, s.bitlevel, qn);
      float acc[VEC] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (col) {
        if (pc > 0) load4(cavg_o + b * D, c0, D, vec, acc);
        if (p1 > p0)
          sum_piece(bits + (i0 + ii) * NW, qs, p0, p1, D, c0, vec, acc);
      }
      if (!last) {
        if (col) store4(cavg_o + b * D, c0, D, vec, acc);
        continue;
      }
      float part = 0.0f;
      if (col) {
        const float den = fmaxf((float)cw_s[i0 + ii], 1.0f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], den);
        store4(cavg_o + b * D, c0, D, vec, acc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) part += acc[e] * qv[e];
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[i0 + ii][cv >> 5] = part;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[e] = qn[e];
    }
  }
  __syncthreads();
  // 4. f per center: its warps' partials in a fixed order
  if (tid < ng) {
    float sum = 0.0f;
    for (int w = 0; w < s.ncv_pad / 32; ++w) sum += red[tid][w];
    f_s[tid] = sum;
  }
  __syncthreads();

  // 5. the positive gradients, four centers at a time: their cavg (this
  // thread's own writes) and v columns read again, then two stores each;
  // af and the CTA's loss
  const float alpha = *alpha_p;
  if (col) {
#pragma unroll 1
    for (int ii0 = 0; ii0 < nmine; ii0 += 4) {
      float cav[4][VEC], q4[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ii0 + u >= nmine) continue;
        const size_t b = b0 + i0 + ii0 + u;
        load4(cavg_o + b * D, c0, D, vec, cav[u]);
        load_q4<T>(vrow[i0 + ii0 + u], c0, D, vec, s.bitlevel, q4[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (ii0 + u >= nmine) continue;
        const int i = i0 + ii0 + u;
        const size_t b = b0 + i;
        const float af = cw_s[i] > 0 ? valid[b] : 0.0f;
        const float g = (1.0f - w2b::sigmoid_lut(f_s[i])) * alpha * af;
        float o1[VEC], o2[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          o1[e] = g * q4[u][e];
          o2[e] = g * cav[u][e];
        }
        store4(cavge_o + b * D, c0, D, vec, o1);
        store4(dvc_o + b * D, c0, D, vec, o2);
      }
    }
  }
  if (tid == 0) {
    float loss = 0.0f;
    for (int i = 0; i < ng; ++i) {
      const float af = cw_s[i] > 0 ? valid[b0 + i] : 0.0f;
      af_o[b0 + i] = af;
      loss += logf(w2b::sigmoid_exact(f_s[i])) * af;
    }
    loss_o[(size_t)t * gridDim.x + blockIdx.x] = loss;
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The launch shape of one call: Shape, threads and dynamic shared memory
// bytes; false where the staged rows and mask words exceed shared memory.
inline bool plan_launch(int F, int D, int tile, int bitlevel, int elem,
                        bool stage_aligned, bool col_aligned, Shape& s,
                        int& threads, size_t& smem) {
  s.F = F;
  s.D = D;
  s.tile = tile;
  s.bitlevel = bitlevel;
  s.NW = (F + 31) / 32;
  s.ncv = (D + VEC - 1) / VEC;
  s.ncv_pad = (s.ncv + 31) / 32 * 32;
  // the banded span of G centers is G + 2W = G + F - tile rows; a piece
  // holds that many where the staging budget allows
  const int budget = max(1, STAGE_BYTES / (D * (int)sizeof(float)));
  s.R = min(min(F, G + (F - tile)), budget);
  s.region = (s.R * D + 3) / 4 * 4;
  s.stage_vec = (D * elem) % 16 == 0 && stage_aligned;
  s.col_vec = D % VEC == 0 && col_aligned;
  // the staged rows, the mask words and R + G row pointers
  smem = ((size_t)s.region + (size_t)G * s.NW) * sizeof(float) +
         (size_t)(s.R + G) * sizeof(void*);
  // CG center groups of ncv_pad threads, at most MAX_THREADS: 224 threads
  // at D = 800 (CG = 1), 256 at D = 200 (CG = 4)
  int cg = G;
  while (cg > 1 && cg * s.ncv_pad > MAX_THREADS) cg >>= 1;
  s.cpt = G / cg;
  threads = cg * s.ncv_pad;
  return smem <= SMEM_LIMIT - 1024;
}

template <typename T, typename Src>
int launch(const Src& src, bool stage_aligned, bool col_aligned,
           const float* M, const float* valid, const float* alpha,
           float* cavg, float* cavge, float* dvc, float* af, float* loss,
           int Nt, int F, int D, int tile, int bitlevel, cudaStream_t stream) {
  Shape s;
  int threads;
  size_t smem;
  if (!plan_launch(F, D, tile, bitlevel, sizeof(T), stage_aligned,
                   col_aligned && aligned(cavg, 16) && aligned(cavge, 16) &&
                       aligned(dvc, 16),
                   s, threads, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      context_kernel<T, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tile + G - 1) / G, Nt);
  context_kernel<T, Src><<<grid, threads, smem, stream>>>(
      src, M, valid, alpha, cavg, cavge, dvc, af, loss, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dense(const void* uwin_v, const void* vc_v, const float* M,
                 const float* valid, const float* alpha, float* cavg,
                 float* cavge, float* dvc, float* af, float* loss, int Nt,
                 int F, int D, int tile, int bitlevel, cudaStream_t stream) {
  const DenseRows<T> src{static_cast<const T*>(uwin_v),
                         static_cast<const T*>(vc_v), F, D};
  return launch<T>(src, aligned(src.uwin, 16),
                   aligned(src.vc, VEC * sizeof(T)), M, valid, alpha, cavg,
                   cavge, dvc, af, loss, Nt, F, D, tile, bitlevel, stream);
}

template <typename T, typename I>
int launch_table(const void* u_v, const void* v_v, long long us,
                 long long vs, const void* ids, int V, const float* M,
                 const float* valid, const float* alpha, float* cavg,
                 float* cavge, float* dvc, float* af, float* loss, int Nt,
                 int F, int D, int tile, int bitlevel, cudaStream_t stream) {
  const TableRows<T, I> src{static_cast<const T*>(u_v),
                            static_cast<const T*>(v_v),
                            static_cast<const I*>(ids), us, vs, tile,
                            (F - tile) / 2, V};
  return launch<T>(
      src, aligned(src.u, 16) && (us * (long long)sizeof(T)) % 16 == 0,
      aligned(src.v, VEC * sizeof(T)) && vs % VEC == 0, M, valid, alpha,
      cavg, cavge, dvc, af, loss, Nt, F, D, tile, bitlevel, stream);
}

// launch_table with the id type that id_bytes names (4: int32, 8: int64)
template <typename T>
int launch_ids(int id_bytes, const void* u, const void* v, long long us,
               long long vs, const void* ids, int V, const float* M,
               const float* valid, const float* alpha, float* cavg,
               float* cavge, float* dvc, float* af, float* loss, int Nt, int F,
               int D, int tile, int bitlevel, cudaStream_t stream) {
  if (id_bytes == 8)
    return launch_table<T, long long>(u, v, us, vs, ids, V, M, valid, alpha,
                                      cavg, cavge, dvc, af, loss, Nt, F, D,
                                      tile, bitlevel, stream);
  if (id_bytes == 4)
    return launch_table<T, int>(u, v, us, vs, ids, V, M, valid, alpha, cavg,
                                cavge, dvc, af, loss, Nt, F, D, tile,
                                bitlevel, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (uwin and vc).  loss has
// Nt * ceil(tile / 16) entries, one per CTA; the caller sums them.
// Returns cudaGetLastError() after the launch (0 = launched).
int w2b_context_forward(const void* uwin, const void* vc, const float* M,
                        const float* valid, const float* alpha, float* cavg,
                        float* cavge, float* dvc, float* af, float* loss,
                        int Nt, int F, int D, int tile, int bitlevel,
                        int dtype, void* stream) {
  if (D < 1 || D > 1024 || tile < 1 || F < tile || Nt < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(uwin, vc, M, valid, alpha, cavg,
                                       cavge, dvc, af, loss, Nt, F, D, tile,
                                       bitlevel, s);
  if (dtype == 0)
    return launch_dense<float>(uwin, vc, M, valid, alpha, cavg, cavge, dvc,
                               af, loss, Nt, F, D, tile, bitlevel, s);
  return (int)cudaErrorInvalidValue;
}

// The same outputs from the rows in their tables: u and v [V, D] (dtype as
// above) with row strides us and vs in elements, read by the slab's ids
// [Nt * tile + F - tile] (id_bytes 4: int32, 8: int64; clamped into
// [0, V)).
int w2b_context_forward_rows(const void* u, const void* v, long long us,
                             long long vs, const void* ids, int id_bytes,
                             int V, const float* M, const float* valid,
                             const float* alpha, float* cavg, float* cavge,
                             float* dvc, float* af, float* loss, int Nt,
                             int F, int D, int tile, int bitlevel, int dtype,
                             void* stream) {
  if (D < 1 || D > 1024 || tile < 1 || F < tile || (F - tile) % 2 ||
      Nt < 1 || V < 1 || us < D || vs < D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_ids<__nv_bfloat16>(id_bytes, u, v, us, vs, ids, V, M,
                                     valid, alpha, cavg, cavge, dvc, af, loss,
                                     Nt, F, D, tile, bitlevel, s);
  if (dtype == 0)
    return launch_ids<float>(id_bytes, u, v, us, vs, ids, V, M, valid,
                             alpha, cavg, cavge, dvc, af, loss, Nt, F, D,
                             tile, bitlevel, s);
  return (int)cudaErrorInvalidValue;
}

int w2b_context_loss_slots(int Nt, int tile) {
  return Nt * ((tile + G - 1) / G);
}

// The launch shape of an aligned call, for reports: out = {threads,
// dynamic shared memory bytes, window rows staged per piece, centers per
// thread}.  Returns 0, or -1 where the call would be refused.
int w2b_context_launch_shape(int F, int D, int tile, int dtype, int* out) {
  if (D < 1 || D > 1024 || tile < 1 || F < tile) return -1;
  Shape s;
  int threads;
  size_t smem;
  const bool ok = plan_launch(F, D, tile, 1, dtype == 1 ? 2 : 4, true, true,
                              s, threads, smem);
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = s.R;
  out[3] = s.cpt;
  return ok ? 0 : -1;
}

}  // extern "C"
