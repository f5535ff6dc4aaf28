// Banded u-sum of the CBOW step, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves this sum to XLA
// (ops/windowed.banded_usum, a dense batched product of each tile's
// transposed [tile, F] mask with its centers' rows, then an overlap-add of
// the 2W-row halos).  On the card that product ran as one float32 cuBLAS
// GEMM of 2 * B * F * D operations (7.13 GFLOP a step at B = 16384,
// D = 800, F = 272; TF32 stays off), with a mask product, a clone and a
// concatenation around it, where a center row of the mask has at most 2W
// ones, all in the band [i, i + 2W] of its F columns.
//
// What it computes.  The centers whose window holds slab row p in
// [0, B + 2W) are b in [p - 2W, p] ∩ [0, B); center b = t * tile + i meets
// row p at column j = p - t * tile = i + (p - b) of its tile's mask, so the
// overlap-add is implicit:
//
//   du[p]  = sum_b  M[t, i, j] * af[b] * cavge[b]      (float32)
//   cnt[p] = sum_b  M[t, i, j] * af[b]                  (when asked)
//
// Only the band j in [i, i + 2W] of each mask row is read: the caller's
// masks (ops/windowed.build_banded_masks) set nothing outside it.
//
// Bound on the H100 (3.35 TB/s): bytes.  cavge read once and du written
// once, [B, D] and [B + 2W, D] float32, with the band and af: 106 MB,
// 31.7 us at B = 16384, D = 800, W = 8; 13.7 MB, 4.1 us at B = 8192,
// D = 200.  The operations, 2 * B * 2W * D = 0.42 GFLOP, take 6 us.
//
// Design.  A CTA of 8 warps owns R consecutive slab rows and one group of
// 128 columns (a lane's 4 adjacent columns, read and written as float4
// where the width and alignment allow).  It stages its R + 2W centers'
// columns in shared memory (cp.async, 16 bytes, coalesced: each cavge byte
// is read (R + 2W) / R times, the halo mostly from L2), and each center's
// band of 2W + 1 weights M * af, read along the band (four loads in
// flight) and stored by row: row r's terms in ascending b, shifted by one
// in odd rows, so that the two rows of a pair hold one center's weights
// at one index.  A warp takes a pair of rows at a time; its lanes share
// the rows, so the test of a zero weight is warp-uniform: a center whose
// two weights are 0 is not loaded, the others are loaded once for both
// rows, four loads in flight, and a term of weight 0 is skipped (it adds
// nothing to a finite sum).  Each lane sums its columns' terms in
// ascending b with fmaf, in float32, and writes each output once; a row
// with no center gets 0.  The order of the terms does not depend on R or
// the column group, so every launch shape gives the same bits; no atomics,
// no allocation and no synchronisation with the host, so a CUDA graph
// captures it.  R is 32, halved (to 16, 8) while the grid holds fewer than
// 512 CTAs, four a SM, or the staging exceeds shared memory.
//
// Times (NVIDIA H100 80GB HBM3, 700 W; CUDA events over 50 launches behind
// a sleep kernel): this design 53.5 us at B = 16384, D = 800 (1.7x its
// bound) and 9.3 us at B = 8192, D = 200; the first, one row a warp and its
// terms loaded one at a time, 59.2-91.9 us and 10.7-16.0 us over R = 16 to
// 128 (65.6 and 11.2 at R = 32); this design at R = 64 61.4 and 9.3 us, at
// R = 16 59.9 and 10.9 us.  The GEMM it replaces took 216-221 us at
// D = 800 and 37-38 us at D = 200.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int LANE_COLS = 4;          // adjacent columns a lane owns
constexpr int GROUP_COLS = 32 * LANE_COLS;
constexpr int TARGET_CTAS = 512;
constexpr int SMEM_LIMIT = 227 * 1024;

// Launch shape, fixed per call by the host.
struct Shape {
  int B, D, W, tile;
  int F;   // mask columns, tile + 2W
  int N;   // slab rows, B + 2W
  int R;   // slab rows a CTA
  int KP;  // weights a row: 2W + 1 terms and a row pair's shift of one,
           // rounded up to 4
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS)
band_usum_kernel(const float* __restrict__ M, const float* __restrict__ af,
                 const float* __restrict__ cavge, float* __restrict__ du,
                 float* __restrict__ cnt, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int R = s.R, KP = s.KP, W2 = 2 * s.W;
  const int NC = R + W2;                 // centers staged
  float* cav = smem;                     // [NC][GROUP_COLS]
  float* wr = smem + NC * GROUP_COLS;    // [R][KP]
  const int p0 = blockIdx.x * R;
  const int b0 = p0 - W2;                // the center of staged row 0
  const int col0 = blockIdx.y * GROUP_COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the staged centers' columns (rows of centers outside [0, B) stay
  // unwritten: their weights are 0, so no term reads them)
  if constexpr (kVec) {
    for (int e = tid; e < NC * 32; e += THREADS) {
      const int c = e >> 5, l = e & 31;
      const int b = b0 + c, col = col0 + l * LANE_COLS;
      if (b >= 0 && b < s.B && col < s.D)
        cp_async16(cav + c * GROUP_COLS + l * LANE_COLS,
                   cavge + (size_t)b * s.D + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int e = tid; e < NC * GROUP_COLS; e += THREADS) {
      const int c = e / GROUP_COLS, l = e - c * GROUP_COLS;
      const int b = b0 + c;
      if (b >= 0 && b < s.B && col0 + l < s.D)
        cav[e] = __ldg(cavge + (size_t)b * s.D + col0 + l);
    }
  }

  // 2. weights.  Row r's term m is staged center r + m (center b = p - 2W
  // + m, so its terms run in ascending b), kept at index m + (r & 1): the
  // two rows of a pair then hold one center's weights at one index.  Each
  // staged center c meets row r = c + k - 2W at band offset k = p - b,
  // mask column (b mod tile) + k; its band is read in a row, four loads in
  // flight.  The indices outside a row's terms hold 0.
  for (int e = tid; e < R * KP; e += THREADS) {
    const int r = e / KP, i = e - r * KP, lo = r & 1;
    if (i < lo || i > W2 + lo) wr[e] = 0.0f;
  }
  const int items = NC * (W2 + 1);
  for (int e0 = tid; e0 < items; e0 += 4 * THREADS) {
    float mv[4], av[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      const int c = e / (W2 + 1), k = e - c * (W2 + 1);
      const int r = c + k - W2, b = b0 + c;
      at[u] = (e < items && r >= 0 && r < R) ? r * KP + W2 - k + (r & 1)
                                             : -1;
      mv[u] = 0.0f;
      av[u] = 0.0f;
      if (at[u] >= 0 && b >= 0 && b < s.B) {
        mv[u] = __ldg(M + (size_t)b * s.F + b % s.tile + k);
        av[u] = __ldg(af + b);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) wr[at[u]] = mv[u] * av[u];
  }
  if constexpr (kVec) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 3. a warp takes two rows at a time, r and r + 1: index i holds both
  // rows' weights of staged center r + i, whose columns are loaded once
  // for the two where either weight is nonzero, four loads in flight
  const int col = col0 + lane * LANE_COLS;
  for (int r = 2 * warp; r < R; r += 2 * (THREADS / 32)) {
    const int p = p0 + r;
    if (p >= s.N) break;
    float acc[2][LANE_COLS] = {};
    float n[2] = {0.0f, 0.0f};
    const float* wa = wr + r * KP;
    const float* xrow = cav + r * GROUP_COLS + lane * LANE_COLS;
    for (int m0 = 0; m0 < KP; m0 += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(wa + m0);
      const float4 b4 = *reinterpret_cast<const float4*>(wa + KP + m0);
      const float w[2][4] = {{a4.x, a4.y, a4.z, a4.w},
                             {b4.x, b4.y, b4.z, b4.w}};
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (w[0][u] != 0.0f || w[1][u] != 0.0f)
          x[u] = *reinterpret_cast<const float4*>(xrow +
                                                  (m0 + u) * GROUP_COLS);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (w[h][u] != 0.0f) {
            acc[h][0] = fmaf(w[h][u], x[u].x, acc[h][0]);
            acc[h][1] = fmaf(w[h][u], x[u].y, acc[h][1]);
            acc[h][2] = fmaf(w[h][u], x[u].z, acc[h][2]);
            acc[h][3] = fmaf(w[h][u], x[u].w, acc[h][3]);
          }
          n[h] += w[h][u];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p + h >= s.N) break;
      float* out = du + (size_t)(p + h) * s.D + col;
      if constexpr (kVec) {
        if (col < s.D)
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      } else {
#pragma unroll
        for (int e = 0; e < LANE_COLS; ++e)
          if (col + e < s.D) out[e] = acc[h][e];
      }
      if (cnt != nullptr && blockIdx.y == 0 && lane == 0) cnt[p + h] = n[h];
    }
  }
}

inline size_t smem_bytes(int R, int W, int KP) {
  return ((size_t)(R + 2 * W) * GROUP_COLS + (size_t)R * KP) * sizeof(float);
}

// The launch shape of one call: Shape, grid and dynamic shared memory
// bytes; false where even R = 8 exceeds shared memory.
inline bool plan_launch(int B, int D, int W, int tile, Shape& s, dim3& grid,
                        size_t& smem) {
  s.B = B;
  s.D = D;
  s.W = W;
  s.tile = tile;
  s.F = tile + 2 * W;
  s.N = B + 2 * W;
  s.KP = (2 * W + 2 + 3) / 4 * 4;
  const int groups = (D + GROUP_COLS - 1) / GROUP_COLS;
  int R = 32;
  while (R > 8 && ((s.N + R - 1) / R * groups < TARGET_CTAS ||
                   smem_bytes(R, W, s.KP) > SMEM_LIMIT - 1024))
    R >>= 1;
  s.R = R;
  smem = smem_bytes(R, W, s.KP);
  grid = dim3((s.N + R - 1) / R, groups);
  return smem <= SMEM_LIMIT - 1024;
}

inline bool valid_shape(int B, int D, int W, int tile) {
  return B >= 1 && D >= 1 && W >= 0 && tile >= 1 && tile >= 2 * W &&
         B % tile == 0;
}

template <bool kVec>
int launch(const float* M, const float* af, const float* cavge, float* du,
           float* cnt, const Shape& s, dim3 grid, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_usum_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  band_usum_kernel<kVec><<<grid, THREADS, smem, stream>>>(M, af, cavge, du,
                                                          cnt, s);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// M [B/tile, tile, tile + 2W], af [B], cavge [B, D], du [B + 2W, D]: float32,
// contiguous.  cnt [B + 2W] float32, or null where not wanted.  Returns
// cudaGetLastError() after the launch (0 = launched).
int w2b_band_usum(const float* M, const float* af, const float* cavge,
                  float* du, float* cnt, int B, int D, int W, int tile,
                  void* stream) {
  if (!valid_shape(B, D, W, tile)) return (int)cudaErrorInvalidValue;
  Shape s;
  dim3 grid;
  size_t smem;
  if (!plan_launch(B, D, W, tile, s, grid, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % LANE_COLS == 0 && aligned16(cavge) && aligned16(du))
    return launch<true>(M, af, cavge, du, cnt, s, grid, smem, st);
  return launch<false>(M, af, cavge, du, cnt, s, grid, smem, st);
}

// The launch shape, for reports: out = {slab rows a CTA, CTAs, threads,
// dynamic shared memory bytes}.  Returns 0, or -1 where the call would be
// refused.
int w2b_band_usum_launch_shape(int B, int D, int W, int tile, int* out) {
  if (!valid_shape(B, D, W, tile)) return -1;
  Shape s;
  dim3 grid;
  size_t smem;
  const bool ok = plan_launch(B, D, W, tile, s, grid, smem);
  out[0] = s.R;
  out[1] = (int)(grid.x * grid.y);
  out[2] = THREADS;
  out[3] = (int)smem;
  return ok ? 0 : -1;
}

}  // extern "C"
