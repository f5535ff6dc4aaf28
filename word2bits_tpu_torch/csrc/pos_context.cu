// Position-weighted context of fastText's CBOW with position weights, for
// sm_90a: the forward sum and its transpose.
//
// Replaces no TPU kernel: the JAX package has no such model.  Mikolov et
// al. 2018 (arXiv 1712.09405, §2.2) weight each context position p of the
// window P = {-W..-1, 1..W} by a learned vector d_p.  For the B centers of
// a slab step, slab row s = W + b + o holds context offset o of center b,
// x [B + 2W, D] is every slab word's input vector (kernel 11's mean of its
// subword rows) and m [B, 2W] the masks (1 where the pair is in the shrunk
// window and the same sentence, else 0), positions in the order -W..-1,
// 1..W:
//
//   forward   h[b]   = (sum_p m[b,p] * (d[p] * x[W+b+o_p])) / max(n_b, 1)
//             n_b    = sum_p m[b,p]
//   backward  dx[s]  = sum_p m[b,p] * (d[p] * e[b]),  b = s - W - o_p,
//                      the terms with b in [0, B)
//             dd[p]  = sum_b m[b,p] * (e[b] * x[W+b+o_p])
//
// with e [B, D] the gradient of h (added undivided, the word2vec
// convention).  No kernel of the port computes this: the banded u-sum
// (kernel 10) takes one scalar weight a band, not a D-vector a position.
//
// Bound on the H100 (3.35 TB/s): bytes.  At B = 8192, D = 300, W = 5 (the
// ftcbow cell), float32: x read and h written (19.7 MB), then e and x read
// and dx written (29.5 MB), the masks and d: 49.9 MB, 14.9 us.  The
// operations, three sums of B * 2W * D terms of two multiplies and an add
// each, 0.22 GFLOP, take 3.3 us.
//
// Time (NVIDIA H100 80GB HBM3, 700 W; CUDA events over 20 launches after
// 3, behind a sleep kernel, tests/test_torch_pos_context_card.py) at that
// shape: forward 37.4 us, backward 83.3 us, 8.1x the bound together; 32
// registers and no spill each; the plain versions 0.636 and 1.523 ms.
//
// Design.  Forward: one warp a center, eight a CTA; a lane owns columns
// lane, lane + 32, ...; each adds its terms in the order of p with
// round-to-nearest multiplies and adds (never contracted into an fma) and
// divides once (__fdiv_rn): the same bits as the plain version
// (kernels/pos_context.py), which adds the same products in the same
// order.  The 2W rows a center reads are the next centers' rows too, so
// they come from L1 and L2.  Backward: a CTA owns a chunk of CH = 64 slab
// rows and one group of 32 columns (grid: chunks x column groups).  dx is
// gathered, each row's terms in the order of p, each output written once:
// the plain version's bits.  dd is a reduction over all B centers: warp w
// sums its 8 centers of the chunk in order, warp 0 adds the 8 warps' sums
// in order into the chunk's partial (a workspace of [chunks, 2W, D]
// float32), and the CTA of each column group that arrives last (one
// atomic counter a group, which that CTA resets) adds the chunks'
// partials in chunk order.  The order of every sum is fixed, so two
// launches give the same bits; the plain version sums dd in torch's order,
// within float32 rounding of it.  No allocation and no synchronisation
// with the host.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 8;      // backward: slab rows a warp
constexpr int CH = WARPS * ROWS_PER_WARP;   // backward: rows a chunk
constexpr int GROUP = 32;             // backward: columns a CTA
constexpr int UNROLL = 8;             // partials in flight in the final sum

__device__ __forceinline__ int offset_of(int p, int W) {
  return p < W ? p - W : p - W + 1;
}

__global__ void __launch_bounds__(THREADS)
pos_context_kernel(const float* __restrict__ x, const float* __restrict__ d,
                   const float* __restrict__ m, float* __restrict__ h,
                   int B, int D, int W) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int P = 2 * W;
  const float* mb = m + (int64_t)b * P;
  float n = 0.0f;
  for (int p = 0; p < P; ++p) n = __fadd_rn(n, mb[p]);
  const float den = fmaxf(n, 1.0f);
  for (int c = lane; c < D; c += 32) {
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) {
      const int64_t s = (int64_t)b + W + offset_of(p, W);
      const float t = __fmul_rn(__ldg(d + (int64_t)p * D + c),
                                __ldg(x + s * D + c));
      acc = __fadd_rn(acc, __fmul_rn(mb[p], t));
    }
    h[(int64_t)b * D + c] = __fdiv_rn(acc, den);
  }
}

struct GradArgs {
  const float* e;
  const float* x;
  const float* d;
  const float* m;
  float* dx;
  float* dd;
  float* partials;   // [chunks, 2W, D]
  int* counters;     // [column groups], zero between launches
  int B, D, W, chunks;
};

__global__ void __launch_bounds__(THREADS)
pos_context_grad_kernel(const GradArgs a) {
  __shared__ float s_part[WARPS][32];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int k = blockIdx.x;
  const int g = blockIdx.y;
  const int c = g * GROUP + lane;
  const bool col = c < a.D;
  const int P = 2 * a.W;
  const int N = a.B + P;
  const int r0 = k * CH + w * ROWS_PER_WARP;

  // dx: each slab row of this warp, its terms in the order of p
  if (col) {
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int s = r0 + r;
      if (s >= N) break;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) {
        const int b = s - a.W - offset_of(p, a.W);
        if (b < 0 || b >= a.B) continue;
        const float t = __fmul_rn(__ldg(a.d + (int64_t)p * a.D + c),
                                  __ldg(a.e + (int64_t)b * a.D + c));
        acc = __fadd_rn(acc, __fmul_rn(__ldg(a.m + (int64_t)b * P + p), t));
      }
      a.dx[(int64_t)s * a.D + c] = acc;
    }
  }

  // dd: this chunk's partial of each position, the warps' sums in order
  for (int p = 0; p < P; ++p) {
    const int o = offset_of(p, a.W);
    float part = 0.0f;
    if (col) {
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int b = r0 + r;
        if (b >= a.B) break;
        const float t = __fmul_rn(
            __ldg(a.e + (int64_t)b * a.D + c),
            __ldg(a.x + ((int64_t)b + a.W + o) * a.D + c));
        part = __fadd_rn(part, __fmul_rn(__ldg(a.m + (int64_t)b * P + p), t));
      }
    }
    s_part[w][lane] = part;
    __syncthreads();
    if (w == 0 && col) {
      float tot = 0.0f;
#pragma unroll
      for (int j = 0; j < WARPS; ++j) tot = __fadd_rn(tot, s_part[j][lane]);
      a.partials[((int64_t)k * P + p) * a.D + c] = tot;
    }
    __syncthreads();
  }

  // the last CTA of the column group adds the chunks' partials in order
  __threadfence();  // this CTA's partials, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(a.counters + g, 1) == a.chunks - 1;
    if (last) a.counters[g] = 0;
    s_last = last;
    __threadfence();  // the arrivals, before the others' partials are read
  }
  __syncthreads();
  if (!s_last) return;
  for (int i = threadIdx.x; i < P * GROUP; i += THREADS) {
    const int p = i / GROUP;
    const int cc = g * GROUP + i % GROUP;
    if (cc >= a.D) continue;
    const float* src = a.partials + (int64_t)p * a.D + cc;
    const int64_t stride = (int64_t)P * a.D;
    float tot = 0.0f;
    int kk = 0;
    for (; kk + UNROLL <= a.chunks; kk += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = __ldcg(src + (kk + u) * stride);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) tot = __fadd_rn(tot, v[u]);
    }
    for (; kk < a.chunks; ++kk)
      tot = __fadd_rn(tot, __ldcg(src + kk * stride));
    a.dd[(int64_t)p * a.D + cc] = tot;
  }
}

}  // namespace

extern "C" {

// The backward's chunk of slab rows and column group: out[0] = CH,
// out[1] = GROUP.  Its workspace: ceil((B + 2W) / CH) * 2W * D float32
// partials and ceil(D / GROUP) int32 counters, zero before the first call.
int w2b_pos_context_tile(int* out) {
  out[0] = CH;
  out[1] = GROUP;
  return 0;
}

// x [B + 2W, D], d [2W, D], m [B, 2W], h [B, D]: float32, contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
int w2b_pos_context(const float* x, const float* d, const float* m, float* h,
                    int B, int D, int W, void* stream) {
  if (B < 0 || D < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid((B + WARPS - 1) / WARPS);
  pos_context_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, d, m, h, B, D, W);
  return (int)cudaGetLastError();
}

// e [B, D], x [B + 2W, D], d [2W, D], m [B, 2W] in; dx [B + 2W, D] and
// dd [2W, D] out; partials and counters the workspace above.  float32 and
// int32, contiguous.  Returns cudaGetLastError() after the launch.
int w2b_pos_context_grad(const float* e, const float* x, const float* d,
                         const float* m, float* dx, float* dd,
                         float* partials, int* counters, int B, int D, int W,
                         void* stream) {
  if (B < 0 || D < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (B + 2 * W + CH - 1) / CH;
  const GradArgs a{e, x, d, m, dx, dd, partials, counters, B, D, W, chunks};
  const dim3 grid(chunks, (D + GROUP - 1) / GROUP);
  pos_context_grad_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
