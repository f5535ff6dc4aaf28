// Fused shared-negative phase of the slab and fused CBOW steps, for sm_90a.
//
// Replaces the TPU kernel `quantized_scores_pallas` (the JAX package's
// kernels/score_pallas.py, body `_kernel`).  Per tile t of G centers that
// share P*K negatives (P pools of K; center g uses pool g % P):
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
// (4.9 MB): 23 MB, ~7 us at 3.35 TB/s; the three products are 0.47 GFLOP,
// ~7 us at the 67 TFLOP/s float32 rate outside the tensor cores (bf16
// tensor cores would round the +-1/3 operands, so they stay for a later
// change).
//
// Design (simple first): one block per tile.  The tile's cavg and
// quantize(v_rows) are staged once in shared memory as float32 (row stride
// D | 1, odd, so the score step's column reads spread over the banks), and
// the score matrix g stays there too: nothing but the three outputs reaches
// device memory.  The score step gives each thread a 4 x 4 block of (g, k)
// pairs; the two output products give each thread one column d and 8 rows,
// so every shared-memory operand is read once per 8 multiply-adds.  At the
// shipped shape there are 128 tiles for 132 SMs: one 8-warp block an SM,
// whose loads nothing else hides (a 512-thread variant with 4 x 2 score
// blocks was slower).  Every
// multiply the plain version rounds before an add or subtract is written
// with __fmul_rn/__fsub_rn (no contraction into an FMA); the dot products
// are FMA chains in their own order, as cuBLAS's are.
#include "w2b_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RB = 4;  // score step: RB x RB pairs per thread
constexpr int OB = 8;  // output steps: OB rows per thread and column

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Layout {
  int Gp, PKp, Dp;
  __host__ __device__ Layout(int G, int PK, int D)
      : Gp(round_up(G, OB)), PKp(round_up(PK, OB)), Dp(D | 1) {}
  // int64 ids first (8-byte aligned), then float32 arrays; Gp and PKp are
  // multiples of 8, so every float array starts 32-byte aligned
  __host__ __device__ size_t bytes() const {
    return (size_t)(Gp + PKp) * 8 +
           ((size_t)(Gp + PKp) * Dp + (size_t)Gp * PKp + 2 * PKp + Gp) * 4;
  }
};

__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ cavg, const float* __restrict__ vrows,
             const long long* __restrict__ centers,
             const long long* __restrict__ negs, const float* __restrict__ af,
             const float* __restrict__ alpha_p, float* __restrict__ cavge_o,
             float* __restrict__ dv_o, float* __restrict__ loss_o, int G,
             int PK, int D, int P, int bitlevel, float reg) {
  extern __shared__ __align__(16) unsigned char raw[];
  const Layout L(G, PK, D);
  const int Gp = L.Gp, PKp = L.PKp, Dp = L.Dp;
  long long* cid = reinterpret_cast<long long*>(raw);  // [Gp]
  long long* nid = cid + Gp;                           // [PKp]
  float* cs = reinterpret_cast<float*>(nid + PKp);     // [Gp][Dp] cavg
  float* qs = cs + (size_t)Gp * Dp;                    // [PKp][Dp] q
  float* gs = qs + (size_t)PKp * Dp;                   // [Gp][PKp] g
  float* vis = gs + (size_t)Gp * PKp;                  // [PKp] visits
  float* vsq = vis + PKp;                              // [PKp] ||q[k]||^2
  float* afs = vsq + PKp;                              // [Gp]
  __shared__ float red[THREADS / 32];

  const int t = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float alpha = *alpha_p;
  const int K = PK / P;
  const float* cav = cavg + (size_t)t * G * D;
  const float* vr = vrows + (size_t)t * PK * D;

  // stage the tile; padding rows are zero and padding ids match nothing
  for (int i = tid; i < Gp * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    cs[r * Dp + c] = r < G ? cav[(size_t)r * D + c] : 0.0f;
  }
  for (int i = tid; i < PKp * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    qs[r * Dp + c] =
        r < PK ? w2b::quantize(vr[(size_t)r * D + c], bitlevel) : 0.0f;
  }
  for (int i = tid; i < Gp; i += THREADS) {
    cid[i] = i < G ? centers[(size_t)t * G + i] : -1;
    afs[i] = i < G ? af[(size_t)t * G + i] : 0.0f;
  }
  for (int i = tid; i < PKp; i += THREADS)
    nid[i] = i < PK ? negs[(size_t)t * PK + i] : -2;
  __syncthreads();

  // the mask of pair (g, k), as the plain version's float product
  auto mask = [&](int g, int k) -> float {
    if (g >= G || k >= PK || nid[k] == cid[g]) return 0.0f;
    if (P > 1 && g % P != k / K) return 0.0f;
    return afs[g];
  };

  if (reg != 0.0f) {
    for (int k = warp; k < PK; k += THREADS / 32) {
      float s = 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float q = qs[k * Dp + d];
        s = __fadd_rn(s, __fmul_rn(q, q));
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) vsq[k] = s;
    }
    for (int k = tid; k < PK; k += THREADS) {
      float s = 0.0f;
      for (int g = 0; g < G; ++g) s += mask(g, k);
      vis[k] = s;
    }
  }
  __syncthreads();

  // scores, gradients and the loss: RB x RB pairs per thread
  const int ngb = Gp / RB, nkb = PKp / RB;
  float loss = 0.0f;
  for (int blk = tid; blk < ngb * nkb; blk += THREADS) {
    const int g0 = (blk % ngb) * RB, k0 = (blk / ngb) * RB;
    float acc[RB][RB];
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[RB], b[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) a[i] = cs[(g0 + i) * Dp + d];
#pragma unroll
      for (int j = 0; j < RB; ++j) b[j] = qs[(k0 + j) * Dp + d];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int g = g0 + i, k = k0 + j;
        const float m = mask(g, k);
        const float f = acc[i][j];
        gs[g * PKp + k] =
            __fmul_rn(__fmul_rn(0.0f - w2b::sigmoid_lut(f), alpha), m);
        if (g < G && k < PK) {
          float l = logf(w2b::sigmoid_exact(-f));
          if (reg != 0.0f) l = __fsub_rn(l, __fmul_rn(reg, vsq[k]));
          loss += __fmul_rn(l, m);
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) loss += __shfl_xor_sync(0xffffffffu, loss, o);
  if (lane == 0) red[warp] = loss;
  __syncthreads();  // gs complete; red filled
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    loss_o[t] = s;
  }

  // cavge[g, d] = sum_k g[g, k] * q[k, d]: one column, OB rows per item
  const int ngo = Gp / OB;
  for (int it = tid; it < D * ngo; it += THREADS) {
    const int d = it % D, g0 = (it / D) * OB;
    float acc[OB];
#pragma unroll
    for (int i = 0; i < OB; ++i) acc[i] = 0.0f;
    for (int k = 0; k < PK; ++k) {
      const float q = qs[k * Dp + d];
#pragma unroll
      for (int i = 0; i < OB; ++i) acc[i] = fmaf(gs[(g0 + i) * PKp + k], q, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < OB; ++i)
      if (g0 + i < G) cavge_o[((size_t)t * G + g0 + i) * D + d] = acc[i];
  }

  // dv[k, d] = sum_g g[g, k] * cavg[g, d] (- the decay): OB rows per item
  const float two_ar = __fmul_rn(__fmul_rn(2.0f, alpha), reg);
  const int nko = PKp / OB;
  for (int it = tid; it < D * nko; it += THREADS) {
    const int d = it % D, k0 = (it / D) * OB;
    float acc[OB];
#pragma unroll
    for (int i = 0; i < OB; ++i) acc[i] = 0.0f;
    for (int g = 0; g < G; ++g) {
      const float c = cs[g * Dp + d];
      const float4 x0 = *reinterpret_cast<const float4*>(gs + g * PKp + k0);
      const float4 x1 = *reinterpret_cast<const float4*>(gs + g * PKp + k0 + 4);
      acc[0] = fmaf(x0.x, c, acc[0]);
      acc[1] = fmaf(x0.y, c, acc[1]);
      acc[2] = fmaf(x0.z, c, acc[2]);
      acc[3] = fmaf(x0.w, c, acc[3]);
      acc[4] = fmaf(x1.x, c, acc[4]);
      acc[5] = fmaf(x1.y, c, acc[5]);
      acc[6] = fmaf(x1.z, c, acc[6]);
      acc[7] = fmaf(x1.w, c, acc[7]);
    }
#pragma unroll
    for (int i = 0; i < OB; ++i) {
      const int k = k0 + i;
      if (k >= PK) continue;
      float r = acc[i];
      if (reg != 0.0f)
        r = __fsub_rn(r, __fmul_rn(__fmul_rn(two_ar, vr[(size_t)k * D + d]),
                                   vis[k]));
      dv_o[((size_t)t * PK + k) * D + d] = r;
    }
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (the wrapper checks the card's limit).
long long w2b_score_smem_bytes(int G, int PK, int D) {
  return (long long)Layout(G, PK, D).bytes();
}

// cavg [T, G, D] f32, vrows [T, PK, D] f32, centers [T, G] int64, negs
// [T, PK] int64, af [T, G] f32, alpha: one f32 on the device.  Outputs
// cavge [T, G, D], dv [T, PK, D] and loss [T] (one partial sum per tile; the
// caller sums them).  P pools must divide PK.  Returns cudaGetLastError()
// after the launch (0 = launched).
int w2b_scores(const float* cavg, const float* vrows, const long long* centers,
               const long long* negs, const float* af, const float* alpha,
               float* cavge, float* dv, float* loss, int T, int G, int PK,
               int D, int P, int bitlevel, float reg, void* stream) {
  if (T < 0 || G < 1 || PK < 1 || D < 1 || P < 1 || PK % P || bitlevel < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const size_t smem = Layout(G, PK, D).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  score_kernel<<<T, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      cavg, vrows, centers, negs, af, alpha, cavge, dv, loss, G, PK, D, P,
      bitlevel, reg);
  return (int)cudaGetLastError();
}

}  // extern "C"
