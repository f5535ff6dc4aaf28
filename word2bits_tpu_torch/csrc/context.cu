// Fused context + positive forward of the banded CBOW step, for sm_90a.
//
// Replaces the TPU kernel `fused_context_pallas` (the JAX package's
// kernels/context_pallas.py, body `_kernel`).  Per banded tile t and center
// i of that tile (F = tile + 2W window rows, D columns):
//
//   q        = quantize(uwin[t])                       [F, D]
//   csum[i]  = sum_j M[t, i, j] * q[j]                 (full M @ q, any 0/1 M)
//   cw[i]    = sum_j M[t, i, j]
//   af[i]    = valid[i] * (cw[i] > 0)
//   cavg[i]  = csum[i] / max(cw[i], 1)
//   q_vc[i]  = quantize(vc[i])
//   f[i]     = sum_d cavg[i, d] * q_vc[i, d]
//   g[i]     = (1 - sigma_LUT(f[i])) * alpha * af[i]
//   outputs  cavg, cavge = g*q_vc, dv_center = g*cavg, af, and per block
//            sum_i log(sigma_exact(f[i])) * af[i]
//
// Bound on the H100 (3.35 TB/s): the bytes it must move.  At the main path
// (B=8192, W=8, tile 256, D=200, bf16 rows) it reads uwin (3.5 MB), vc
// (3.3 MB) and the f32 masks (8.9 MB) and writes three f32 [B, D] outputs
// (19.7 MB): ~35 MB, ~11 us.  The products the data needs (the band of M
// has ~2W ones per row) are ~30 MFLOP, far below the f32 peak.
//
// Design (simple first): one block per (tile, group of GROUP centers),
// one thread per column d.  The block walks the F window rows in chunks of
// JC: it quantizes the chunk into shared memory once and stages the
// group's mask slice, and each thread accumulates GROUP f32 sums in
// registers.  The score f is a block reduction (warp shuffles, then one
// pass over the warps).  The quantized window and the f32 intermediates
// never reach device memory; re-reading a tile's window once per group
// hits L2.  The band's zeros are multiplied like any other entry.
#include "w2b_common.cuh"

namespace {

constexpr int GROUP = 16;  // centers per block
constexpr int JC = 16;     // window rows staged per step
constexpr int MAX_WARPS = 32;

template <typename T>
__global__ void __launch_bounds__(1024)
context_kernel(const T* __restrict__ uwin, const T* __restrict__ vc,
               const float* __restrict__ M, const float* __restrict__ valid,
               const float* __restrict__ alpha_p, float* __restrict__ cavg_o,
               float* __restrict__ cavge_o, float* __restrict__ dvc_o,
               float* __restrict__ af_o, float* __restrict__ loss_o, int F,
               int D, int tile, int bitlevel) {
  extern __shared__ float smem[];
  float* qs = smem;            // [JC][D] quantized window rows
  float* ms = qs + JC * D;     // [GROUP][JC] mask slice
  __shared__ float red[MAX_WARPS][GROUP];
  __shared__ float cw_s[GROUP];
  __shared__ float f_s[GROUP];

  const int t = blockIdx.x;
  const int g0 = blockIdx.y * GROUP;
  const int ng = min(GROUP, tile - g0);
  const int d = threadIdx.x;
  const bool col = d < D;
  const T* uw = uwin + (size_t)t * F * D;
  const float* Mt = M + ((size_t)t * tile + g0) * F;

  float acc[GROUP];
#pragma unroll
  for (int ii = 0; ii < GROUP; ++ii) acc[ii] = 0.0f;
  float cw = 0.0f;  // threads ii < GROUP count row ii of the mask

  for (int j0 = 0; j0 < F; j0 += JC) {
    const int nj = min(JC, F - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int k = threadIdx.x; k < nj * D; k += blockDim.x) {
      const int jj = k / D, dd = k - jj * D;
      qs[jj * D + dd] =
          w2b::quantize(w2b::to_f32(uw[(size_t)(j0 + jj) * D + dd]), bitlevel);
    }
    for (int k = threadIdx.x; k < GROUP * JC; k += blockDim.x) {
      const int ii = k / JC, jj = k - ii * JC;
      ms[k] = (ii < ng && jj < nj) ? Mt[(size_t)ii * F + j0 + jj] : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < GROUP) {
      for (int jj = 0; jj < nj; ++jj) cw += ms[threadIdx.x * JC + jj];
    }
    if (col) {
      for (int jj = 0; jj < nj; ++jj) {
        const float q = qs[jj * D + d];
#pragma unroll
        for (int ii = 0; ii < GROUP; ++ii)
          acc[ii] = fmaf(ms[ii * JC + jj], q, acc[ii]);
      }
    }
  }
  if (threadIdx.x < GROUP) cw_s[threadIdx.x] = cw;
  __syncthreads();

  const size_t b0 = (size_t)t * tile + g0;
  float cav[GROUP], qv[GROUP];
#pragma unroll
  for (int ii = 0; ii < GROUP; ++ii) {
    cav[ii] = 0.0f;
    qv[ii] = 0.0f;
    if (ii < ng && col) {
      cav[ii] = __fdiv_rn(acc[ii], fmaxf(cw_s[ii], 1.0f));
      qv[ii] = w2b::quantize(w2b::to_f32(vc[(b0 + ii) * D + d]), bitlevel);
    }
  }

  // f[ii] = sum_d cav*qv: warp shuffles, then one pass over the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
#pragma unroll
  for (int ii = 0; ii < GROUP; ++ii) {
    float p = cav[ii] * qv[ii];
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) red[warp][ii] = p;
  }
  __syncthreads();
  if (threadIdx.x < GROUP) {
    float s = 0.0f;
    for (int w = 0; w < nwarp; ++w) s += red[w][threadIdx.x];
    f_s[threadIdx.x] = s;
  }
  __syncthreads();

  const float alpha = *alpha_p;
  float loss = 0.0f;
#pragma unroll
  for (int ii = 0; ii < GROUP; ++ii) {
    if (ii < ng) {
      const size_t b = b0 + ii;
      const float f = f_s[ii];
      const float af = cw_s[ii] > 0.0f ? valid[b] : 0.0f;
      const float g = (1.0f - w2b::sigmoid_lut(f)) * alpha * af;
      if (col) {
        cavg_o[b * D + d] = cav[ii];
        cavge_o[b * D + d] = g * qv[ii];
        dvc_o[b * D + d] = g * cav[ii];
      }
      if (threadIdx.x == 0) {
        af_o[b] = af;
        loss += logf(w2b::sigmoid_exact(f)) * af;
      }
    }
  }
  if (threadIdx.x == 0) loss_o[blockIdx.y * gridDim.x + t] = loss;
}

template <typename T>
int launch(const void* uwin, const void* vc, const float* M,
           const float* valid, const float* alpha, float* cavg, float* cavge,
           float* dvc, float* af, float* loss, int Nt, int F, int D, int tile,
           int bitlevel, cudaStream_t stream) {
  const int threads = ((D + 31) / 32) * 32;
  const size_t smem = (size_t)(JC * D + GROUP * JC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      context_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Nt, (tile + GROUP - 1) / GROUP);
  context_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(uwin), static_cast<const T*>(vc), M, valid, alpha,
      cavg, cavge, dvc, af, loss, F, D, tile, bitlevel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (uwin and vc).  loss has
// Nt * ceil(tile / 16) entries, one per block; the caller sums them.
// Returns cudaGetLastError() after the launch (0 = launched).
int w2b_context_forward(const void* uwin, const void* vc, const float* M,
                        const float* valid, const float* alpha, float* cavg,
                        float* cavge, float* dvc, float* af, float* loss,
                        int Nt, int F, int D, int tile, int bitlevel,
                        int dtype, void* stream) {
  if (D < 1 || D > 1024 || tile < 1 || F < tile) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(uwin, vc, M, valid, alpha, cavg, cavge, dvc,
                                 af, loss, Nt, F, D, tile, bitlevel, s);
  if (dtype == 0)
    return launch<float>(uwin, vc, M, valid, alpha, cavg, cavge, dvc, af,
                         loss, Nt, F, D, tile, bitlevel, s);
  return (int)cudaErrorInvalidValue;
}

int w2b_context_loss_slots(int Nt, int tile) {
  return Nt * ((tile + GROUP - 1) / GROUP);
}

}  // extern "C"
