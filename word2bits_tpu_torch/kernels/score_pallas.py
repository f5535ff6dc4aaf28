"""Fused shared-negative phase: quantize -> scores -> gradient products.

Kernel: csrc/score.cu, a CUDA C++ kernel for sm_90a that replaces the JAX
package's TPU kernel `quantized_scores_pallas` (kernels/score_pallas.py,
body `_kernel`; the `-use-pallas` path).  Per tile of G centers sharing
P*K negatives (center g uses pool g % P):

    q_vn   = quantize(v_rows)
    f      = cavg @ q_vn^T
    g      = (0 - sigma_LUT(f)) * alpha * mask     (skip-center, pool, af)
    cavge  = g @ q_vn
    dv     = g^T @ cavg - 2*alpha*reg * v_rows * visits
    loss   = sum((log sigma_exact(-f) - reg*||q_vn||^2) * mask)

Bound on the H100: bytes and float32 operations about equally (~7 us each
at the shipped shape; see the source note in csrc/score.cu).  The kernel
keeps q_vn, f and g in shared memory: only the two gradient blocks reach
device memory.

`quantized_scores_plain` is the plain PyTorch version (three batched
products), which the steps also run when `use_pallas` is off, as the JAX
package's XLA path computes the same function.  `quantized_scores_pallas`
runs it for CPU tensors and launches the kernel for CUDA tensors, raising
on what the kernel does not take; there is no fallback.
`quantized_scores_pallas.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from word2bits_tpu_torch.kernels._build import check_launch, load_library
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut

_SMEM_LIMIT = 232_448   # bytes of shared memory one block may use (H100)


def pool_mask(G: int, K: int, P: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """[G, P*K] mask: center g of a tile uses only negative pool g % P."""
    pool_of_neg = torch.arange(P * K, device=device) // K
    pool_of_ctr = torch.arange(G, device=device) % P
    return (pool_of_ctr[:, None] == pool_of_neg[None, :]).to(dtype)


def quantized_scores_plain(cavg3, v_rows, centers3, negs, af3, scalars,
                           bitlevel: int, reg: float, neg_pool: int = 1,
                           lane_weight=None):
    """(cavge [T, G, D], dv [T, P*K, D], loss []) — the plain version.
    `lane_weight` ([P*K] float32, optional) scales each negative lane's
    mask: the importance weights of the stratified and dense-hot samplers
    (models/cbow_fused.py), which the kernel does not take."""
    G, PK = cavg3.shape[1], v_rows.shape[1]
    P = neg_pool if neg_pool > 1 else 1
    alpha = scalars.reshape(())
    q_vn = quantize(v_rows, bitlevel)                          # [T, PK, D]
    f = torch.bmm(cavg3, q_vn.transpose(1, 2))                 # [T, G, PK]
    m = ((negs[:, None, :] != centers3[:, :, None]).to(f.dtype)
         * af3[:, :, None])
    if P > 1:
        m = m * pool_mask(G, PK // P, P, f.dtype, f.device)[None]
    if lane_weight is not None:
        m = m * lane_weight[None, None, :]
    g = (0.0 - sigmoid_lut(f)) * alpha * m
    neg_reg = ((reg * (q_vn * q_vn).sum(dim=-1))[:, None, :]
               if reg else 0.0)
    loss = ((torch.log(sigmoid_exact(-f)) - neg_reg) * m).sum()
    cavge = torch.bmm(g, q_vn)
    dv = torch.bmm(g.transpose(1, 2), cavg3)
    if reg:
        dv = dv - (2.0 * alpha * reg) * v_rows * m.sum(dim=1)[:, :, None]
    return cavge, dv, loss


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/score.cu, built on first use, with its C signatures."""
    lib = load_library("score")
    lib.w2b_scores.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                               + [ctypes.c_float, ctypes.c_void_p])
    lib.w2b_scores.restype = ctypes.c_int
    lib.w2b_score_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.w2b_score_smem_bytes.restype = ctypes.c_longlong
    return lib


def _launch(cavg3, v_rows, centers3, negs, af3, scalars, bitlevel: int,
            reg: float, P: int):
    T, G, D = cavg3.shape
    PK = v_rows.shape[1]
    dev = cavg3.device
    args = (("cavg3", cavg3, torch.float32, (T, G, D)),
            ("v_rows", v_rows, torch.float32, (T, PK, D)),
            ("centers3", centers3, torch.int64, (T, G)),
            ("negs", negs, torch.int64, (T, PK)),
            ("af3", af3, torch.float32, (T, G)),
            ("scalars", scalars, torch.float32, (1, 1)))
    for name, t, dtype, shape in args:
        if t.device != dev:
            raise ValueError(f"quantized_scores_pallas: {name} is on "
                             f"{t.device}, cavg3 on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"quantized_scores_pallas: {name} must be "
                             f"{dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"quantized_scores_pallas: {name} must be "
                             "contiguous")
    if PK % P:
        raise ValueError(f"quantized_scores_pallas: {P} pools do not divide "
                         f"{PK} negatives")
    lib = _library()
    smem = lib.w2b_score_smem_bytes(G, PK, D)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"quantized_scores_pallas: a tile of G={G}, "
                         f"P*K={PK}, D={D} needs {smem} bytes of shared "
                         f"memory (limit {_SMEM_LIMIT})")
    f32 = dict(dtype=torch.float32, device=dev)
    cavge = torch.empty((T, G, D), **f32)
    dv = torch.empty((T, PK, D), **f32)
    loss = torch.empty((T,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.w2b_scores(
        cavg3.data_ptr(), v_rows.data_ptr(), centers3.data_ptr(),
        negs.data_ptr(), af3.data_ptr(), scalars.data_ptr(),
        cavge.data_ptr(), dv.data_ptr(), loss.data_ptr(),
        T, G, PK, D, P, bitlevel, float(reg), stream)
    check_launch("w2b_scores", err)
    quantized_scores_pallas.launches += 1
    return cavge, dv, loss.sum()


def quantized_scores_pallas(cavg3, v_rows, centers3, negs, af3, scalars,
                            bitlevel: int, reg: float, neg_pool: int = 1):
    """The fused negative phase over all T tiles.

    cavg3    [T, G, D] f32   context averages
    v_rows   [T, P*K, D] f32 gathered (unquantized) negative rows
    centers3 [T, G] int64    center ids
    negs     [T, P*K] int64  negative ids (neg_pool P pools per tile)
    af3      [T, G] f32      active-center mask
    scalars  [1, 1] f32      alpha
    Returns (cavge [T, G, D], dv_neg [T, P*K, D], loss [])."""
    if not isinstance(bitlevel, int) or bitlevel < 0:
        raise ValueError(f"bitlevel must be an int >= 0, got {bitlevel!r}")
    P = neg_pool if neg_pool > 1 else 1
    if cavg3.device.type == "cpu":
        return quantized_scores_plain(cavg3, v_rows, centers3, negs, af3,
                                      scalars, bitlevel, reg, P)
    if cavg3.device.type != "cuda":
        raise ValueError("quantized_scores_pallas runs on cpu (plain "
                         f"version) or cuda (kernel), not {cavg3.device}")
    return _launch(cavg3, v_rows, centers3, negs, af3, scalars, bitlevel,
                   reg, P)


quantized_scores_pallas.launches = 0
