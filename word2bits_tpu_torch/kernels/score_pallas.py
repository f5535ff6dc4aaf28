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
at the shipped shape; see the source note in csrc/score.cu).  Each tile
runs on a thread-block cluster of CLUSTER CTAs, each holding D / CLUSTER
of its columns: the partial scores are summed across the cluster through
distributed shared memory in rank order, and each CTA writes cavge and dv
for its own columns (at the shipped shape one CTA of 512 threads a tile
was the fastest).  q_vn, f and g stay in shared memory: only the two
gradient blocks reach device memory.

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
# CTAs per tile (a thread-block cluster along D): 1, 2 and 4 were timed at
# the shipped shape and 1 was the fastest (tools/tune_kernels.py, PERF.md).
# A tile whose CTA would not fit in shared memory takes the smallest larger
# cluster that fits (cluster_size).
CLUSTER = 1
_MAX_CLUSTER = 8


def pool_mask(G: int, K: int, P: int, dtype=torch.float32,
              device=None, offset: int = 0) -> torch.Tensor:
    """[G, P*K] mask: center g of a tile uses only negative pool g % P.
    `offset` shifts the member index: a data shard of a mesh holding tile
    members [offset, offset+G) passes its first member, so its routing of
    centers to pools matches the whole tile's (parallel/sharded_slab.py)."""
    pool_of_neg = torch.arange(P * K, device=device) // K
    pool_of_ctr = (offset + torch.arange(G, device=device)) % P
    return (pool_of_ctr[:, None] == pool_of_neg[None, :]).to(dtype)


def quantized_scores_plain(cavg3, v_rows, centers3, negs, af3, scalars,
                           bitlevel: int, reg: float, neg_pool: int = 1,
                           lane_weight=None, pool_offset: int = 0):
    """(cavge [T, G, D], dv [T, P*K, D], loss []) — the plain version.
    `lane_weight` ([P*K] float32, optional) scales each negative lane's
    mask: the importance weights of the stratified and dense-hot samplers
    (models/cbow_fused.py), which the kernel does not take.
    `pool_offset`: pool_mask's offset (a mesh's data shard)."""
    G, PK = cavg3.shape[1], v_rows.shape[1]
    P = neg_pool if neg_pool > 1 else 1
    alpha = scalars.reshape(())
    q_vn = quantize(v_rows, bitlevel)                          # [T, PK, D]
    f = torch.bmm(cavg3, q_vn.transpose(1, 2))                 # [T, G, PK]
    m = ((negs[:, None, :] != centers3[:, :, None]).to(f.dtype)
         * af3[:, :, None])
    if P > 1:
        m = m * pool_mask(G, PK // P, P, f.dtype, f.device,
                           pool_offset)[None]
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


def smem_bytes(G: int, PK: int, D: int, cluster: int | None = None) -> int:
    """Shared-memory bytes of one CTA of the kernel (csrc/score.cu Layout)
    with `cluster` CTAs a tile (CLUSTER by default): G and P*K padded to 4,
    each CTA's ceil(D / cluster) columns padded to 4 (and by 4 more where
    that leaves an even number of 16-byte vectors), a partial-score slot
    per rank, the 997 LUT values."""
    cluster = CLUSTER if cluster is None else cluster

    def up(x, m):
        return -(-x // m) * m
    Gp, PKp, Gr = up(G, 4), up(PK, 4), -(-G // cluster)
    Dc = up(-(-D // cluster), 4)
    Dp = Dc if (Dc // 4) % 2 else Dc + 4
    floats = ((Gp + PKp) * Dp + cluster * Gr * PKp + Gp * PKp
              + cluster * PKp + PKp + Gp + 8 + 1000)
    return (Gp + PKp) * 8 + 4 * floats


def cluster_size(G: int, PK: int, D: int) -> int:
    """CTAs a tile: the smallest power of two from CLUSTER up to 8 whose
    CTA fits in shared memory (0 if none does)."""
    cl = CLUSTER
    while cl <= _MAX_CLUSTER:
        if smem_bytes(G, PK, D, cl) <= _SMEM_LIMIT:
            return cl
        cl *= 2
    return 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/score.cu, built on first use, with its C signatures."""
    lib = load_library("score")
    lib.w2b_scores.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                               + [ctypes.c_float, ctypes.c_void_p])
    lib.w2b_scores.restype = ctypes.c_int
    lib.w2b_score_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.w2b_score_smem_bytes.restype = ctypes.c_longlong
    lib.w2b_score_threads.restype = ctypes.c_int
    return lib


def _check(cavg3, v_rows, centers3, negs, af3, scalars, P: int) -> None:
    """Raise on anything the kernel does not take."""
    fn = "quantized_scores_pallas"
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
            raise ValueError(f"{fn}: {name} is on {t.device}, cavg3 on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if P < 1 or PK % P:
        raise ValueError(f"{fn}: {P} pools do not divide {PK} negatives")
    if not cluster_size(G, PK, D):
        raise ValueError(f"{fn}: a tile of G={G}, P*K={PK}, D={D} needs "
                         f"{smem_bytes(G, PK, D, _MAX_CLUSTER)} bytes of "
                         f"shared memory in each CTA of a cluster of "
                         f"{_MAX_CLUSTER} (limit {_SMEM_LIMIT})")


def _launch(cavg3, v_rows, centers3, negs, af3, scalars, bitlevel: int,
            reg: float, P: int):
    _check(cavg3, v_rows, centers3, negs, af3, scalars, P)
    T, G, D = cavg3.shape
    PK = v_rows.shape[1]
    dev = cavg3.device
    f32 = dict(dtype=torch.float32, device=dev)
    cavge = torch.empty((T, G, D), **f32)
    dv = torch.empty((T, PK, D), **f32)
    loss = torch.empty((T,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().w2b_scores(
        cavg3.data_ptr(), v_rows.data_ptr(), centers3.data_ptr(),
        negs.data_ptr(), af3.data_ptr(), scalars.data_ptr(),
        cavge.data_ptr(), dv.data_ptr(), loss.data_ptr(),
        T, G, PK, D, P, bitlevel, cluster_size(G, PK, D), float(reg),
        stream)
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
