"""The model module of CBOW: the plain reference of its step, CBOW with
negative sampling on quantized vectors in plain PyTorch, and the work a
step needs.  A configuration whose `reference` key names this file is
checked and counted by it (benchmark/cells.py resolves the key; the
contract is in benchmark/README.md, "A configuration of another model").

Imports torch and the benchmark's model-free parts (benchmark/plain.py)
only: nothing of the program under test, of JAX or of
the JAX package.  The step is a frozen copy of the port's plain formula
(commit 26809b4dee3683ec1871bc5d1e1a6fa56c4992c9):
word2bits_tpu_torch/models/cbow.py `cbow_minibatch_update` (reference
src/word2bits.cpp:363-516) over the B consecutive centers of a slab, with
the shared negatives of models/cbow_slab.py's tiles (center b joins tile
b % T, member b // T uses pool (b // T) % P) spelled out per center.

The reference holds only the rows a few steps touch (`plain.Rows`), in
the configuration's storage dtype, and computes in float32.  Every update
of a step is summed per row in float32 and added to the stored row once,
as the port's sorted scatters do.  `storage` and `compute` are arguments
so that the same code, one precision lower, is the control; `half` leaves
out the second half of each batch and doubles the rate, the fault the
tests plant.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.plain import EDGE_TOL, MAX_EXP, Rows, quantize, \
    sigmoid_exact, sigmoid_lut, store

MODELS = ("cbow",)


@dataclass(frozen=True)
class Hyper:
    bitlevel: int
    size: int
    window: int
    negative: int
    batch: int
    neg_sharing: int = 0     # G; 0 = per-center negatives [B, K]
    neg_pool: int = 1        # P


def per_center_negatives(negs: torch.Tensor, hp: Hyper) -> torch.Tensor:
    """[B, K] negative ids of each center: as drawn ([B, K]) or, shared,
    the K lanes of its tile's pool ([B/G, P*K] drawn)."""
    B, K = hp.batch, hp.negative
    if not hp.neg_sharing:
        return negs
    T = B // hp.neg_sharing
    P = max(hp.neg_pool, 1)
    b = torch.arange(B, device=negs.device)
    lanes = ((b // T) % P)[:, None] * K + torch.arange(K, device=negs.device)
    return negs[(b % T)[:, None], lanes]


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Hyper,
         compute: torch.dtype = torch.float32,
         half: bool = False) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1,
    on `rows` in place; returns the step's loss (float32), and leaves in
    rows.loss_bounds the least and the most it can be when the scores at
    exactly +-6 fall on either side of the saturation.  `compute` is
    the precision of the arithmetic; `half` keeps only the first B/2
    centers and doubles the rate (the mean over the rest)."""
    B, W, D, bl = hp.batch, hp.window, hp.size, hp.bitlevel
    dev = rows.u.device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    slab = slab_tokens.clamp_min(0)
    centers = slab[W:W + B]
    sents = slab_sents
    csent = sents[W:W + B]
    offsets = [o for o in range(-W, W + 1) if o != 0]
    odist = torch.tensor([abs(o) for o in offsets], device=dev)
    ctx_sent = torch.stack([sents[W + o:W + o + B] for o in offsets], dim=1)
    valid = csent >= 0
    if half:
        valid = valid & (torch.arange(B, device=dev) < B // 2)
    mask = ((odist[None, :] <= (W - shrink)[:, None])
            & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))
    r_slab = rows.index(slab)
    q_u = quantize(rows.u[r_slab].to(compute), bl)           # [B+2W, D]
    mf = mask.to(compute)
    csum = torch.zeros((B, D), dtype=compute, device=dev)
    for oi, o in enumerate(offsets):
        csum = csum + mf[:, oi, None] * q_u[W + o:W + o + B]
    cw = mask.sum(dim=1)
    af = (valid & (cw > 0)).to(compute)
    cavg = csum / torch.clamp_min(cw, 1).to(compute)[:, None]

    neg = per_center_negatives(negs, hp)                      # [B, K]
    targets = torch.cat([centers[:, None], neg], dim=1)       # [B, K+1]
    r_t = rows.index(targets)
    q_v = quantize(rows.v[r_t].to(compute), bl)               # [B, K+1, D]
    f = torch.bmm(q_v, cavg[:, :, None])[..., 0]
    label = torch.zeros_like(f)
    label[:, 0] = 1.0
    dmask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       neg != centers[:, None]], dim=1).to(compute)
    dmask = dmask * af[:, None]
    g = (label - sigmoid_lut(f)) * a * dmask
    signed = torch.where(label > 0, f, -f).float()
    terms = torch.log(sigmoid_exact(signed)) * dmask.float()
    # at |f| = 6 the loss path jumps (log 1e-9 against log sigma(-6), log
    # 1 against log sigma(6)); bitlevel-1 scores are multiples of 1/(9 cw)
    # and land on the edge exactly, where float order picks the side
    edge = ((signed.abs() - MAX_EXP).abs() < EDGE_TOL) & (dmask > 0)
    # the other side's value: log sigma(s) past the edge, else 0 or log 1e-9
    other = torch.where(signed.abs() > MAX_EXP,
                        torch.log(torch.sigmoid(signed)),
                        torch.where(signed > 0, 0.0, math.log(1e-9)))
    other = torch.where(edge, other * dmask.float(), terms)
    loss = terms.sum()
    bounds = (torch.minimum(terms, other).sum(),
              torch.maximum(terms, other).sum())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(bounds[0]) * scale, float(bounds[1]) * scale)
    loss = loss * scale
    cavge = torch.bmm(g[:, None, :], q_v)[:, 0]               # [B, D]
    dv = g[..., None] * cavg[:, None, :]                      # [B, K+1, D]
    du = torch.zeros((B + 2 * W, D), dtype=compute, device=dev)
    for oi, o in enumerate(offsets):
        du[W + o:W + o + B] += (mf[:, oi] * af)[:, None] * cavge

    R = rows.ids.numel()
    acc_u = torch.zeros((R, D), dtype=torch.float32, device=dev)
    acc_v = torch.zeros((R, D), dtype=torch.float32, device=dev)
    acc_u.index_add_(0, r_slab, du.float())
    acc_v.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    rows.u = store(rows.u.float() + acc_u, rows.storage)
    rows.v = store(rows.v.float() + acc_v, rows.storage)
    return loss.float()


def hyper(cfg) -> Hyper:
    """The step's hyperparameters from the program's configuration."""
    G = cfg.neg_sharing
    return Hyper(bitlevel=cfg.bitlevel, size=cfg.size, window=cfg.window,
                 negative=cfg.negative, batch=cfg.batch_size, neg_sharing=G,
                 neg_pool=cfg.neg_pool if (G and cfg.neg_pool > 1) else 1)


def negative_shape(cfg, S: int) -> tuple:
    """The negatives of one chunk call of S steps, as the program's
    `chunk_fn(..., negs=)` takes them: [S, B/G, P*K] shared by tiles of G
    centers, else [S, B, K]."""
    hp = hyper(cfg)
    B, K, G = hp.batch, hp.negative, hp.neg_sharing
    return (S, B // G, hp.neg_pool * K) if G else (S, B, K)


def step_flops(shape) -> float:
    """Context sums and u sums over 2W offsets, and per center and target
    (center + K negatives) a dot product, its u-gradient term and its v
    row, each 2D operations; the scatter adds."""
    B, W, D, K = shape.B, shape.W, shape.D, shape.K
    adds = (shape.n_slab + shape.n_negs) * (2 * D if shape.fused else D)
    return 2.0 * (B * 2 * W * D) + 6.0 * B * (K + 1) * D + adds


def step_bytes(shape) -> float:
    """Each touched u row and v row read and written once."""
    D, e = shape.D, shape.elt
    return 2.0 * (shape.rows_slab + shape.rows_v) * D * e
