"""The model module of skip-gram with per-pair negative sampling (SGNS,
`-model skipgram -neg-per-pair 1`): its plain reference step in plain
PyTorch, the shape of its negatives and the work a step needs.  A
configuration whose `reference` key names this file is checked and
counted by it (benchmark/cells.py; the contract is in benchmark/README.md,
"A configuration of another model").

Imports torch and the benchmark's model-free parts (benchmark/plain.py)
only: nothing of the program under test, of JAX or of the JAX package.
The step is a copy of tests/plain_skipgram.py `step` on plain.py's
quantizer, sigmoids and `Rows`, held bit for bit equal to it by
benchmark/tests/test_bench_skipgram.py.  It follows word2vec.c's
skip-gram loop and arXiv 1310.4546 §2.2: every (center, context) pair's
context row predicts the center against K negatives drawn for that pair
(pair-major, [B, 2W*K] a step: pair oi of center b at lanes oi*K ..
oi*K+K-1), a negative equal to the center skipped; on the Word2Bits
contract (quantized reads, the table sigmoid in the gradient, the exact
one in the loss, 2*alpha*reg decay a visit).  Departures, as in the
program: a synchronous minibatch of B centers from the rows as they were
before the step; masked pairs' draws masked, not left undrawn; each row's
updates summed in float32 and added once a step.

The reference holds only the rows a step touches (`plain.Rows`) and
computes in blocks of BLOCK centers, so that at the published widths (D
300, W 5, K 15, B 8192) no intermediate exceeds [512, 10, 16, 300].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from benchmark.plain import EDGE_TOL, MAX_EXP, Rows, quantize, \
    sigmoid_exact, sigmoid_lut, store

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODELS = ("skipgram",)
BLOCK = 512


@dataclass(frozen=True)
class Hyper:
    bitlevel: int
    size: int
    window: int
    negative: int
    batch: int
    reg: float = 0.0


def hyper(cfg) -> Hyper:
    """The step's hyperparameters from the program's configuration; a
    configuration without the per-pair draw (-neg-per-pair 1) is
    refused: this module follows no other."""
    if not getattr(cfg, "neg_per_pair", False):
        raise ValueError("benchmark/skipgram.py follows skip-gram with "
                         "per-pair negatives; the program's configuration "
                         "has no -neg-per-pair 1")
    return Hyper(bitlevel=cfg.bitlevel, size=cfg.size, window=cfg.window,
                 negative=cfg.negative, batch=cfg.batch_size, reg=cfg.reg)


def negative_shape(cfg, S: int) -> tuple:
    """The negatives of one chunk call of S steps: [S, B, 2W*K]."""
    hp = hyper(cfg)
    return (S, hp.batch, 2 * hp.window * hp.negative)


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Hyper,
         compute: torch.dtype = torch.float32, half: bool = False,
         block: int = BLOCK) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1
    (slab_tokens, slab_sents [B+2W], -1 padding; shrink [B]; negs
    [B, 2W*K]) on `rows` in place; returns the step's loss (float32) and
    leaves in rows.loss_bounds the least and the most it can be when the
    scores at exactly +-6 fall on either side of the saturation.
    `compute` is the arithmetic's precision; `half` keeps only the first
    B/2 centers and doubles the rate.  Computed in blocks of `block`
    centers; every update is summed per row in float32 over the step."""
    B, W, D, K, bl = hp.batch, hp.window, hp.size, hp.negative, hp.bitlevel
    dev = rows.u.device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    two_ar = 2.0 * a * hp.reg
    slab = slab_tokens.clamp_min(0)
    centers = slab[W:W + B]
    csent = slab_sents[W:W + B]
    offsets = [o for o in range(-W, W + 1) if o != 0]
    odist = torch.tensor([abs(o) for o in offsets], device=dev)
    ctx = torch.stack([slab[W + o:W + o + B] for o in offsets], dim=1)
    ctx_sent = torch.stack([slab_sents[W + o:W + o + B] for o in offsets],
                           dim=1)
    valid = csent >= 0
    if half:
        valid = valid & (torch.arange(B, device=dev) < B // 2)
    mask = ((odist[None, :] <= (W - shrink)[:, None])
            & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))                                 # [B, 2W]
    negs3 = negs.reshape(B, 2 * W, K)
    R = rows.ids.numel()
    acc_u = torch.zeros((R, D), dtype=torch.float32, device=dev)
    acc_v = torch.zeros((R, D), dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.zeros((), dtype=torch.float32, device=dev)
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        n = b1 - b0
        m = mask[b0:b1].to(compute)                            # [n, 2W]
        c = centers[b0:b1]
        r_in = rows.index(ctx[b0:b1])                          # [n, 2W]
        x_in = rows.u[r_in].to(compute)                        # [n, 2W, D]
        q_in = quantize(x_in, bl)
        # targets of each pair: the center, then its K negatives
        r_t = torch.cat([rows.index(c)[:, None, None].expand(n, 2 * W, 1),
                         rows.index(negs3[b0:b1])], dim=2)     # [n,2W,K+1]
        x_t = rows.v[r_t].to(compute)                          # [.., K+1, D]
        q_t = quantize(x_t, bl)
        f = torch.matmul(q_t, q_in[..., None])[..., 0]         # [n,2W,K+1]
        label = torch.zeros_like(f)
        label[..., 0] = 1.0
        eligible = torch.cat(
            [torch.ones((n, 2 * W, 1), dtype=torch.bool, device=dev),
             negs3[b0:b1] != c[:, None, None]], dim=2)
        dm = eligible.to(compute) * m[..., None]
        g = (label - sigmoid_lut(f)) * a * dm
        # the loss: log sigma(+-f) less reg * |q|^2 of the pair's rows
        signed = torch.where(label > 0, f, -f).float()
        lg = torch.log(sigmoid_exact(signed))
        rg = 0.0
        if hp.reg:
            rg = hp.reg * ((q_t * q_t).sum(dim=-1) + label
                           * (q_in * q_in).sum(dim=-1)[..., None]).float()
        dmf = dm.float()
        terms = (lg - rg) * dmf
        # at |f| = 6 the loss path jumps; bitlevel-1 scores are multiples
        # of 1/9 and land on the edge exactly, where float order picks the
        # side: the other side's value there
        edge = ((signed.abs() - MAX_EXP).abs() < EDGE_TOL) & (dmf > 0)
        other = torch.where(signed.abs() > MAX_EXP,
                            torch.log(torch.sigmoid(signed)),
                            torch.where(signed > 0, 0.0, math.log(1e-9)))
        other = torch.where(edge, (other - rg) * dmf, terms)
        loss = loss + terms.sum()
        lo = lo + torch.minimum(terms, other).sum()
        hi = hi + torch.maximum(terms, other).sum()
        # v rows: each target's g times the pair's input, less its decay
        dv = g[..., None] * q_in[:, :, None, :]                # [n,2W,K+1,D]
        du = torch.matmul(g[:, :, None, :], q_t)[:, :, 0]      # [n, 2W, D]
        du = du * m[..., None]
        if hp.reg:
            dv = dv - two_ar * x_t * dm[..., None]
            du = du - two_ar * x_in * m[..., None]
        acc_u.index_add_(0, r_in.reshape(-1), du.reshape(-1, D).float())
        acc_v.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(lo) * scale, float(hi) * scale)
    rows.u = store(rows.u.float() + acc_u, rows.storage)
    rows.v = store(rows.v.float() + acc_v, rows.storage)
    return (loss * scale).float()


def step_flops(shape) -> float:
    """Per pair (2W a center) and target (the center and its K
    negatives): the dot product, the input row's gradient term and the
    target's v row, each 2D operations; the u sums of the 2W pairs by slab
    position; the scatters' adds (B + the negatives' v rows, B+2W u)."""
    B, W, D, K = shape.B, shape.W, shape.D, shape.K
    pairs = B * 2 * W
    adds = (shape.B + shape.n_negs + shape.n_slab) * D
    return 6.0 * pairs * (K + 1) * D + pairs * D + adds


def step_bytes(shape) -> float:
    """Each touched u row (the slab's words) and v row (the centers and
    every pair's negatives) read and written once."""
    D, e = shape.D, shape.elt
    return 2.0 * (shape.rows_slab + shape.rows_v) * D * e
