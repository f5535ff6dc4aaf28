"""The model module of fastText's CBOW with position weights and subwords
(Grave et al. 2018, arXiv 1802.06893, §3, the recipe of the published
cc.<lang>.300 vectors; Mikolov et al. 2018, arXiv 1712.09405, §2.2-2.3;
the program's `-model fasttext-cbow`): its plain reference step in plain
PyTorch, the leaves, the rows a step touches, the negatives' shape and the
work a step needs.  A configuration whose `reference` key names this file
is checked and counted by it (benchmark/cells.py; the contract, its
optional pieces included, is in benchmark/README.md and
benchmark/hooks.py).

Imports torch, numpy and the benchmark's model-free parts
(benchmark/plain.py) and benchmark/fasttext.py, whose spelled words
(`vocab_words`), subword rows (`bind`: each word's G_w, its own row and
one bucket row per n-gram of `<word>`) and draw distribution
(`negative_probs`, count^0.5) this model shares: nothing of the program
under test, of JAX or of the JAX package.  The step is a copy of
tests/plain_fasttext_cbow.py `step` on plain.py's quantizer, sigmoids and
`Rows`, held bit for bit equal to it by
benchmark/tests/test_bench_fasttext_cbow.py.

- `leaves`: the program's three tables as they are, input rows
  [V + buckets, D], output rows [V, D] and the position weights [2W, D];
- `touched`: input rows, the G_w rows of every slab word; output rows,
  the centers and the negatives; the position weights, all 2W rows;
- `negative_shape`: K draws per center, [S, B, K] a chunk call;
- `step`: per center t, x_w the mean of word w's quantized G_w rows, h_t
  = (1/n_t) sum_p m_{t,p} d_p * x_{w_{t+p}} (d not quantized), the
  center's output row and its K draws (one equal to the center skipped)
  scored against h_t on the Word2Bits contract (quantized reads, the
  table sigmoid in the gradient, the exact one in the loss, 2*alpha*reg
  decay a visit, none on d); each output row gets g * h_t, every row of
  G_{w_{t+p}} gets m_{t,p} d_p * e_t and d_p gets sum_t m_{t,p} e_t *
  x_{w_{t+p}}, e_t the gradient of h_t, undivided.  Departures, as in
  the program: public `fasttext cbow` pools the window's subword ids into
  one mean and has no position weights, this follows the 2018 papers; d
  starts at 1; a synchronous minibatch of B centers from the rows as they
  were before the step; masked centers' draws masked, not left undrawn;
  each row's updates summed in float32 and added once a step.  Computed
  in blocks of BLOCK centers, so that at the published widths (D 300, W
  5, K 10, B 8192) no intermediate exceeds [512, 11, 300];
- `step_flops`, `step_bytes`: from each word's |G_w| in the bound state
  under the subsampled stream's distribution.
"""

from __future__ import annotations

import math
from typing import List

import torch

from benchmark.fasttext import (Bound, bind, center_subwords, hyper,
                                mean_subwords, negative_probs, vocab_words)
from benchmark.plain import EDGE_TOL, MAX_EXP, Rows, quantize, \
    sigmoid_exact, sigmoid_lut, store

__all__ = ["MODELS", "hyper", "negative_shape", "step", "step_flops",
           "step_bytes", "vocab_words", "bind", "negative_probs", "leaves",
           "touched", "Bound"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MODELS = ("fasttext-cbow",)
BLOCK = 512


def negative_shape(cfg, S: int) -> tuple:
    """The negatives of one chunk call of S steps: [S, B, K]."""
    return (S, cfg.batch_size, cfg.negative)


def leaves(tables, cfg) -> List[torch.Tensor]:
    """The input rows [V + buckets, D], the output rows [V, D] and the
    position weights [2W, D]."""
    if len(tables) != 3:
        raise ValueError(f"{len(tables)} tables: fasttext-cbow trains "
                         "three, u, v and the position weights")
    inp, out, pos = tables
    buckets = cfg.bucket if cfg.maxn else 0
    if inp.shape[0] != out.shape[0] + buckets:
        raise ValueError(f"input rows {inp.shape[0]}, output rows "
                         f"{out.shape[0]}: not V + {buckets} and V")
    if tuple(pos.shape) != (2 * cfg.window, cfg.size):
        raise ValueError(f"position weights {tuple(pos.shape)}, not "
                         f"[2W, D] = [{2 * cfg.window}, {cfg.size}]")
    return [inp, out, pos]


def touched(state: Bound, slab_tokens: torch.Tensor, negs: torch.Tensor):
    W, B = state.hyper.window, state.hyper.batch
    slab = slab_tokens.clamp_min(0)
    _, sub = center_subwords(state, slab)
    return [torch.unique(sub),
            torch.unique(torch.cat([slab[W:W + B], negs.reshape(-1)])),
            torch.arange(2 * W, device=slab.device)]


def step(rows: Rows, slab_tokens: torch.Tensor, slab_sents: torch.Tensor,
         shrink: torch.Tensor, negs: torch.Tensor, alpha: float, hp: Bound,
         compute: torch.dtype = torch.float32, half: bool = False,
         block: int = BLOCK) -> torch.Tensor:
    """One synchronous step over the B centers at slab positions W..W+B-1
    (slab_tokens, slab_sents [B+2W], -1 padding; shrink [B]; negs [B, K])
    on `rows` (leaf 0 input rows, leaf 1 output rows, leaf 2 the position
    weights) in place; returns the step's loss (float32) and leaves in
    rows.loss_bounds the least and the most it can be when the scores at
    exactly +-6 fall on either side of the saturation.  `compute` is the
    arithmetic's precision; `half` keeps only the first B/2 centers and
    doubles the rate.  Computed in blocks of `block` centers; every update
    is summed per row in float32 over the step."""
    h_ = hp.hyper
    B, W, D, bl = h_.batch, h_.window, h_.size, h_.bitlevel
    dev = rows.leaves[0].device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    two_ar = 2.0 * a * h_.reg
    slab = slab_tokens.clamp_min(0)
    centers = slab[W:W + B]
    csent = slab_sents[W:W + B]
    offsets = [o for o in range(-W, W + 1) if o != 0]
    odist = torch.tensor([abs(o) for o in offsets], device=dev)
    ctx_sent = torch.stack([slab_sents[W + o:W + o + B] for o in offsets],
                           dim=1)
    valid = csent >= 0
    if half:
        valid = valid & (torch.arange(B, device=dev) < B // 2)
    mask = ((odist[None, :] <= (W - shrink)[:, None])
            & (ctx_sent == csent[:, None]) & valid[:, None]
            & (ctx_sent >= 0))                                 # [B, 2W]
    x_in_all, x_out_all, x_pos_all = rows.leaves
    r_pos = rows.find(2, torch.arange(2 * W, device=dev))
    dpos = x_pos_all[r_pos].to(compute)                        # [2W, D]
    acc_in = torch.zeros(x_in_all.shape, dtype=torch.float32, device=dev)
    acc_out = torch.zeros(x_out_all.shape, dtype=torch.float32, device=dev)
    acc_pos = torch.zeros(x_pos_all.shape, dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.zeros((), dtype=torch.float32, device=dev)
    for b0 in range(0, B, block):
        b1 = min(B, b0 + block)
        n = b1 - b0
        m = mask[b0:b1].to(compute)                            # [n, 2W]
        n_ctx = m.sum(dim=1)
        act = (n_ctx > 0).to(compute)
        # x: each word's mean of its quantized subword rows, for the
        # block's window, slab positions b0 .. b1 + 2W - 1
        seg, sub = center_subwords(hp, slab[b0:b1 + 2 * W])
        r_sub = rows.find(0, sub)
        x_sub = x_in_all[r_sub].to(compute)                    # [N, D]
        q_sub = quantize(x_sub, bl)
        n_sub = torch.bincount(seg, minlength=n + 2 * W).to(compute)
        xw = torch.zeros((n + 2 * W, D), dtype=compute, device=dev)
        xw.index_add_(0, seg, q_sub)
        xw = xw / n_sub[:, None]
        xs = torch.stack([xw[W + o:W + o + n] for o in offsets],
                         dim=1)                                # [n, 2W, D]
        # h: the position-weighted mean of the context words' vectors
        hidden = ((m[..., None] * (dpos[None] * xs)).sum(dim=1)
                  / n_ctx.clamp_min(1.0)[:, None])
        # targets of each center: its own output row, then its K draws
        targets = torch.cat([centers[b0:b1, None], negs[b0:b1]], dim=1)
        r_t = rows.find(1, targets)                            # [n, K+1]
        x_t = x_out_all[r_t].to(compute)                       # [n, K+1, D]
        q_t = quantize(x_t, bl)
        f = torch.matmul(q_t, hidden[:, :, None])[..., 0]
        label = torch.zeros_like(f)
        label[:, 0] = 1.0
        eligible = torch.cat(
            [torch.ones((n, 1), dtype=torch.bool, device=dev),
             negs[b0:b1] != centers[b0:b1, None]], dim=1)
        dm = eligible.to(compute) * act[:, None]
        g = (label - sigmoid_lut(f)) * a * dm
        # the loss: log sigma(+-f) less reg * |q|^2 of the visits' rows
        signed = torch.where(label > 0, f, -f).float()
        lg = torch.log(sigmoid_exact(signed))
        rg = 0.0
        if h_.reg:
            in_sq = torch.zeros((n + 2 * W,), dtype=compute, device=dev)
            in_sq.index_add_(0, seg, (q_sub * q_sub).sum(dim=-1))
            ctx_sq = (m * torch.stack([in_sq[W + o:W + o + n]
                                       for o in offsets], dim=1)).sum(dim=1)
            rg = h_.reg * ((q_t * q_t).sum(dim=-1)
                           + label * ctx_sq[:, None]).float()
        dmf = dm.float()
        terms = (lg - rg) * dmf
        # at |f| = 6 the loss path jumps; where float order picks the
        # side of a score on the edge, the other side's value there
        edge = ((signed.abs() - MAX_EXP).abs() < EDGE_TOL) & (dmf > 0)
        other = torch.where(signed.abs() > MAX_EXP,
                            torch.log(torch.sigmoid(signed)),
                            torch.where(signed > 0, 0.0, math.log(1e-9)))
        other = torch.where(edge, (other - rg) * dmf, terms)
        loss = loss + terms.sum()
        lo = lo + torch.minimum(terms, other).sum()
        hi = hi + torch.maximum(terms, other).sum()
        # e: the gradient of h; the output rows: g times h, less the decay
        e = torch.matmul(g[:, None, :], q_t)[:, 0]             # [n, D]
        dv = g[..., None] * hidden[:, None, :]                 # [n, K+1, D]
        # the window: each position's word gets m d_p * e, d_p gets
        # m e * x
        dxw = torch.zeros((n + 2 * W, D), dtype=compute, device=dev)
        for p, o in enumerate(offsets):
            dxw[W + o:W + o + n] += m[:, p, None] * (dpos[p] * e)
        dd = (m[..., None] * (e[:, None, :] * xs)).sum(dim=0)  # [2W, D]
        du = dxw[seg]                                          # [N, D]
        if h_.reg:
            visits = torch.zeros((n + 2 * W,), dtype=compute, device=dev)
            for p, o in enumerate(offsets):
                visits[W + o:W + o + n] += m[:, p]
            dv = dv - two_ar * x_t * dm[..., None]
            du = du - two_ar * visits[seg][:, None] * x_sub
        acc_in.index_add_(0, r_sub, du.float())
        acc_out.index_add_(0, r_t.reshape(-1), dv.reshape(-1, D).float())
        acc_pos.index_add_(0, r_pos, dd.float())
    scale = 2.0 if half else 1.0
    rows.loss_bounds = (float(lo) * scale, float(hi) * scale)
    rows.leaves = [store(x_in_all.float() + acc_in, rows.storage),
                   store(x_out_all.float() + acc_out, rows.storage),
                   store(x_pos_all.float() + acc_pos, rows.storage)]
    return (loss * scale).float()


def step_flops(shape) -> float:
    """Per slab word (B+2W): the gather-mean's adds over its |G_w| rows and
    the G_w scatter's adds, D each; per center and window position (2W a
    center): the forward's and the backward's terms (h, dx and dd: two
    multiplies and an add each), 3D each; per center and target (its own
    output row and its K draws): the dot product, e's term and the output
    row, 2D each; the output scatter's adds (B centers and the
    negatives)."""
    B, W, D, K = shape.B, shape.W, shape.D, shape.K
    rows = shape.n_slab * mean_subwords(shape)
    return (2.0 * rows * D + 3.0 * 3.0 * B * 2 * W * D
            + 6.0 * B * (K + 1) * D + (B + shape.n_negs) * D)


def step_bytes(shape) -> float:
    """Each slab word's |G_w| input rows (as gathered: an upper bound of
    the distinct rows), each touched output row (the centers and the
    negatives) and the position weights (float32) read and written
    once."""
    rows_in = shape.n_slab * mean_subwords(shape)
    return (2.0 * (rows_in + shape.rows_v) * shape.D * shape.elt
            + 2.0 * 2 * shape.W * shape.D * 4)
