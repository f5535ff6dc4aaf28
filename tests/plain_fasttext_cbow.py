"""fastText's CBOW with position weights and subwords (Grave et al. 2018,
arXiv 1802.06893, §3; Mikolov et al. 2018, arXiv 1712.09405, §2.2-2.3) in
plain float32 PyTorch: the reference that tests/test_torch_fasttext_cbow.py
holds the port's `-model fasttext-cbow` route against.

Three leaves: the input rows (words, then the n-gram buckets), the output
rows, and the position weights d [2W, D], one a window position p of
-W..-1, 1..W.  A word's subword rows G_w are tests/plain_fasttext.py's
(`bind`, `center_subwords`): its own row, then one bucket row per n-gram
of `<word>`, duplicates kept.  Per center t, with m_{t,p} = 1 where |p| is
within the center's drawn window, both words are in the same sentence and
neither is padding, and n_t = sum_p m_{t,p}:

- x_w is the mean of w's quantized G_w rows (fastText's getWordVector);
- h_t = (1/n_t) sum_p m_{t,p} d_p * x_{w_{t+p}} (d not quantized);
- the center's output row, the positive, and its K draws (one equal to
  the center skipped) are scored against h_t; g = (label - sigma) * alpha;
- each output row gets g * h_t; e_t = sum g * q(v) is the gradient of
  h_t, added undivided (fastText's and word2vec.c's convention): every row
  of G_{w_{t+p}} gets m_{t,p} d_p * e_t, and d_p gets
  sum_t m_{t,p} e_t * x_{w_{t+p}}.

Word2Bits' contract on top: rows are quantized on read (`quantize`), the
gradient takes the table sigmoid (`sigmoid_lut`), the loss the exact one
(`sigmoid_exact`), and with reg each visit of a row subtracts
2*alpha*reg times the row (a row of G_w once per pair (t, p) that holds w,
the center's output row and each draw once) and the loss reg * |q|^2 of
each visit's rows; d takes no decay.  Departures, as in the port: public
`fasttext cbow` pools the window's subword ids into one mean and has no
position weights, this follows the 2018 papers; d starts at 1; a step is
a synchronous minibatch of B centers computed from the rows as they were
before it, not Hogwild per center; masked centers' draws are drawn and
masked, a draw equal to its center skipped, not redrawn; the updates of a
row are summed in float32 and added once a step.  The negatives of a step
are [B, K].

Imports torch and tests/plain_fasttext.py only: nothing of either
package, so it runs beside the card.  benchmark/fasttext_cbow.py holds the
same step (bit for bit, on the benchmark's shared pieces); the two are
held equal by benchmark/tests/test_bench_fasttext_cbow.py.
"""

from __future__ import annotations

import math

import torch

from tests.plain_fasttext import (EDGE_TOL, MAX_EXP, Bound, Rows, bind,
                                  center_subwords, quantize, sigmoid_exact,
                                  sigmoid_lut, store, word_vectors)

__all__ = ["Bound", "Rows", "bind", "chunk", "step", "table_step",
           "word_vectors"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 512              # centers a block: the [n, 2W, D] window rows


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
    B, W, D, bl = hp.batch, hp.window, hp.size, hp.bitlevel
    dev = rows.leaves[0].device
    a = torch.tensor(alpha * (2.0 if half else 1.0), dtype=torch.float32,
                     device=dev).to(compute)
    two_ar = 2.0 * a * hp.reg
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
        if hp.reg:
            in_sq = torch.zeros((n + 2 * W,), dtype=compute, device=dev)
            in_sq.index_add_(0, seg, (q_sub * q_sub).sum(dim=-1))
            ctx_sq = (m * torch.stack([in_sq[W + o:W + o + n]
                                       for o in offsets], dim=1)).sum(dim=1)
            rg = hp.reg * ((q_t * q_t).sum(dim=-1)
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
        if hp.reg:
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


def table_step(u: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
               slab_tokens, slab_sents, shrink, negs, alpha: float,
               hp: Bound, **kw):
    """`step` on whole tables u [V + buckets, D], v [V, D], d [2W, D]:
    returns (u, v, d, loss), new tables in the dtype of u."""
    rows = Rows([(torch.arange(t.shape[0], device=t.device), t)
                 for t in (u, v, d)], u.dtype)
    loss = step(rows, slab_tokens, slab_sents, shrink, negs, alpha, hp,
                **kw)
    return (*rows.leaves, loss)


def chunk(u: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
          tokens: torch.Tensor, sents: torch.Tensor, base0: int,
          shrinks: torch.Tensor, negs: torch.Tensor, alphas, hp: Bound):
    """S sequential steps on whole tables: step s takes the centers at
    tokens[base0 + s*B : base0 + (s+1)*B] and its slab of W words either
    side; shrinks [S, B], negs [S, B, K], alphas [S].  Returns (u, v, d,
    the float32 sum of the steps' losses)."""
    B, W = hp.batch, hp.window
    total = torch.zeros((), dtype=torch.float32, device=u.device)
    for s in range(shrinks.shape[0]):
        lo = base0 + s * B - W
        u, v, d, loss = table_step(u, v, d, tokens[lo:lo + B + 2 * W],
                                   sents[lo:lo + B + 2 * W], shrinks[s],
                                   negs[s], float(alphas[s]), hp)
        total = total + loss
    return u, v, d, total
