"""fastText's subword skip-gram (`-model fasttext`; Bojanowski et al. 2017,
arXiv 1607.04606, the `fasttext skipgram` command), virtually quantized,
on split tables: input rows u [V + buckets, D] (the words, then the
n-gram buckets) and output rows v [V, D].

Per center b of a step, G_b is the center word's subword rows
(data/vocab.subword_rows: its own row and one bucket row per n-gram of
`<word>`, duplicates kept) and its hidden vector h_b is the mean of the
quantized rows of G_b (fastText's computeHidden), the ragged gather-mean
of kernels/subword_mean.py.  fastText turns word2vec's pair around: each
unmasked pair (b, context c) scores the quantized output row of c, the
positive, and the pair's own K draws (lanes oi*K .. oi*K+K-1 of the
step's [B, 2W*K] draws, as the per-pair skip-gram route draws them; a
draw equal to c skipped) against h_b.  The output rows get g * h_b, one
scatter of the B+2W slab rows' updates (each context's, summed by slab
position from the 2W shifted pairs) then the negatives' rows, through
models/skipgram.py's per-pair negative phase; g_b, the gradient for h_b
summed over b's pairs, is added whole to every row of G_b (a duplicate
twice), not divided by |G_b|: fastText divides only in its supervised
model.

The port's contract, as the other models: rows quantized on read, the
table sigmoid in the gradient and the exact one in the loss, float32
compute, each row's updates summed in float32 and added once a step
(ops/scatter.scatter_add: a stable sort, then kernel 2, on the card), and
with reg each visit of a row subtracts 2*alpha*reg times the row (a row of
G_b is visited once per pair of b) and the loss reg * |q|^2 of the
pair's rows (G_b's once per pair).  Departures from fastText:

- a step is a synchronous minibatch of B centers, every pair computed
  from the rows as they were before the step, not Hogwild updates per
  pair;
- pairs masked (padding, a sentence boundary, outside the shrunk window)
  have their draws masked rather than left undrawn, and a draw equal to
  its pair's target is skipped, not drawn again;
- bitlevel 1 by default, as the port's other models (fastText trains
  full precision: -bitlevel 0);
- the ragged rows of a step are bounded by B * max |G_w|, the CSR's
  longest word, known before the epoch: the G_w scatter takes B * max
  |G_w| ids, those past a center's |G_b| and those of centers with no
  unmasked pair the drop sentinel, so no step asks the device its size.

Spans (utils/trace.py): `chunk.draws`; in the step `step.gather` (the
slab's output rows and masks), `step.subword` (the gather-mean),
`step.positive`, `step.negative`, `step.scatter` (the output rows) and
`step.subword_scatter` (the rows of every G_b).
"""

from __future__ import annotations

from typing import Optional

import torch

from word2bits_tpu_torch.data.vocab import Subwords
from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
from word2bits_tpu_torch.kernels.subword_mean import subword_mean
from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                             chunk_slabs, step_alphas)
from word2bits_tpu_torch.models.cbow_slab import SlabInputs, _context_masks
from word2bits_tpu_torch.models.skipgram import _pair_negative_phase
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import scatter_add
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.sampling.unigram import AliasTable, draw_negatives
from word2bits_tpu_torch.utils.trace import span


def subword_ids(sub: Subwords, centers: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """int32 [B, max |G_w|]: the rows of each center's G_w in the CSR's
    order, the drop sentinel past its end and for centers not `live`."""
    start = sub.offsets[centers]
    lens = sub.offsets[centers + 1] - start
    j = torch.arange(sub.max_len, device=centers.device)
    pos = (start[:, None] + j).clamp(max=max(sub.ids.numel() - 1, 0))
    keep = (j[None, :] < lens[:, None]) & live[:, None]
    return torch.where(keep, sub.ids[pos], SENTINEL)


def subword_step(u: torch.Tensor, v: torch.Tensor, inputs: SlabInputs,
                 alpha, hyper: CBOWHyper, batch_size: int, sub: Subwords):
    """One synchronous subword skip-gram step over B consecutive centers
    on u [V + buckets, D] and v [V, D] IN PLACE; inputs.neg_ids [B, 2W*K]
    holds K draws for each pair.  Returns (u, v, loss), loss a float32
    0-d tensor."""
    B, W = batch_size, hyper.window
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    alpha = torch.as_tensor(alpha, dtype=dt, device=u.device)
    two_ar = 2.0 * alpha * reg

    with span("step.gather"):
        slab_ids = inputs.slab_tokens.clamp_min(0).long()
        centers = slab_ids[W:W + B]
        offsets, mask, valid = _context_masks(inputs, B, W)
        mf = (mask & valid[:, None]).to(dt)                     # [B, 2W]
        v_slab = v[slab_ids].to(dt)                       # the targets
        q_slab = quantize(v_slab, bl)
        q_ctx = torch.stack([q_slab[W + o:W + o + B] for o in offsets],
                            dim=1)                              # [B, 2W, D]
        ctx = torch.stack([slab_ids[W + o:W + o + B] for o in offsets],
                          dim=1)                                # [B, 2W]
    with span("step.subword"):
        h = subword_mean(u, centers, sub, bl)                   # [B, D]
        g_ids = None
        if reg:
            g_ids = subword_ids(sub, centers, mf.sum(dim=1) > 0)
            live = g_ids != SENTINEL
            u_g = u[torch.where(live, g_ids, 0).long()].to(dt)  # [B, G, D]
            q_g = quantize(u_g, bl)
            in_sq = ((q_g * q_g).sum(dim=-1) * live).sum(dim=1)

    with span("step.positive"):
        f_pos = torch.bmm(q_ctx, h[:, :, None])[..., 0]         # [B, 2W]
        g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * mf
        pos_reg = (reg * ((q_ctx * q_ctx).sum(dim=-1) + in_sq[:, None])
                   if reg else 0.0)
        loss = ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * mf).sum()
        # each context's v update, summed by slab position
        dv_slab = torch.zeros_like(v_slab)
        for oi, o in enumerate(offsets):
            dv_slab[W + o:W + o + B] += g_pos[:, oi, None] * h
        if reg:
            visits = torch.zeros((B + 2 * W,), dtype=dt, device=u.device)
            for oi, o in enumerate(offsets):
                visits[W + o:W + o + B] += mf[:, oi]
            dv_slab -= two_ar * v_slab * visits[:, None]
        din = torch.bmm(g_pos[:, None, :], q_ctx)               # [B, 1, D]

    with span("step.negative"):
        negs = inputs.neg_ids
        v_n = v[negs].to(dt)
        q_vn = quantize(v_n, bl)
        v_rows, din, nloss = _pair_negative_phase(
            h[:, None, :], q_vn, v_n if reg else None, negs, ctx[..., None],
            mf, dv_slab, din, alpha, reg)
        loss = loss + nloss
        del v_n, q_vn

    with span("step.scatter"):
        # ONE v scatter: the slab's context rows, then every pair's draws
        scatter_add(v, torch.cat([slab_ids, negs.reshape(-1)]), v_rows)
    with span("step.subword_scatter"):
        if g_ids is None:
            g_ids = subword_ids(sub, centers, mf.sum(dim=1) > 0)
        G = g_ids.shape[1]
        du = din.expand(B, G, din.shape[-1])
        if reg:
            du = du - two_ar * mf.sum(dim=1)[:, None, None] * u_g
        scatter_add(u, g_ids.reshape(-1), du.reshape(B * G, -1))
    return u, v, loss


def make_subword_train_chunk(hyper: CBOWHyper, vocab_size: int,
                             batch_size: int, steps: int, sub: Subwords):
    """chunk(u, v, tokens, sent_ids, atab, scalars, gen=None, n_steps=None,
    shrinks=None, negs=None) -> (u, v, loss_sum), the skip-gram chunk's
    signature with the subword step.  The shrinks [S, B] and the per-pair
    draws [S, B, 2W*K] of the n_steps (default `steps`) steps are drawn
    from `gen` at chunk entry unless injected."""
    B, W, K = batch_size, hyper.window, hyper.negative

    def chunk(u: torch.Tensor, v: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor, atab: AliasTable,
              scalars: ChunkScalars, gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = u.device
        S = steps if n_steps is None else n_steps
        slab_tokens, slab_sents = chunk_slabs(tokens, sent_ids,
                                              scalars.base0, S, B, W)
        with span("chunk.draws"):
            if shrinks is None:
                shrinks = torch.randint(0, W, (S, B), generator=gen,
                                        device=dev)
            if negs is None:
                negs = draw_negatives(gen, atab, (S, B, 2 * W * K),
                                      vocab_size)
        alphas = step_alphas(scalars, S, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            with span("step"):
                u, v, step_loss = subword_step(u, v, inputs, alphas[s],
                                               hyper, B, sub)
                loss = loss + step_loss
        return u, v, loss

    return chunk
