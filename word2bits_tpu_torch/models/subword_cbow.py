"""fastText's CBOW with position weights and subwords (`-model
fasttext-cbow`; Grave et al. 2018, arXiv 1802.06893, §3, the recipe of
the published cc.<lang>.300 vectors; Mikolov et al. 2018, arXiv
1712.09405, §2.2-2.3), virtually quantized, on split tables: input rows u
[V + buckets, D] (the words, then the n-gram buckets), output rows v
[V, D] and the position weights d [2W, D], float32, one a window position
p of P = {-W..-1, 1..W}.

Per center t of a step, with m_{t,p} = 1 where |p| is within the center's
drawn window, both words are in the same sentence and neither is padding
(models/cbow_slab._context_masks), and n_t = sum_p m_{t,p}:

  x_w  = (1/|G_w|) sum_{g in G_w} q(u_g)   (kernel 11 over the slab's
         B + 2W words: G_w the word's own row and one bucket row per
         n-gram of `<word>`, duplicates kept, data/vocab.subword_rows)
  h_t  = (1/n_t) sum_p m_{t,p} d_p * x_{w_{t+p}}   (kernel 12's forward)
  f_0  = h_t . q(v_{w_t}),  f_k = h_t . q(v_{n_k})  (K draws per center
         from count^0.5, one equal to w_t skipped)
  g_0  = alpha (1 - sigma(f_0)),  g_k = -alpha sigma(f_k),
  e_t  = sum_k g_k q(v_k); each output row k gets g_k h_t;
  every row of G_{w_{t+p}} gets m_{t,p} d_p * e_t, and d_p gets
  sum_t m_{t,p} e_t * x_{w_{t+p}}   (kernel 12's backward)

The hidden vector's gradient is added undivided, fastText's and
word2vec.c's convention.  The port's contract, as the other models: rows
quantized on read (d is not quantized), the table sigmoid in the gradient
and the exact one in the loss, float32 compute, each row's updates summed
in float32 and added once a step (ops/scatter.scatter_add: a stable sort,
then kernel 2, on the card; d by one add), and with reg each visit of a
row subtracts 2*alpha*reg times the row (a row of G_w is visited once a
pair (t, p) that holds w, the center's output row once, each draw once),
the loss reg * |q|^2 of each visit's rows; d takes no decay.  Departures:

- public `fasttext cbow` pools the subword ids of the whole window into
  one mean and has no position weights; this follows the 2018 papers:
  each context word's fastText vector x_w, weighted by d_p, averaged over
  n_t as the port's CBOW averages;
- d starts at 1 and is not quantized (both papers leave this open);
- a step is a synchronous minibatch of B centers, every term computed
  from the rows as they were before the step, not Hogwild per center;
- masked centers' draws are masked, a draw equal to its center skipped,
  not drawn again;
- bitlevel 1 by default (fastText trains full precision: -bitlevel 0);
- the G_w scatter takes (B + 2W) * max |G_w| ids, the CSR's longest word
  known before the epoch, those past a word's |G_w| and those of slab
  words no pair holds the drop sentinel, so no step asks the device its
  size.

Spans (utils/trace.py): `chunk.draws`; in the step `step.gather` (the
masks and the centers' output rows), `step.subword` (kernel 11 over the
slab), `step.pos_context` (kernel 12's forward), `step.positive`,
`step.negative`, `step.pos_context_grad` (kernel 12's backward and d's
add), `step.scatter` (the output rows) and `step.subword_scatter` (the
rows of every G_w).
"""

from __future__ import annotations

from typing import Optional

import torch

from word2bits_tpu_torch.data.vocab import Subwords
from word2bits_tpu_torch.kernels.pos_context import (pos_context,
                                                     pos_context_grad)
from word2bits_tpu_torch.kernels.span_scatter import SENTINEL
from word2bits_tpu_torch.kernels.subword_mean import subword_mean
from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                             chunk_slabs, step_alphas)
from word2bits_tpu_torch.models.cbow_slab import (SlabInputs,
                                                  _context_masks,
                                                  per_center_negative_phase)
from word2bits_tpu_torch.models.subword import subword_ids
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import scatter_add
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.sampling.unigram import AliasTable, draw_negatives
from word2bits_tpu_torch.utils.trace import span


def subword_cbow_step(u: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
                      inputs: SlabInputs, alpha, hyper: CBOWHyper,
                      batch_size: int, sub: Subwords):
    """One synchronous step over B consecutive centers on u [V + buckets,
    D], v [V, D] and d [2W, D] IN PLACE; inputs.neg_ids [B, K] holds each
    center's K draws.  Returns (u, v, d, loss), loss a float32 0-d
    tensor."""
    B, W = batch_size, hyper.window
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    alpha = torch.as_tensor(alpha, dtype=dt, device=u.device)
    two_ar = 2.0 * alpha * reg

    with span("step.gather"):
        slab_ids = inputs.slab_tokens.clamp_min(0).long()
        N = slab_ids.numel()
        centers = slab_ids[W:W + B]
        offsets, mask, _ = _context_masks(inputs, B, W)
        mf = mask.to(dt)                                        # [B, 2W]
        af = (mf.sum(dim=1) > 0).to(dt)
        # the pairs (t, p) that hold each slab position: its visits
        visits = torch.zeros((N,), dtype=dt, device=u.device)
        for p, o in enumerate(offsets):
            visits[W + o:W + o + B] += mf[:, p]
        v_c = v[centers].to(dt)
        q_vc = quantize(v_c, bl)
    with span("step.subword"):
        x = subword_mean(u, slab_ids, sub, bl)                  # [N, D]
        g_ids = subword_ids(sub, slab_ids, visits > 0)          # [N, G]
        if reg:
            live = g_ids != SENTINEL
            u_g = u[torch.where(live, g_ids, 0).long()].to(dt)  # [N, G, D]
            q_g = quantize(u_g, bl)
            in_sq = ((q_g * q_g).sum(dim=-1) * live).sum(dim=1)
    with span("step.pos_context"):
        h = pos_context(x, d, mf, W)                            # [B, D]

    with span("step.positive"):
        f_pos = (h * q_vc).sum(dim=-1)
        g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * af
        pos_reg = reg * (q_vc * q_vc).sum(dim=-1) if reg else 0.0
        loss = ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * af).sum()
        if reg:
            loss = loss - reg * (visits * in_sq).sum()
        e = g_pos[:, None] * q_vc
        dv_center = g_pos[:, None] * h
        if reg:
            dv_center = dv_center - two_ar * v_c * af[:, None]

    with span("step.negative"):
        negs = inputs.neg_ids
        v_n = v[negs].to(dt)                                    # [B, K, D]
        g_neg, m2, e_neg, nloss = per_center_negative_phase(
            h, af, centers, negs, v_n, alpha, hyper)
        loss = loss + nloss
        e = e + e_neg
        dv_neg = g_neg[..., None] * h[:, None, :]
        if reg:
            dv_neg = dv_neg - two_ar * v_n * m2[..., None]
        del v_n

    with span("step.pos_context_grad"):
        dx, dd = pos_context_grad(e, x, d, mf, W)
        d.add_(dd)
    with span("step.scatter"):
        # ONE v scatter: the centers' rows, then every center's draws
        scatter_add(v, torch.cat([centers, negs.reshape(-1)]),
                    torch.cat([dv_center, dv_neg.reshape(-1, dx.shape[1])]))
    with span("step.subword_scatter"):
        G = g_ids.shape[1]
        du = dx[:, None, :].expand(N, G, dx.shape[1])
        if reg:
            du = du - two_ar * visits[:, None, None] * u_g
        scatter_add(u, g_ids.reshape(-1), du.reshape(N * G, -1))
    return u, v, d, loss


def make_subword_cbow_train_chunk(hyper: CBOWHyper, vocab_size: int,
                                  batch_size: int, steps: int,
                                  sub: Subwords):
    """chunk(u, v, d, tokens, sent_ids, atab, scalars, gen=None,
    n_steps=None, shrinks=None, negs=None) -> (u, v, d, loss_sum): the
    slab chunk's signature with the third table.  The shrinks [S, B] and
    the per-center draws [S, B, K] of the n_steps (default `steps`) steps
    are drawn from `gen` at chunk entry unless injected."""
    B, W, K = batch_size, hyper.window, hyper.negative

    def chunk(u: torch.Tensor, v: torch.Tensor, d: torch.Tensor,
              tokens: torch.Tensor, sent_ids: torch.Tensor, atab: AliasTable,
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
                negs = draw_negatives(gen, atab, (S, B, K), vocab_size)
        alphas = step_alphas(scalars, S, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            with span("step"):
                u, v, d, step_loss = subword_cbow_step(
                    u, v, d, inputs, alphas[s], hyper, B, sub)
                loss = loss + step_loss
        return u, v, d, loss

    return chunk
