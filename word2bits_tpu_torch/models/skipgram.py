"""Skip-gram with negative sampling, virtually quantized, on split (u, v)
tables: the counterpart of the JAX package's models/skipgram.py.

The reference trains CBOW only; skip-gram is the JAX package's extension.
Per (center, context offset) pair the context word's input row predicts
the center against K negatives, with the CBOW path's contract: quantize on
read, the LUT-sigmoid gradient, the per-visit weight decay 2*alpha*reg,
negatives equal to the center skipped.  As in the CBOW slab step one
gather of the B+2W-position slab serves every pair: the pair rows are
shifted slices of the quantized slab, and the u update of every pair is
summed by slab position (2W shifted adds) into one scatter of B+2W rows.

Negatives are per center ([B, K]) or shared by strided tiles of G centers
with P pools ([B/G, P*K], `pool_mask`).  With `dense_hot` = (w_cold,
hot_w[H]) every pair is also scored against all H hot words with weight
hot_w[h] ([B*2W, H] products), its head update computed from the v rows as
they were before the step and added after the sampled scatters; the sampled
negatives are then cold-stratum draws offset by H, weighted by w_cold.

Every scatter adds rows rounded to the table dtype (ops/scatter.
scatter_add, or the block dedup `-dedup-block`), the v scatters centers
first, negatives
second; all compute is float32.  Skip-gram reaches no TPU kernel in the
JAX package, so none runs here.

Per-pair negatives (`-neg-per-pair 1`, the port's own route; the JAX
package has none): word2vec.c's skip-gram loop and arXiv 1310.4546 §2.2,
where every (center, context) pair draws its own K negatives.  A chunk
draws [S, B, 2W*K], pair-major (pair oi's K draws at lanes oi*K ..
oi*K+K-1); the step scores each pair against its own K rows, so it
gathers and updates 2W*K negative rows a center where the per-center
route takes K.  The v update is ONE scatter of B + B*2W*K rows (centers
first, then the pairs' negatives in lane order, the order the stable
sort keeps), the u update the same B+2W-row scatter as above: two sorted
scatters a step.  The [B*2W*K, D] float32 intermediates are whole (at
B 8192, W 5, K 15, D 300 each is 1.47 GB).  Departures from word2vec.c:
a step is a synchronous minibatch of B centers, not Hogwild per pair;
pairs masked (padding, a sentence boundary, outside the shrunk window)
draw negatives that are then masked rather than drawing none; the v
update of an id is summed in float32 and rounded once a step.

Spans (utils/trace.py, no-ops unless a profiler records): `chunk.draws`
around the chunk's draws; `step.gather`, `step.positive`,
`step.negative` and `step.scatter` in the step, on every route.
"""

from __future__ import annotations

from typing import Optional

import torch

from word2bits_tpu_torch.kernels.score_pallas import pool_mask
from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                             chunk_slabs, step_alphas)
from word2bits_tpu_torch.models.cbow_slab import (SlabInputs, _context_masks,
                                                  from_tiles, to_tiles)
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import scatter_add, scatter_add_dedup
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.sampling.unigram import (AliasTable, draw_cold,
                                                  draw_negatives)
from word2bits_tpu_torch.utils.trace import span


def _neg_terms(f: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor,
               reg_sq) -> tuple:
    """(gradient (0 - sigma_lut(f)) * alpha * m, loss sum) of negative
    scores f under the mask m; reg_sq broadcasts the reg * |q_v|^2 term."""
    g = (0.0 - sigmoid_lut(f)) * alpha * m
    loss = ((torch.log(sigmoid_exact(-f)) - reg_sq) * m).sum()
    return g, loss


def skipgram_slab_step(u: torch.Tensor, v: torch.Tensor, inputs: SlabInputs,
                       alpha, hyper: CBOWHyper, batch_size: int,
                       neg_sharing: int = 0, dedup_block: int = 0,
                       neg_pool: int = 1, dense_hot=None,
                       neg_per_pair: bool = False):
    """One synchronous skip-gram step over B consecutive centers on u and v
    IN PLACE; returns (u, v, loss) with loss a float32 0-d tensor.

    dense_hot = (w_cold, hot_w [H]): exact hot-stratum negatives per pair;
    inputs.neg_ids then holds cold draws (ids >= H) weighted by w_cold.
    neg_per_pair: inputs.neg_ids is [B, 2W*K], K draws for each pair."""
    B, W, D = batch_size, hyper.window, u.shape[1]
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    dev = u.device
    alpha = torch.as_tensor(alpha, dtype=dt, device=dev)

    def scat(tab, ids, rows):
        if dedup_block:
            scatter_add_dedup(tab, ids, rows.to(tab.dtype), dedup_block)
        else:
            scatter_add(tab, ids, rows)

    with span("step.gather"):
        slab_ids = inputs.slab_tokens.clamp_min(0)
        centers = slab_ids[W:W + B]
        u_slab = u[slab_ids].to(dt)                            # [B+2W, D]
        q_slab = quantize(u_slab, bl)
        offsets, mask, valid = _context_masks(inputs, B, W)
        mf = (mask & valid[:, None]).to(dt)                     # [B, 2W]
        # pair input rows as shifted slices: q_in[b, oi] = q_slab[W + b + o]
        q_in = torch.stack([q_slab[W + o:W + o + B] for o in offsets], dim=1)
    two_ar = 2.0 * alpha * reg

    # --- the positive (center) target of every pair ---
    with span("step.positive"):
        v_c = v[centers].to(dt)
        q_vc = quantize(v_c, bl)
        f_pos = torch.bmm(q_in, q_vc[:, :, None])[..., 0]       # [B, 2W]
        g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * mf
        if reg:
            pos_reg = reg * ((q_vc * q_vc).sum(dim=-1)[:, None]
                             + (q_in * q_in).sum(dim=-1))
        else:
            pos_reg = 0.0
        loss = ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * mf).sum()
        dv_center = torch.bmm(g_pos[:, None, :], q_in)[:, 0]    # [B, D]
        if reg:
            dv_center = dv_center - two_ar * v_c * mf.sum(dim=1)[:, None]
        din = g_pos[..., None] * q_vc[:, None, :]               # [B, 2W, D]

    with span("step.negative"):
        dv_hot = None
        if dense_hot is not None:
            hot_w = torch.as_tensor(dense_hot[1], dtype=dt, device=dev)
            H = hot_w.shape[0]
            v_h = v[:H].to(dt)                # the head before this step
            q_vh = quantize(v_h, bl)
            q_in2 = q_in.reshape(B * 2 * W, D)
            f_h = q_in2 @ q_vh.T                                # [B*2W, H]
            c_rep = centers[:, None].expand(B, 2 * W).reshape(-1)
            mh = ((torch.arange(H, device=dev)[None, :] != c_rep[:, None])
                  .to(dt) * mf.reshape(-1)[:, None] * hot_w[None, :])
            hot_reg = (reg * (q_vh * q_vh).sum(dim=-1)[None, :] if reg
                       else 0.0)
            g_h, hloss = _neg_terms(f_h, mh, alpha, hot_reg)
            del f_h                           # [B*2W, H]: keep g_h only
            loss = loss + hloss
            hot_visits = mh.sum(dim=0) if reg else None
            del mh
            din = din + (g_h @ q_vh).reshape(B, 2 * W, D)
            dv_hot = g_h.T @ q_in2                              # [H, D]
            del g_h
            if reg:
                dv_hot = dv_hot - two_ar * v_h * hot_visits[:, None]

        w_cold = (torch.tensor(dense_hot[0], dtype=dt, device=dev)
                  if dense_hot is not None else None)
        negs = inputs.neg_ids
        v_n = v[negs].to(dt)
        q_vn = quantize(v_n, bl)
        if neg_per_pair:
            v_rows, din, nloss = _pair_negative_phase(
                q_in, q_vn, v_n if reg else None, negs,
                centers[:, None, None], mf, dv_center, din, alpha, reg)
            loss = loss + nloss
        elif neg_sharing:
            G = neg_sharing
            if B % G:
                raise ValueError(f"batch {B} not divisible by neg tile {G}")
            T = B // G
            P = neg_pool if neg_pool and neg_pool > 1 else 1
            PK = negs.shape[1]                                 # [T, P*K]
            q_in4 = to_tiles(q_in, T, G).reshape(T, G * 2 * W, D)
            f_neg = torch.bmm(q_in4, q_vn.transpose(1, 2)).reshape(
                T, G, 2 * W, PK)
            eligible = (negs[:, None, :]
                        != to_tiles(centers, T, G)[:, :, None]).to(dt)
            if P > 1:
                eligible = eligible * pool_mask(G, PK // P, P, dt, dev)[None]
            m4 = to_tiles(mf, T, G)[..., None] * eligible[:, :, None, :]
            if w_cold is not None:
                m4 = m4 * w_cold
            vn_reg = (reg * (q_vn * q_vn).sum(dim=-1)[:, None, None, :]
                      if reg else 0.0)
            g_neg, nloss = _neg_terms(f_neg, m4, alpha, vn_reg)
            loss = loss + nloss
            g2 = g_neg.reshape(T, G * 2 * W, PK)
            dv_neg = torch.bmm(g2.transpose(1, 2), q_in4)       # [T, PK, D]
            if reg:
                dv_neg = dv_neg - two_ar * v_n * m4.sum(dim=(1, 2))[..., None]
            din = din + from_tiles(
                torch.bmm(g2, q_vn).reshape(T, G, 2 * W, D), B)
        else:
            f_neg = torch.bmm(q_in, q_vn.transpose(1, 2))       # [B, 2W, K]
            m3 = (mf[..., None]
                  * (negs != centers[:, None])[:, None, :].to(dt))
            if w_cold is not None:
                m3 = m3 * w_cold
            vn_reg = (reg * (q_vn * q_vn).sum(dim=-1)[:, None, :] if reg
                      else 0.0)
            g_neg, nloss = _neg_terms(f_neg, m3, alpha, vn_reg)
            loss = loss + nloss
            dv_neg = torch.bmm(g_neg.transpose(1, 2), q_in)     # [B, K, D]
            if reg:
                dv_neg = dv_neg - two_ar * v_n * m3.sum(dim=1)[..., None]
            din = din + torch.bmm(g_neg, q_vn)
        del v_n, q_vn

    with span("step.scatter"):
        if neg_per_pair:
            # ONE v scatter: the centers, then every pair's negatives
            scat(v, torch.cat([centers, negs.reshape(-1)]), v_rows)
        else:
            scat(v, centers, dv_center)
            scat(v, negs.reshape(-1), dv_neg.reshape(-1, D))
        if dv_hot is not None:
            H = dv_hot.shape[0]
            v[:H] = (v[:H].to(dt) + dv_hot).to(v.dtype)

        # --- u updates, summed by slab position from the 2W shifted pairs
        din = din * mf[..., None]
        if reg:
            u_in = torch.stack([u_slab[W + o:W + o + B] for o in offsets],
                               dim=1)
            din = din - two_ar * u_in * mf[..., None]
        du_slab = torch.zeros((B + 2 * W, D), dtype=dt, device=dev)
        for oi, o in enumerate(offsets):
            du_slab[W + o:W + o + B] += din[:, oi]
        scat(u, slab_ids, du_slab)
    return u, v, loss


def _pair_negative_phase(q_in, q_vn, v_n, negs, skip, mf, dv_first,
                         din, alpha, reg):
    """The per-pair negative phase: pair (b, oi) against its own K rows
    (lanes oi*K .. oi*K+K-1 of negs [B, 2W*K]; q_vn [B, 2W*K, D] their
    quantized rows, v_n the rows themselves where reg is on), a draw equal
    to `skip` (broadcast to [B, 2W, K]: the pair's positive target)
    masked.  q_in is each pair's input row [B, 2W, D], or one input row a
    center [B, 1, D] that its pairs share (the subword model's hidden
    vector); din has q_in's shape.  Returns (v_rows [n0 + B*2W*K, D]:
    dv_first [n0, D] then the negatives' v update, din plus the
    negatives' input gradients, the negatives' loss)."""
    B, W2 = mf.shape
    D = q_in.shape[-1]
    K = negs.shape[1] // W2
    n_in = q_in.shape[1]
    L = W2 * K // n_in                    # the draws an input row scores
    q_vnb = q_vn.reshape(B * n_in, L, D)
    f_neg = torch.bmm(q_vnb, q_in.reshape(B * n_in, D, 1)).reshape(B, W2, K)
    m3 = mf[..., None] * (negs.reshape(B, W2, K) != skip).to(mf.dtype)
    vn_reg = (reg * (q_vn * q_vn).sum(dim=-1).reshape(B, W2, K) if reg
              else 0.0)
    g_neg, nloss = _neg_terms(f_neg, m3, alpha, vn_reg)
    din = din + torch.bmm(g_neg.reshape(B * n_in, 1, L),
                          q_vnb).reshape(B, n_in, D)
    # the v rows of the one v scatter, the negatives' written in place
    n0 = dv_first.shape[0]
    v_rows = torch.empty((n0 + B * W2 * K, D), dtype=q_in.dtype,
                         device=q_in.device)
    v_rows[:n0] = dv_first
    dv_neg = v_rows[n0:].view(B, W2, K, D)
    torch.mul(g_neg[..., None], q_in[:, :, None, :], out=dv_neg)
    if reg:
        two_ar = 2.0 * alpha * reg
        dv_neg -= two_ar * v_n.reshape(B, W2, K, D) * m3[..., None]
    return v_rows, din, nloss


def make_skipgram_train_chunk(hyper: CBOWHyper, vocab_size: int,
                              batch_size: int, steps: int,
                              neg_sharing: int = 0, dedup_block: int = 0,
                              neg_pool: int = 1, hot_rows: int = 0,
                              dense_hot=None, neg_per_pair: bool = False):
    """chunk(u, v, tokens, sent_ids, atab, scalars, gen=None, n_steps=None,
    shrinks=None, negs=None) -> (u, v, loss_sum), the CBOW slab chunk's
    signature with the skip-gram step.

    The shrinks [S, B] and negatives ([S, B, K] per-center, [S, B/G, P*K]
    shared, [S, B, 2W*K] per pair) of the n_steps (default `steps`) steps
    are drawn from `gen` at chunk entry unless injected.  dense_hot = (kc,
    w_cold, hot_w [H]) with hot_rows = H: `atab` is the cold stratum's
    alias table, and kc cold lanes a pool are drawn and offset by H.  At
    steps == 1 (the JAX package's no-scan path) the chunk is one step."""
    B, W, K = batch_size, hyper.window, hyper.negative
    if neg_sharing and B % neg_sharing:
        raise ValueError(f"neg_sharing ({neg_sharing}) must divide "
                         f"batch_size ({B})")
    if dense_hot is not None and not hot_rows:
        raise ValueError("dense_hot requires hot_rows (the hot-stratum "
                         "boundary)")
    if neg_per_pair and (neg_sharing or dedup_block
                         or dense_hot is not None):
        raise ValueError("neg_per_pair draws each pair's own negatives "
                         "and scatters them whole: no neg_sharing, "
                         "dedup_block or dense_hot")
    P = neg_pool if (neg_sharing and neg_pool and neg_pool > 1) else 1
    neg_rows = B // neg_sharing if neg_sharing else B
    lanes = P * (dense_hot[0] if dense_hot is not None else K)
    if neg_per_pair:
        lanes = 2 * W * K
    step_dense = None if dense_hot is None else (dense_hot[1], dense_hot[2])

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
                if dense_hot is not None:
                    negs = draw_cold(gen, atab, (S, neg_rows, lanes),
                                     hot_rows)
                else:
                    negs = draw_negatives(gen, atab, (S, neg_rows, lanes),
                                          vocab_size)
        alphas = step_alphas(scalars, S, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            inputs = SlabInputs(slab_tokens=slab_tokens[s],
                                slab_sents=slab_sents[s],
                                shrink=shrinks[s], neg_ids=negs[s])
            with span("step"):
                u, v, step_loss = skipgram_slab_step(
                    u, v, inputs, alphas[s], hyper, B, neg_sharing,
                    dedup_block=dedup_block, neg_pool=P,
                    dense_hot=step_dense, neg_per_pair=neg_per_pair)
                loss = loss + step_loss
        return u, v, loss

    return chunk
