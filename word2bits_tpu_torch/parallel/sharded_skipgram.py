"""Vocab-sharded and data-parallel skip-gram step (mirrors sharded_slab.py).

The counterpart of the JAX package's parallel/sharded_skipgram.py: the
same mesh and collectives as the CBOW sharded step (u, v split by rows
over "vocab", inputs replicated, rows fetched by a masked local gather
plus a psum over "vocab", per-shard float32 deltas psum'd over "data")
around models/skipgram.py's math: per (center, offset) pair the context
word's input row scores against the center and the per-center or
tile-shared negatives.  Tables are updated in place.
"""

from __future__ import annotations

import torch

from word2bits_tpu_torch.kernels.score_pallas import pool_mask
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.models.cbow_slab import (_context_masks, from_tiles,
                                                  to_tiles)
from word2bits_tpu_torch.models.skipgram import _neg_terms
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.parallel.mesh import (DATA_AXIS, VOCAB_AXIS,
                                               Collectives)
from word2bits_tpu_torch.parallel.sharded import _gather_rows, _scatter_delta
from word2bits_tpu_torch.parallel.sharded_slab import (check_sharded,
                                                       hot_shard, my_slab)


def _sharded_skipgram_body(comm: Collectives, u_local, v_local, slab_tokens,
                           slab_sents, shrink, negs, alpha,
                           hyper: CBOWHyper, B_global: int, neg_sharing: int,
                           vocab_shard_size: int, neg_pool: int = 1,
                           dense_hot=None, hot_layout=None):
    """One sharded skip-gram step on this shard's tables, IN PLACE;
    returns (u_local, v_local, loss summed over "data").

    dense_hot = (w_cold, hot_w [H]): exact hot-stratum negatives per pair,
    local to each vocab shard as in the sharded slab body (one [B*2W, D]
    psum over "vocab" for the pairs' gradient term); hot_layout: the
    balanced placement (parallel/layout.py)."""
    W, D = hyper.window, u_local.shape[1]
    bl, reg = hyper.bitlevel, hyper.reg
    dt = torch.float32
    Vs = u_local.shape[0]
    dev = u_local.device
    if hot_layout is not None and dense_hot is None:
        raise ValueError("hot_layout requires dense_hot")
    nd, di = comm.axis_size(DATA_AXIS), comm.axis_index(DATA_AXIS)
    B = B_global // nd
    inputs = my_slab(comm, slab_tokens, slab_sents, shrink, negs, B_global,
                     W, neg_sharing)
    my_negs = inputs.neg_ids
    slab_ids = inputs.slab_tokens.clamp_min(0)
    centers = slab_ids[W:W + B]
    alpha = torch.as_tensor(alpha, dtype=dt, device=dev)

    def gat(tab, ids):
        return _gather_rows(comm, tab, ids, vocab_shard_size, hot_layout)

    def scat(ids, rows):
        return _scatter_delta(comm, ids, rows,
                              torch.ones_like(ids, dtype=bool),
                              vocab_shard_size, (Vs, D), hot_layout)

    # every row exchange first (independent psums over "vocab")
    u_slab = gat(u_local, slab_ids)
    v_c = gat(v_local, centers)
    v_n = gat(v_local, my_negs)
    q_slab = quantize(u_slab, bl)

    offsets, mask, valid = _context_masks(inputs, B, W)
    mf = mask.to(dt)
    q_in = torch.stack([q_slab[W + o:W + o + B] for o in offsets], dim=1)
    two_ar = 2.0 * alpha * reg

    q_vc = quantize(v_c, bl)
    f_pos = torch.bmm(q_in, q_vc[:, :, None])[..., 0]            # [B, 2W]
    g_pos = (1.0 - sigmoid_lut(f_pos)) * alpha * mf
    pos_reg = (reg * ((q_vc * q_vc).sum(dim=-1)[:, None]
                      + (q_in * q_in).sum(dim=-1))) if reg else 0.0
    loss = ((torch.log(sigmoid_exact(f_pos)) - pos_reg) * mf).sum()
    dv_center = torch.bmm(g_pos[:, None, :], q_in)[:, 0]
    if reg:
        dv_center = dv_center - two_ar * v_c * mf.sum(dim=1)[:, None]
    din = g_pos[..., None] * q_vc[:, None, :]                    # [B, 2W, D]

    weight = None if dense_hot is None else float(dense_hot[0])
    q_vn = quantize(v_n, bl)
    if neg_sharing:
        T = B_global // neg_sharing
        G_local = B // T
        P = neg_pool if neg_pool and neg_pool > 1 else 1
        PK = my_negs.shape[-1]
        q_in4 = to_tiles(q_in, T, G_local).reshape(T, G_local * 2 * W, D)
        f_neg = torch.bmm(q_in4, q_vn.transpose(1, 2)).reshape(
            T, G_local, 2 * W, PK)
        eligible = (my_negs[:, None, :]
                    != to_tiles(centers, T, G_local)[:, :, None]).to(dt)
        if P > 1:
            # the shard's members start at di * G_local of each tile
            eligible = eligible * pool_mask(G_local, PK // P, P, dt, dev,
                                            di * G_local)[None]
        m4 = to_tiles(mf, T, G_local)[..., None] * eligible[:, :, None, :]
        if weight is not None:
            m4 = m4 * weight
        vn_reg = ((reg * (q_vn * q_vn).sum(dim=-1))[:, None, None, :]
                  if reg else 0.0)
        g_neg, nloss = _neg_terms(f_neg, m4, alpha, vn_reg)
        g2 = g_neg.reshape(T, G_local * 2 * W, PK)
        dv_neg = torch.bmm(g2.transpose(1, 2), q_in4)           # [T, PK, D]
        if reg:
            dv_neg = dv_neg - two_ar * v_n * m4.sum(dim=(1, 2))[..., None]
        din = din + from_tiles(
            torch.bmm(g2, q_vn).reshape(T, G_local, 2 * W, D), B)
    else:
        f_neg = torch.bmm(q_in, q_vn.transpose(1, 2))           # [B, 2W, K]
        m3 = mf[..., None] * (my_negs != centers[:, None])[:, None, :].to(dt)
        if weight is not None:
            m3 = m3 * weight
        vn_reg = ((reg * (q_vn * q_vn).sum(dim=-1))[:, None, :]
                  if reg else 0.0)
        g_neg, nloss = _neg_terms(f_neg, m3, alpha, vn_reg)
        dv_neg = torch.bmm(g_neg.transpose(1, 2), q_in)         # [B, K, D]
        if reg:
            dv_neg = dv_neg - two_ar * v_n * m3.sum(dim=1)[..., None]
        din = din + torch.bmm(g_neg, q_vn)
    loss = loss + nloss

    dv_hot = None
    if dense_hot is not None:
        hot_w = torch.as_tensor(dense_hot[1], dtype=dt, device=dev)
        gidx, w_loc, v_h = hot_shard(comm, v_local, hot_w, hot_layout)
        q_vh = quantize(v_h, bl)
        q_in2 = q_in.reshape(B * 2 * W, D)
        f_h = q_in2 @ q_vh.T                                    # [B*2W, Hs]
        c_rep = centers[:, None].expand(B, 2 * W).reshape(-1)
        mh = ((gidx[None, :] != c_rep[:, None]).to(dt)
              * mf.reshape(-1)[:, None] * w_loc[None, :])
        hot_reg = (reg * (q_vh * q_vh).sum(dim=-1))[None, :] if reg else 0.0
        g_h, hot_loss = _neg_terms(f_h, mh, alpha, hot_reg)
        loss = loss + comm.psum(hot_loss, VOCAB_AXIS)
        din = din + comm.psum(g_h @ q_vh, VOCAB_AXIS).reshape(B, 2 * W, D)
        dv_hot = g_h.T @ q_in2
        if reg:
            dv_hot = dv_hot - two_ar * v_h * mh.sum(dim=0)[:, None]

    # u updates, summed by slab position from the 2W shifted pairs
    din = din * mf[..., None]
    if reg:
        u_in = torch.stack([u_slab[W + o:W + o + B] for o in offsets], dim=1)
        din = din - two_ar * u_in * mf[..., None]
    du_slab = torch.zeros((B + 2 * W, D), dtype=dt, device=dev)
    for oi, o in enumerate(offsets):
        du_slab[W + o:W + o + B] += din[:, oi]

    delta_v = scat(centers, dv_center) + scat(my_negs.reshape(-1),
                                              dv_neg.reshape(-1, D))
    if dv_hot is not None:
        delta_v[:dv_hot.shape[0]] += dv_hot
    delta_u = scat(slab_ids, du_slab)
    delta_v = comm.psum(delta_v, DATA_AXIS)
    delta_u = comm.psum(delta_u, DATA_AXIS)
    loss = comm.psum(loss, DATA_AXIS)
    u_local.add_(delta_u.to(u_local.dtype))
    v_local.add_(delta_v.to(v_local.dtype))
    return u_local, v_local, loss


def make_sharded_skipgram_step(hyper: CBOWHyper, mesh,
                               vocab_size_padded: int, batch_size: int,
                               neg_sharing: int = 0, neg_pool: int = 1):
    """The make_sharded_slab_step contract with the skip-gram objective."""
    vss = check_sharded(mesh, batch_size, vocab_size_padded, neg_sharing)

    def step(comm: Collectives, u_local, v_local, slab_tokens, slab_sents,
             shrink, negs, alpha):
        u_local, v_local, loss = _sharded_skipgram_body(
            comm, u_local, v_local, slab_tokens, slab_sents, shrink, negs,
            alpha, hyper, batch_size, neg_sharing, vss, neg_pool=neg_pool)
        return u_local, v_local, comm.psum(loss, VOCAB_AXIS) / mesh.nv

    return step
