"""Sharded chunk: S synchronous sharded steps per call.

The counterpart of the JAX package's parallel/chunk.py, and the mesh form
of models/cbow_slab.make_slab_train_chunk: one call runs S steps of a
sharded body (parallel/sharded_slab.py or parallel/sharded_skipgram.py)
on this shard's tables with the linear LR schedule, and returns the
chunk's loss on the device, so the host never syncs inside a chunk.

Randomness: every rank holds a torch.Generator seeded the same, on the
same device type, and draws the GLOBAL [S, B] window shrinks and then the
global negatives in make_slab_train_chunk's order and shapes.  So every
shard draws the same numbers without a collective, and a sharded chunk
equals the single-device slab chunk on the same seed up to summation
order (as the JAX chunk equals its own).  Shrinks and negatives can be
injected instead, as in the single-device chunk.

With the span scatter the plans of every step are built here, once per
chunk, on local ids: the update id lists after the all-gather over
"data" are functions of the replicated inputs, so each shard forms its
own copy of them without a collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from word2bits_tpu_torch.kernels.span_scatter import sort_plan
from word2bits_tpu_torch.models.cbow import (CBOWHyper, ChunkScalars,
                                             chunk_slabs, step_alphas)
from word2bits_tpu_torch.parallel.layout import pad_hot_weights
from word2bits_tpu_torch.parallel.mesh import VOCAB_AXIS, Collectives
from word2bits_tpu_torch.parallel.sharded_slab import check_sharded, to_local
from word2bits_tpu_torch.sampling.unigram import (AliasTable, draw_cold,
                                                  draw_negatives)
from word2bits_tpu_torch.utils.trace import span


def gathered_update_ids(slab_ids: torch.Tensor, negs: torch.Tensor, nd: int,
                        W: int, neg_sharing: int):
    """([S, nd*(Bl+2W)] u update ids, [S, nd*(Bl+n)] v update ids) of
    global slab ids [S, B+2W] and negatives [S, rows, L]: each data
    shard's slab (with its halo), then its centers and negatives, in data
    order — what the sharded body's all-gathers over "data" produce."""
    S, Bh = slab_ids.shape
    Bl = (Bh - 2 * W) // nd
    ids_u, ids_v = [], []
    for d in range(nd):
        lo = d * Bl
        ids_u.append(slab_ids[:, lo:lo + Bl + 2 * W])
        mine = negs if neg_sharing else negs[:, lo:lo + Bl]
        ids_v += [slab_ids[:, W + lo:W + lo + Bl], mine.reshape(S, -1)]
    return torch.cat(ids_u, dim=1), torch.cat(ids_v, dim=1)


def make_sharded_chunk(body_fn, hyper: CBOWHyper, mesh,
                       vocab_size_padded: int, vocab_size: int,
                       batch_size: int, steps: int, neg_sharing: int = 0,
                       neg_pool: int = 1, dense_hot=None, hot_rows: int = 0,
                       hot_layout=None, banded: int = 0, rmw: bool = False,
                       scatter_impl: str = "add"):
    """chunk(comm, u_local, v_local, tokens, sent_ids, atab, scalars,
    gen=None, n_steps=None, shrinks=None, negs=None) -> (u_local, v_local,
    loss_sum): n_steps (default `steps`) steps of `body_fn` on this shard's
    tables, IN PLACE.  `mesh` gives nd and nv; tokens, sent_ids, atab and
    scalars are the replicated epoch arrays, alias table and schedule, as
    make_slab_train_chunk takes them.  `vocab_size` (true, unpadded)
    bounds the draws, `vocab_size_padded` sets the shard blocks.

    dense_hot = (kc, w_cold, hot_w [H]) with hot_rows = H: exact
    hot-stratum negatives; `atab` is then the cold stratum's table and kc
    cold lanes a pool are drawn at offset H.  hot_layout: the tables are in
    the balanced layout; hot_w is zero-padded to its hot_pad here.  banded,
    rmw, scatter_impl: the sharded slab body's (the config gates them)."""
    vss = check_sharded(mesh, batch_size, vocab_size_padded, neg_sharing)
    nd, nv = mesh.nd, mesh.nv
    B, W, K = batch_size, hyper.window, hyper.negative
    pools = neg_pool if (neg_sharing and neg_pool and neg_pool > 1) else 1
    neg_rows = B // neg_sharing if neg_sharing else B
    lanes = pools * (dense_hot[0] if dense_hot is not None else K)
    body_kw = {}
    if banded:
        body_kw["banded"] = banded
    if rmw:
        body_kw["rmw"] = True
    if scatter_impl != "add":
        body_kw["scatter_impl"] = scatter_impl
    if dense_hot is not None:
        hot_w = torch.as_tensor(dense_hot[2], dtype=torch.float32)
        if hot_layout is not None:
            hot_w = pad_hot_weights(hot_w, hot_layout)
            body_kw["hot_layout"] = hot_layout
        body_kw["dense_hot"] = (dense_hot[1], hot_w)

    def chunk(comm: Collectives, u_local: torch.Tensor,
              v_local: torch.Tensor, tokens: torch.Tensor,
              sent_ids: torch.Tensor, atab: AliasTable,
              scalars: ChunkScalars, gen: Optional[torch.Generator] = None,
              n_steps: Optional[int] = None,
              shrinks: Optional[torch.Tensor] = None,
              negs: Optional[torch.Tensor] = None):
        dev = u_local.device
        S = steps if n_steps is None else n_steps
        slab_tokens, slab_sents = chunk_slabs(tokens, sent_ids,
                                              scalars.base0, S, B, W)
        if shrinks is None:
            shrinks = torch.randint(0, W, (S, B), generator=gen, device=dev)
        if negs is None:
            if dense_hot is not None:
                negs = draw_cold(gen, atab, (S, neg_rows, lanes), hot_rows)
            else:
                negs = draw_negatives(gen, atab, (S, neg_rows, lanes),
                                      vocab_size)
        alphas = step_alphas(scalars, S, dev)
        kw = dict(body_kw)
        if "dense_hot" in kw:
            kw["dense_hot"] = (kw["dense_hot"][0],
                               kw["dense_hot"][1].to(dev))
        plans = None
        if scatter_impl == "span":
            # hoisted: every step's update ids are known at chunk entry
            ids_u, ids_v = gathered_update_ids(slab_tokens.clamp_min(0),
                                               negs, nd, W, neg_sharing)
            vi = comm.axis_index(VOCAB_AXIS)
            plans = (sort_plan(to_local(ids_u, vi, vss, hot_layout)),
                     sort_plan(to_local(ids_v, vi, vss, hot_layout)))
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(S):
            if plans is not None:
                kw["span_plans"] = (plans[0].step(s), plans[1].step(s))
            with span("step"):
                u_local, v_local, step_loss = body_fn(
                    comm, u_local, v_local, slab_tokens[s], slab_sents[s],
                    shrinks[s], negs[s], alphas[s], hyper, B, neg_sharing,
                    vss, neg_pool=pools, **kw)
                loss = loss + step_loss
        # each step's loss is summed over "data" inside the body and equal
        # on every vocab shard: the psum / nv averages those copies
        return u_local, v_local, comm.psum(loss, VOCAB_AXIS) / nv

    return chunk
