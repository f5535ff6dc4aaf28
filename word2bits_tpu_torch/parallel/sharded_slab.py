"""Vocab-sharded and data-parallel SLAB step: the mesh form of the slab
engine (models/cbow_slab.py).

The counterpart of the JAX package's parallel/sharded_slab.py, on the
collectives of parallel/mesh.py:
  * u, v split by rows over "vocab"; the step's inputs replicated, each
    data shard slicing its own B/nd centers with a 2W halo;
  * rows fetched from their owners by a masked local gather plus a psum
    over "vocab" (parallel/sharded._gather_rows);
  * the context, positive, negative and u-sum phases are the slab
    engine's own (positive_phase, shared_negative_phase with the shard's
    pool offset, per_center_negative_phase, u_update_rows);
  * the updates reach the owning shard by one of three routes:
      add   per-shard float32 [Vs, D] deltas, psum'd over "data", added;
      span  (-scatter-impl span) the update lists (ids, rows), all-gathered
            over "data", applied by kernel 2 (kernels/span_scatter.py) on
            LOCAL ids, the rows of other shards mapped to SENTINEL and
            dropped by the kernel;
      rmw   (-rmw-scatter) the same lists through kernel 8
            (kernels/scatter_pallas.scatter_add_rmw), in place: the
            capacity path, whose tables are never copied.
    Duplicate ids from different data shards meet inside the kernel, so
    the sums equal the dense route's up to float order.

Tables are updated in place (the JAX step donates them) and stored
unpadded: the JAX span and rmw routes pad each shard's rows and columns
for Mosaic's DMA tiles, which the Hopper kernels do not need.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
from word2bits_tpu_torch.kernels.span_scatter import (
    SENTINEL, SortPlan, scatter_add_span_planned, sort_plan)
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.models.cbow_slab import (
    SlabInputs, per_center_negative_phase, positive_phase,
    shared_negative_phase, u_update_rows)
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.parallel.mesh import (DATA_AXIS, VOCAB_AXIS,
                                               Collectives)
from word2bits_tpu_torch.parallel.sharded import (_check_mesh, _gather_rows,
                                                  _scatter_delta, owner_local)


def to_local(ids: torch.Tensor, vi: int, vocab_shard_size: int,
             layout=None) -> torch.Tensor:
    """Local rows of the ids vocab shard vi owns, SENTINEL for the rest."""
    owner, local = owner_local(ids, vocab_shard_size, layout)
    return torch.where(owner == vi, local, SENTINEL)


def my_slab(comm: Collectives, slab_tokens, slab_sents, shrink, negs,
            B_global: int, W: int, neg_sharing: int) -> SlabInputs:
    """This data shard's slice of the replicated step inputs: its B/nd
    centers with their 2W halo; with shared negatives all T tiles (a
    shard's range starts at a multiple of T, so its local center b joins
    global tile b % T and every shard holds G/nd members of each tile)."""
    B = B_global // comm.axis_size(DATA_AXIS)
    start = comm.axis_index(DATA_AXIS) * B
    return SlabInputs(slab_tokens=slab_tokens[start:start + B + 2 * W],
                      slab_sents=slab_sents[start:start + B + 2 * W],
                      shrink=shrink[start:start + B],
                      neg_ids=negs if neg_sharing else negs[start:start + B])


def hot_shard(comm: Collectives, v_local: torch.Tensor, hot_w: torch.Tensor,
              hot_layout=None):
    """(global ids [Hs], weights [Hs], float32 v rows [Hs, D]) of the hot
    rows this vocab shard holds at its leading local rows: with the
    balanced layout its own sub-range of the head, else the rows of its
    block below H (weight zero past H)."""
    Vs = v_local.shape[0]
    H = hot_w.shape[0]
    vi = comm.axis_index(VOCAB_AXIS)
    Hs = min(H, Vs) if hot_layout is None else hot_layout.hot_per_shard
    base = vi * (Vs if hot_layout is None else Hs)
    gidx = base + torch.arange(Hs, device=v_local.device)
    w_loc = torch.where(gidx < H, hot_w[gidx.clamp(0, H - 1)],
                        torch.zeros((), dtype=hot_w.dtype,
                                    device=hot_w.device))
    return gidx, w_loc, v_local[:Hs].to(torch.float32)


def _sharded_slab_body(comm: Collectives, u_local, v_local, slab_tokens,
                       slab_sents, shrink, negs, alpha, hyper: CBOWHyper,
                       B_global: int, neg_sharing: int,
                       vocab_shard_size: int, neg_pool: int = 1,
                       dense_hot=None, hot_layout=None, banded: int = 0,
                       rmw: bool = False, scatter_impl: str = "add",
                       span_plans: Optional[Tuple[SortPlan, SortPlan]] = None):
    """One sharded slab step on this shard's tables, IN PLACE.  The step
    inputs are the global ones (replicated).  Returns (u_local, v_local,
    loss summed over "data").

    dense_hot = (w_cold, hot_w [H]): exact hot-stratum negatives
    (models/cbow_fused.py): each vocab shard scores every center against
    its own rows of global id < H, so the head needs no row exchange, only
    a psum over "vocab" of the [B, D] gradient term and the loss; `negs`
    then holds cold draws (ids >= H) weighted by w_cold.  hot_layout
    (parallel/layout.HotLayout, with dense_hot): the tables are in the
    balanced layout, hot_w padded to its hot_pad.

    span_plans = (plan of the u update ids, plan of the v update ids), on
    local ids after the all-gather over "data": the chunk builds them for
    all its steps at once (parallel/chunk.py), so the ids need no
    collective; without them the step gathers the ids and plans here."""
    W, D = hyper.window, hyper.size
    reg = hyper.reg
    dt = torch.float32
    Vs = u_local.shape[0]
    spanning = scatter_impl == "span"
    if scatter_impl not in ("add", "span"):
        raise ValueError(f"unknown scatter_impl {scatter_impl!r} "
                         "(sharded slab supports 'add' and 'span')")
    if rmw and spanning:
        raise ValueError("rmw and scatter_impl='span' are exclusive")
    if hot_layout is not None and dense_hot is None:
        raise ValueError("hot_layout requires dense_hot")
    if (rmw or spanning) and dense_hot is not None:
        raise ValueError("rmw/span does not compose with dense_hot "
                         "(config validation rejects it upstream)")
    nd, di = comm.axis_size(DATA_AXIS), comm.axis_index(DATA_AXIS)
    B = B_global // nd
    inputs = my_slab(comm, slab_tokens, slab_sents, shrink, negs, B_global,
                     W, neg_sharing)
    my_negs = inputs.neg_ids
    slab_ids = inputs.slab_tokens.clamp_min(0)
    centers = slab_ids[W:W + B]
    alpha = torch.as_tensor(alpha, dtype=dt, device=u_local.device)

    def gat(tab, ids):
        return _gather_rows(comm, tab, ids, vocab_shard_size, hot_layout)

    # every row exchange first: the three psums over "vocab" are
    # independent of the compute below
    u_rows = gat(u_local, slab_ids)
    v_c = gat(v_local, centers)
    v_n = gat(v_local, my_negs)
    pos = positive_phase(u_rows, v_c, inputs, alpha, hyper, B, banded, False)
    loss, cavge = pos.loss, pos.cavge
    weight = None if dense_hot is None else float(dense_hot[0])
    if neg_sharing:
        T = B_global // neg_sharing     # global tile count
        G_local = B // T                # members of each tile here
        P = neg_pool if neg_pool and neg_pool > 1 else 1
        PK = my_negs.shape[1]
        lw = (None if weight is None else
              torch.full((PK,), weight, dtype=dt, device=u_local.device))
        cavge_neg, dv_neg, nloss = shared_negative_phase(
            pos.cavg, pos.af, centers, my_negs, v_n, alpha, hyper, B,
            G_local, P, False, lane_weight=lw, pool_offset=di * G_local)
    else:
        g_neg, m2, cavge_neg, nloss = per_center_negative_phase(
            pos.cavg, pos.af, centers, my_negs, v_n, alpha, hyper, weight)
        dv_neg = g_neg[..., None] * pos.cavg[:, None, :]
        if reg:
            dv_neg = dv_neg - 2.0 * alpha * reg * v_n * m2[..., None]
        dv_neg = dv_neg.reshape(-1, D)
    loss = loss + nloss
    cavge = cavge + cavge_neg
    negs_flat = my_negs.reshape(-1)

    dv_hot = None
    if dense_hot is not None:
        # this shard's hot rows, scored against every center; only the
        # owners' weights are nonzero, so no hot row is exchanged
        hot_w = torch.as_tensor(dense_hot[1], dtype=dt,
                                device=u_local.device)
        gidx, w_loc, v_h = hot_shard(comm, v_local, hot_w, hot_layout)
        q_vh = quantize(v_h, hyper.bitlevel)
        f_h = pos.cavg @ q_vh.T                                  # [B, Hs]
        mh = ((gidx[None, :] != centers[:, None]).to(dt)
              * pos.af[:, None] * w_loc[None, :])
        g_h = (0.0 - sigmoid_lut(f_h)) * alpha * mh
        hot_reg = (reg * (q_vh * q_vh).sum(dim=-1))[None, :] if reg else 0.0
        hot_loss = ((torch.log(sigmoid_exact(-f_h)) - hot_reg) * mh).sum()
        loss = loss + comm.psum(hot_loss, VOCAB_AXIS)
        cavge = cavge + comm.psum(g_h @ q_vh, VOCAB_AXIS)
        dv_hot = g_h.T @ pos.cavg
        if reg:
            dv_hot = dv_hot - 2.0 * alpha * reg * v_h * mh.sum(dim=0)[:, None]

    du_slab = u_update_rows(pos, cavge, alpha, hyper, B)
    rows_v = torch.cat([pos.dv_center, dv_neg])

    if rmw or spanning:
        # row updates applied on the owning shard by a kernel, with local
        # ids; the data shards exchange their update lists
        vi = comm.axis_index(VOCAB_AXIS)
        rows_u = du_slab
        if nd > 1:
            rows_v = comm.all_gather(rows_v, DATA_AXIS)
            rows_u = comm.all_gather(rows_u, DATA_AXIS)
        if spanning and span_plans is not None:
            plan_u, plan_v = span_plans
        else:
            ids_v = torch.cat([centers, negs_flat])
            ids_u = slab_ids
            if nd > 1:
                ids_v = comm.all_gather(ids_v, DATA_AXIS)
                ids_u = comm.all_gather(ids_u, DATA_AXIS)
            ids_v = to_local(ids_v, vi, vocab_shard_size, hot_layout)
            ids_u = to_local(ids_u, vi, vocab_shard_size, hot_layout)
            if rmw:
                scatter_add_rmw(v_local, ids_v, rows_v)
                scatter_add_rmw(u_local, ids_u, rows_u)
                return u_local, v_local, comm.psum(loss, DATA_AXIS)
            plan_u, plan_v = sort_plan(ids_u), sort_plan(ids_v)
        scatter_add_span_planned(v_local, plan_v, rows_v)
        scatter_add_span_planned(u_local, plan_u, rows_u)
        return u_local, v_local, comm.psum(loss, DATA_AXIS)

    def scat(ids, rows):
        return _scatter_delta(comm, ids, rows, torch.ones_like(ids, dtype=bool),
                              vocab_shard_size, (Vs, D), hot_layout)

    delta_v = scat(centers, pos.dv_center) + scat(negs_flat, dv_neg)
    if dv_hot is not None:
        # the hot v updates land on this shard's leading rows (with the
        # balanced layout, its hot sub-range)
        delta_v[:dv_hot.shape[0]] += dv_hot
    delta_u = scat(slab_ids, du_slab)
    delta_v = comm.psum(delta_v, DATA_AXIS)
    delta_u = comm.psum(delta_u, DATA_AXIS)
    loss = comm.psum(loss, DATA_AXIS)
    u_local.add_(delta_u.to(u_local.dtype))
    v_local.add_(delta_v.to(v_local.dtype))
    return u_local, v_local, loss


def check_sharded(mesh, batch_size: int, vocab_size_padded: int,
                  neg_sharing: int) -> int:
    """The vocab shard size, after the JAX step factories' checks."""
    vss = _check_mesh(mesh, batch_size, vocab_size_padded)
    if neg_sharing:
        if batch_size % neg_sharing:
            raise ValueError("batch must be divisible by neg_sharing")
        if neg_sharing % mesh.nd:
            raise ValueError(
                f"neg_sharing tile ({neg_sharing}) must be divisible by the "
                f"data-axis size ({mesh.nd}) so every shard holds whole "
                "tile slices")
    return vss


def make_sharded_slab_step(hyper: CBOWHyper, mesh, vocab_size_padded: int,
                           batch_size: int, neg_sharing: int = 0,
                           neg_pool: int = 1, dense_hot=None,
                           hot_layout=None, banded: int = 0):
    """step(comm, u_local, v_local, slab_tokens, slab_sents, shrink, negs,
    alpha) -> (u_local, v_local, loss) over the mesh (its nd, nv): inputs
    replicated, tables vocab-split and updated in place, the loss the
    global sum."""
    vss = check_sharded(mesh, batch_size, vocab_size_padded, neg_sharing)

    def step(comm: Collectives, u_local, v_local, slab_tokens, slab_sents,
             shrink, negs, alpha):
        u_local, v_local, loss = _sharded_slab_body(
            comm, u_local, v_local, slab_tokens, slab_sents, shrink, negs,
            alpha, hyper, batch_size, neg_sharing, vss, neg_pool=neg_pool,
            dense_hot=dense_hot, hot_layout=hot_layout, banded=banded)
        return u_local, v_local, comm.psum(loss, VOCAB_AXIS) / mesh.nv

    return step
