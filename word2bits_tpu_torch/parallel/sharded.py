"""Vocab-sharded and data-parallel reference-shaped step, and the row
exchange every sharded body uses.

The counterpart of the JAX package's parallel/sharded.py, on the
collectives of parallel/mesh.py: a synchronous step over a
(data, vocab) mesh where

  * u, v are split by vocabulary rows over "vocab" (shard vi holds rows
    [vi*Vs, (vi+1)*Vs) of the tables padded to a multiple of nv) and
    replicated over "data";
  * data shard di takes centers [di*B/nd, (di+1)*B/nd) of the batch;
  * a row is fetched from its owning vocab shard by a masked local gather
    plus a psum over "vocab" (`_gather_rows`);
  * updates accumulate in a local float32 [Vs, D] delta, summed over
    "data" by a psum and added by the owning shard (`_scatter_delta`);
  * the loss is summed over both axes.

Equal to the single-device step up to float summation order
(tests/test_torch_parallel_*.py).  Each shard's tables are updated in
place, where the JAX step donates them.
"""

from __future__ import annotations

import numpy as np
import torch

from word2bits_tpu_torch.models.cbow import Batch, CBOWHyper
from word2bits_tpu_torch.ops.quantize import quantize
from word2bits_tpu_torch.ops.scatter import SENTINEL, scatter_add
from word2bits_tpu_torch.ops.sigmoid import sigmoid_exact, sigmoid_lut
from word2bits_tpu_torch.parallel.mesh import (DATA_AXIS, VOCAB_AXIS,
                                               Collectives)


def pad_vocab_rows(x, multiple: int):
    """Pad the vocabulary dimension (numpy or tensor) up to a multiple of
    `multiple` with zero rows."""
    V = x.shape[0]
    Vp = -(-V // multiple) * multiple
    if Vp == V:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((Vp - V,) + tuple(x.shape[1:]))])
    return np.concatenate(
        [x, np.zeros((Vp - V,) + x.shape[1:], dtype=x.dtype)], axis=0)


def shard_params(u, v, comm: Collectives):
    """This vocab shard's rows of the padded tables u, v (numpy or
    tensors; a multiple of nv rows, in layout order where a layout
    applies), as contiguous copies on the shard's device (the steps
    update them in place)."""
    def local(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        Vp = x.shape[0]
        if Vp % comm.nv:
            raise ValueError(f"vocab {Vp} not divisible by {comm.nv}")
        Vs = Vp // comm.nv
        return x[comm.vi * Vs:(comm.vi + 1) * Vs].to(comm.device,
                                                     copy=True)

    return local(u), local(v)


def owner_local(ids: torch.Tensor, vocab_shard_size: int, layout=None):
    """(owner vocab shard, local row) of global ids: contiguous blocks, or
    the balanced hot layout's piecewise map (parallel/layout.py)."""
    if layout is None:
        return ids // vocab_shard_size, ids % vocab_shard_size
    return layout.owner_local(ids)


def _gather_rows(comm: Collectives, table_local: torch.Tensor,
                 ids: torch.Tensor, vocab_shard_size: int,
                 layout=None) -> torch.Tensor:
    """Rows `ids` of the vocab-split table, float32 on every shard: the
    owner's local row, zero elsewhere, summed over "vocab".  With
    `layout` (the JAX package's _gather_rows_layout) ownership follows the
    balanced hot layout's slot map."""
    owner, local = owner_local(ids, vocab_shard_size, layout)
    rows = table_local[local].to(torch.float32)
    mine = (owner == comm.axis_index(VOCAB_AXIS))[..., None]
    return comm.psum(rows * mine.to(rows.dtype), VOCAB_AXIS)


def _scatter_delta(comm: Collectives, ids: torch.Tensor, rows: torch.Tensor,
                   mask: torch.Tensor, vocab_shard_size: int, out_shape,
                   layout=None) -> torch.Tensor:
    """The masked row updates this shard owns, accumulated in float32 into
    a local [Vs, D] delta (the masked rows and those of other shards get
    the drop SENTINEL); `layout` as in _gather_rows (the JAX package's
    _scatter_delta_layout)."""
    Vs, D = out_shape
    owner, local = owner_local(ids, vocab_shard_size, layout)
    keep = mask & (owner == comm.axis_index(VOCAB_AXIS))
    delta = torch.zeros((Vs, D), dtype=rows.dtype, device=rows.device)
    return scatter_add(delta, torch.where(keep, local, SENTINEL).reshape(-1),
                       rows.reshape(-1, D))


def sharded_minibatch_update(comm: Collectives, u_local: torch.Tensor,
                             v_local: torch.Tensor, batch: Batch, alpha,
                             hyper: CBOWHyper, vocab_shard_size: int):
    """models/cbow.cbow_minibatch_update on vocab-split tables, IN PLACE;
    `batch` holds this data shard's centers.  Returns (u_local, v_local,
    loss summed over "data")."""
    Vs, D = u_local.shape
    dt = torch.float32
    alpha = torch.as_tensor(alpha, dtype=dt, device=u_local.device)

    # context statistics (reference :431-449), rows fetched from owners
    u_rows = _gather_rows(comm, u_local, batch.ctx_ids, vocab_shard_size)
    q_rows = quantize(u_rows, hyper.bitlevel)
    m = batch.ctx_mask[..., None].to(dt)
    csum = (q_rows * m).sum(dim=1)
    cw = batch.ctx_mask.sum(dim=1).to(dt)
    active = batch.valid & (cw > 0)
    context_avg = csum / torch.clamp_min(cw, 1.0)[:, None]
    ctx_reg = ((q_rows * q_rows).sum(dim=-1) * batch.ctx_mask).sum(dim=1)

    # center + negatives (reference :450-492)
    B = batch.centers.shape[0]
    targets = torch.cat([batch.centers[:, None], batch.neg_ids], dim=1)
    labels = torch.zeros(targets.shape, dtype=dt, device=u_local.device)
    labels[:, 0] = 1.0
    dmask = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=u_local.device),
                       batch.neg_ids != batch.centers[:, None]],
                      dim=1) & active[:, None]
    v_rows = _gather_rows(comm, v_local, targets, vocab_shard_size)
    q_v = quantize(v_rows, hyper.bitlevel)
    f = torch.bmm(q_v, context_avg[:, :, None])[..., 0]
    g = (labels - sigmoid_lut(f)) * alpha * dmask.to(dt)
    signed_f = torch.where(labels > 0, f, -f)
    v_reg = hyper.reg * (q_v * q_v).sum(dim=-1)
    loss = ((torch.log(sigmoid_exact(signed_f)) - v_reg)
            * dmask.to(dt)).sum()
    loss = loss - hyper.reg * (ctx_reg * active.to(dt)).sum()

    two_ar = 2.0 * alpha * hyper.reg
    dv = g[..., None] * context_avg[:, None, :] \
        - two_ar * v_rows * dmask[..., None]
    context_avge = torch.bmm(g[:, None, :], q_v)[:, 0]
    cm = batch.ctx_mask & active[:, None]
    du = context_avge[:, None, :] - two_ar * u_rows

    # apply: local deltas summed over the data axis
    delta_v = _scatter_delta(comm, targets, dv, dmask, vocab_shard_size,
                             (Vs, D))
    delta_u = _scatter_delta(comm, batch.ctx_ids, du, cm, vocab_shard_size,
                             (Vs, D))
    delta_v = comm.psum(delta_v, DATA_AXIS)
    delta_u = comm.psum(delta_u, DATA_AXIS)
    loss = comm.psum(loss, DATA_AXIS)
    u_local.add_(delta_u.to(u_local.dtype))
    v_local.add_(delta_v.to(v_local.dtype))
    return u_local, v_local, loss


def _check_mesh(mesh, batch_size: int, vocab_size_padded: int) -> int:
    """The vocab shard size, after the JAX step factories' checks."""
    if batch_size % mesh.nd:
        raise ValueError(f"batch {batch_size} not divisible by data axis "
                         f"{mesh.nd}")
    if vocab_size_padded % mesh.nv:
        raise ValueError(f"vocab {vocab_size_padded} not divisible by "
                         f"vocab axis {mesh.nv}")
    return vocab_size_padded // mesh.nv


def make_sharded_train_step(hyper: CBOWHyper, mesh, vocab_size_padded: int,
                            batch_size: int):
    """step(comm, u_local, v_local, centers, ctx_ids, ctx_mask, neg_ids,
    valid, alpha) -> (u_local, v_local, loss) over the mesh (a Mesh or a
    LocalMesh: its nd and nv).  The batch arrays are the global batch of
    `batch_size` (divisible by nd), replicated; u_local, v_local this
    shard's rows of tables padded to `vocab_size_padded` (divisible by
    nv), updated in place.  The loss is the global sum."""
    vss = _check_mesh(mesh, batch_size, vocab_size_padded)
    Bl = batch_size // mesh.nd

    def step(comm: Collectives, u_local, v_local, centers, ctx_ids,
             ctx_mask, neg_ids, valid, alpha):
        sl = slice(comm.axis_index(DATA_AXIS) * Bl,
                   (comm.axis_index(DATA_AXIS) + 1) * Bl)
        batch = Batch(centers=centers[sl], ctx_ids=ctx_ids[sl],
                      ctx_mask=ctx_mask[sl], neg_ids=neg_ids[sl],
                      valid=valid[sl])
        u_local, v_local, loss = sharded_minibatch_update(
            comm, u_local, v_local, batch, alpha, hyper, vss)
        # loss already summed over data; average the vocab-axis copies
        return u_local, v_local, comm.psum(loss, VOCAB_AXIS) / mesh.nv

    return step
