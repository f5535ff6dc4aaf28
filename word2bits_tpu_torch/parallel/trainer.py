"""The sharded trainer: the train.py loop over a (data, vocab) mesh.

The counterpart of the JAX package's parallel/trainer.py.  `train.train`
builds a ShardedTrainer when `-mesh-shape` is set (train.build_engine) and
runs its chunks in the epoch loop; each chunk is S steps of
parallel/chunk.make_sharded_chunk around the sharded slab or skip-gram
body, the loss fetched once per epoch.

One process per card (torchrun: `parallel/multihost.initialize`); a mesh
of one shard in a plain process starts a one-rank group of its own
(`mesh_session`).  Each rank holds rows [vi*Vs, (vi+1)*Vs) of the tables
padded to a multiple of nv only (the JAX trainer pads further, to its
span window and 128 columns, for Mosaic's DMA tiles), filled from the
reference init stream for those rows alone (models/init.init_param_rows)
or read from a checkpoint's rows (train.load_checkpoint).  With
-neg-dense-hot and -hot-interleave 1 the rows are placed in the balanced
hot layout (parallel/layout.py) under the JAX trainer's condition.

Rank 0 builds each epoch's arrays, and they are broadcast over the world
(`replicate_segments`); only rank 0 logs and writes files, from the tables
`params()` gathers to it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.models.cbow import CBOWHyper
from word2bits_tpu_torch.models.init import init_param_rows
from word2bits_tpu_torch.parallel import multihost
from word2bits_tpu_torch.parallel.chunk import make_sharded_chunk
from word2bits_tpu_torch.parallel.layout import (HotLayout, from_layout,
                                                 make_hot_layout)
from word2bits_tpu_torch.parallel.mesh import (VOCAB_AXIS, Collectives,
                                               DistCollectives, make_mesh,
                                               mesh_dims)
from word2bits_tpu_torch.parallel.sharded_skipgram import \
    _sharded_skipgram_body
from word2bits_tpu_torch.parallel.sharded_slab import _sharded_slab_body

_BLOCK_VALUES = 1 << 24   # values per row block moved by params()


def shard_layout(cfg: Word2BitsConfig, vocab_size: int,
                 nv: int) -> Tuple[int, Optional[HotLayout]]:
    """(padded rows Vp, the balanced hot layout or None): the layout when
    -neg-dense-hot and -hot-interleave 1 run on nv > 1 vocab shards and the
    rounded head leaves every shard a cold block (JAX trainer.py:50-56)."""
    Vp = -(-vocab_size // nv) * nv
    layout = None
    if (cfg.neg_dense_hot and cfg.hot_interleave and nv > 1
            and -(-cfg.hot_rows // nv) * nv < Vp):
        layout = make_hot_layout(Vp, nv, cfg.hot_rows)
    return Vp, layout


def local_ranges(cfg: Word2BitsConfig, vocab_size: int,
                 comm: Collectives) -> List[Tuple[int, int]]:
    """The global row ranges this vocab shard holds, in local order."""
    Vp, layout = shard_layout(cfg, vocab_size, comm.nv)
    if layout is not None:
        return layout.ranges(comm.vi)
    Vs = Vp // comm.nv
    return [(comm.vi * Vs, (comm.vi + 1) * Vs)]


def init_local_tables(cfg: Word2BitsConfig, vocab_size: int,
                      comm: Collectives) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's rows of the initialized (u, v), on its device."""
    return init_param_rows(vocab_size, cfg.size,
                           local_ranges(cfg, vocab_size, comm),
                           init=cfg.init, seed=cfg.seed,
                           dtype=getattr(torch, cfg.dtype),
                           device=comm.device)


@contextlib.contextmanager
def mesh_session(cfg: Word2BitsConfig, device_type: str):
    """This rank's DistCollectives for cfg.mesh_shape.  Joins torchrun's
    process group (multihost.initialize) or, for a mesh of one shard in a
    plain process, starts a one-rank group (NCCL on the card, gloo on the
    CPU); a group started here is destroyed on exit.  A mesh larger than
    the processes raises (make_mesh): nothing runs a mesh on fewer
    devices."""
    nd, nv = mesh_dims(cfg.mesh_shape)
    started = False
    if not dist.is_initialized():
        started = multihost.initialize(device_type)
        if not started and nd * nv == 1:
            multihost.start_local_group(device_type)
            started = True
    try:
        device = multihost.rank_device(device_type)
        yield DistCollectives(make_mesh(cfg.mesh_shape, device=device))
    finally:
        if started:
            dist.destroy_process_group()


def replicate_segments(segments: Optional[Iterator],
                       device: torch.device) -> Iterator:
    """Rank 0's epoch segments, broadcast over the world group: rank 0
    passes its iterator of (tokens, sents, n_tokens, source_len, host
    tokens), the other ranks None.  Every rank yields (tokens, sents,
    n_tokens, source_len, None) with the tokens and sentence ids (int64)
    on `device`."""
    root = dist.get_rank() == 0
    while True:
        head = torch.zeros(4, dtype=torch.int64, device=device)
        seg = next(segments, None) if root else None
        if root and seg is not None:
            head[:] = torch.tensor([1, seg[2], seg[3], seg[0].shape[0]])
        dist.broadcast(head, src=0)
        more, n_tokens, source_len, length = head.tolist()
        if not more:
            return
        if root:
            tokens = seg[0].to(device, torch.int64).contiguous()
            sents = seg[1].to(device, torch.int64).contiguous()
        else:
            tokens = torch.empty(length, dtype=torch.int64, device=device)
            sents = torch.empty(length, dtype=torch.int64, device=device)
        dist.broadcast(tokens, src=0)
        dist.broadcast(sents, src=0)
        yield tokens, sents, n_tokens, source_len, None


class ShardedTrainer:
    """This shard's tables and the chunk that trains them."""

    def __init__(self, cfg: Word2BitsConfig, vocab_size: int,
                 comm: Collectives, u_local: torch.Tensor,
                 v_local: torch.Tensor, dense_hot=None):
        """u_local, v_local: this shard's rows (init_local_tables, or a
        checkpoint's), updated in place by every chunk."""
        if cfg.neg_dense_hot != (dense_hot is not None):
            raise ValueError("dense_hot must be given exactly when "
                             "-neg-dense-hot is on")
        self.cfg, self.comm, self.V = cfg, comm, vocab_size
        self.Vp, self.layout = shard_layout(cfg, vocab_size, comm.nv)
        shape = (self.Vp // comm.nv, cfg.size)
        for name, t in (("u", u_local), ("v", v_local)):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}_local is {tuple(t.shape)}, the "
                                 f"shard holds {shape}")
        hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=cfg.size,
                          window=cfg.window, negative=cfg.negative,
                          reg=cfg.reg)
        body = (_sharded_skipgram_body if cfg.model == "skipgram"
                else _sharded_slab_body)
        self.chunk_fn = make_sharded_chunk(
            body, hyper, comm, self.Vp, vocab_size, cfg.batch_size,
            cfg.steps_per_chunk, neg_sharing=cfg.neg_sharing,
            neg_pool=cfg.neg_pool, dense_hot=dense_hot,
            hot_rows=cfg.hot_rows, hot_layout=self.layout,
            banded=cfg.banded_tile, rmw=cfg.rmw_scatter,
            scatter_impl=cfg.scatter_impl)
        self.u, self.v = u_local, v_local

    def run_chunk(self, tokens, sents, atab, scalars, gen=None,
                  n_steps=None, shrinks=None, negs=None) -> torch.Tensor:
        """One chunk on this shard's tables; returns the chunk's loss sum
        (on the device, equal on every rank)."""
        self.u, self.v, loss = self.chunk_fn(
            self.comm, self.u, self.v, tokens, sents, atab, scalars, gen,
            n_steps=n_steps, shrinks=shrinks, negs=negs)
        return loss

    def params(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The whole unpadded (u, v), in global row order and the table
        dtype, on rank 0's device; None on the other ranks.  Every rank
        calls it.  One vocab shard with no layout: views of rank 0's
        tables; else rank 0 assembles them from row blocks all-gathered
        over "vocab"."""
        comm = self.comm
        root = comm.rank == 0
        if comm.nv == 1 and self.layout is None:
            return (self.u[:self.V], self.v[:self.V]) if root else None
        Vs, D = self.u.shape
        out = [torch.empty((self.Vp, D), dtype=t.dtype, device=t.device)
               for t in (self.u, self.v)] if root else None
        rows = max(1, _BLOCK_VALUES // max(D, 1))
        for r0 in range(0, Vs, rows):
            r1 = min(Vs, r0 + rows)
            for i, t in enumerate((self.u, self.v)):
                blk = comm.all_gather(t[r0:r1], VOCAB_AXIS)
                if root:
                    out[i].view(comm.nv, Vs, D)[:, r0:r1] = blk.view(
                        comm.nv, r1 - r0, D)
        if not root:
            return None
        if self.layout is not None:
            out = [from_layout(t, self.layout) for t in out]
        return out[0][:self.V], out[1][:self.V]
