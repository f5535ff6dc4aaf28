"""Parameter initialization.

The reference initializes BOTH tables U(-0.5, 0.5) from one sequential LCG
stream seeded at 1, filling v first, then u (reference
src/word2bits.cpp:343-361).  `init="reference"` reproduces that stream bit
for bit (utils/lcg.py); `init="uniform"` draws the same distribution from
a seeded torch.Generator.

Both engines' tables are allocated once on their device and filled there
in row blocks: the reference stream is computed on the device
(utils/lcg.lcg_uniform_torch), so the host never holds a table.
`init_params` fills the split tables (u, v) of the slab engine,
`init_fused_table` the fused (V, 2D) table [u | v]; both hold the same
values.  fastText's subword model (`-model fasttext`) has `buckets` input
rows more than output rows: its u rows V.. continue the same stream (the
reference's u draws run on past V*D), so its first V rows of u and v equal
the word2vec tables'; its CBOW with position weights (`-model
fasttext-cbow`) has a third table, the position weights d [2W, D],
float32 ones (`init_position_weights`).  `init_param_rows` fills only
given row ranges of the split tables: a mesh shard's (parallel/trainer.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from word2bits_tpu_torch.utils.lcg import lcg_uniform_torch

_BLOCK = 1 << 24  # draws per half per device block


def _fill(u: torch.Tensor, v: torch.Tensor, init: str, seed: int,
          row0: int = 0, vocab_size: int | None = None) -> None:
    """Fill u and v ([R, D] each, possibly column views of one table) in
    place with rows [row0, row0 + R) of the [vocab_size, D] tables
    (default: all of them); u may have more rows than v (the bucket rows
    of the subword model, row0 0).  Reference: row blocks of about _BLOCK
    draws per half, v from draw 0 and u from draw V*D as the reference
    stream runs, each block rounded to the tables' dtype on their device.
    Uniform: u, then v, from a torch.Generator seeded with `seed` on the
    host."""
    R, D = u.shape
    Rv = v.shape[0]
    V = Rv if vocab_size is None else vocab_size
    if init == "uniform":
        gen = torch.Generator().manual_seed(seed)
        u.copy_((torch.rand((V + R - Rv, D), generator=gen) - 0.5)
                [row0:row0 + R])
        v.copy_((torch.rand((V, D), generator=gen) - 0.5)[row0:row0 + Rv])
        return
    if init != "reference":
        raise ValueError(f"unknown init {init!r}")
    rows = max(1, _BLOCK // max(D, 1))
    for r0 in range(0, R, rows):
        r1 = min(R, r0 + rows)
        g0 = (row0 + r0) * D
        if r0 < Rv:
            n = (min(r1, Rv) - r0) * D
            v[r0:min(r1, Rv)] = lcg_uniform_torch(g0, n, v.device).view(
                -1, D)
        u[r0:r1] = lcg_uniform_torch(V * D + g0, (r1 - r0) * D,
                                     u.device).view(-1, D)


def _device(device) -> torch.device:
    """train.resolve_device: cuda unless the caller asks for another."""
    from word2bits_tpu_torch.train import resolve_device
    return resolve_device(device)


def init_params(vocab_size: int, size: int, init: str = "reference",
                seed: int = 1, dtype=torch.float32, device=None,
                buckets: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (u, v), each [vocab_size, size] in `dtype` on `device`
    (default cuda; pass device='cpu' for the CPU), u with `buckets` rows
    more (the subword model's n-gram buckets).  The float32 draws round to
    `dtype` (round-to-nearest-even)."""
    device = _device(device)
    u = torch.empty((vocab_size + buckets, size), dtype=dtype, device=device)
    v = torch.empty((vocab_size, size), dtype=dtype, device=device)
    _fill(u, v, init, seed)
    return u, v


def init_position_weights(window: int, size: int,
                          device=None) -> torch.Tensor:
    """d [2 * window, size] float32 ones on `device` (default cuda): one
    weight vector a window position -W..-1, 1..W, each starting as the
    plain average's weight."""
    return torch.ones((2 * window, size), dtype=torch.float32,
                      device=_device(device))


def init_fused_table(vocab_size: int, size: int, init: str = "reference",
                     seed: int = 1, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The fused (V, 2D) table [u | v], equal to init_params' halves, on
    `device` (default cuda; pass device='cpu' for the CPU)."""
    device = _device(device)
    table = torch.empty((vocab_size, 2 * size), dtype=dtype, device=device)
    _fill(table[:, :size], table[:, size:], init, seed)
    return table


def init_param_rows(vocab_size: int, size: int, ranges, init: str = "reference",
                    seed: int = 1, dtype=torch.float32,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) rows of init_params' tables: the global row ranges `ranges`
    ((r0, r1) pairs) one after another, rows at or past vocab_size zero
    (a mesh shard's padding).  The same values as init_params' rows."""
    device = _device(device)
    n = sum(r1 - r0 for r0, r1 in ranges)
    u = torch.zeros((n, size), dtype=dtype, device=device)
    v = torch.zeros((n, size), dtype=dtype, device=device)
    o = 0
    for r0, r1 in ranges:
        m = max(0, min(r1, vocab_size) - r0)
        if m:
            _fill(u[o:o + m], v[o:o + m], init, seed, r0, vocab_size)
        o += r1 - r0
    return u, v
