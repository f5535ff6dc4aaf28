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
values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from word2bits_tpu_torch.utils.lcg import lcg_uniform_torch

_BLOCK = 1 << 24  # draws per half per device block


def _fill(u: torch.Tensor, v: torch.Tensor, init: str, seed: int) -> None:
    """Fill u and v ([V, D] each, possibly column views of one table) in
    place.  Reference: row blocks of about _BLOCK draws per half, v from
    draw 0 and u from draw V*D as the reference stream runs, each block
    rounded to the tables' dtype on their device.  Uniform: u, then v, from
    a torch.Generator seeded with `seed` on the host."""
    V, D = u.shape
    if init == "uniform":
        gen = torch.Generator().manual_seed(seed)
        u.copy_(torch.rand((V, D), generator=gen) - 0.5)
        v.copy_(torch.rand((V, D), generator=gen) - 0.5)
        return
    if init != "reference":
        raise ValueError(f"unknown init {init!r}")
    rows = max(1, _BLOCK // max(D, 1))
    for r0 in range(0, V, rows):
        r1 = min(V, r0 + rows)
        n = (r1 - r0) * D
        v[r0:r1] = lcg_uniform_torch(r0 * D, n, v.device).view(-1, D)
        u[r0:r1] = lcg_uniform_torch(V * D + r0 * D, n, u.device).view(-1, D)


def _device(device) -> torch.device:
    """train.resolve_device: cuda unless the caller asks for another."""
    from word2bits_tpu_torch.train import resolve_device
    return resolve_device(device)


def init_params(vocab_size: int, size: int, init: str = "reference",
                seed: int = 1, dtype=torch.float32,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (u, v), each [vocab_size, size] in `dtype` on `device`
    (default cuda; pass device='cpu' for the CPU).  The float32 draws
    round to `dtype` (round-to-nearest-even)."""
    device = _device(device)
    u = torch.empty((vocab_size, size), dtype=dtype, device=device)
    v = torch.empty((vocab_size, size), dtype=dtype, device=device)
    _fill(u, v, init, seed)
    return u, v


def init_fused_table(vocab_size: int, size: int, init: str = "reference",
                     seed: int = 1, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    """The fused (V, 2D) table [u | v], equal to init_params' halves, on
    `device` (default cuda; pass device='cpu' for the CPU)."""
    device = _device(device)
    table = torch.empty((vocab_size, 2 * size), dtype=dtype, device=device)
    _fill(table[:, :size], table[:, size:], init, seed)
    return table
