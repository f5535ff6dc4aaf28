"""Parameter initialization.

The reference initializes BOTH tables U(-0.5, 0.5) from one sequential LCG
stream seeded at 1, filling v first, then u (reference
src/word2bits.cpp:343-361).  `init="reference"` reproduces that stream bit
for bit (utils/lcg.py); `init="uniform"` draws the same distribution from
a seeded torch.Generator.

`init_fused_table` builds the training engine's fused (V, 2D) table
directly on its device, in row blocks: the reference stream is computed
there (utils/lcg.lcg_uniform_torch), so the host never holds a table.
"""

from __future__ import annotations

from typing import Tuple

import torch

from word2bits_tpu_torch.utils.lcg import lcg_uniform_torch

_BLOCK = 1 << 24  # draws per half per device block


def init_params(vocab_size: int, size: int, init: str = "reference",
                seed: int = 1, dtype=torch.float32,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (u, v), each [vocab_size, size] in `dtype` on `device`: the
    two halves of init_fused_table.  The float32 draws round to `dtype`
    (round-to-nearest-even)."""
    table = init_fused_table(vocab_size, size, init=init, seed=seed,
                             dtype=dtype, device=device)
    return table[:, :size].contiguous(), table[:, size:].contiguous()


def init_fused_table(vocab_size: int, size: int, init: str = "reference",
                     seed: int = 1, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """The fused (V, 2D) table [u | v].  With the reference init it is
    allocated once on `device` and filled there in row blocks of about
    _BLOCK draws per half (v from draw 0, u from draw V*D, as the
    reference stream runs), each rounded to `dtype` there; "uniform" draws
    u, then v, from a torch.Generator seeded with `seed` on the host."""
    V, D = vocab_size, size
    if init == "uniform":
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand((V, D), generator=gen) - 0.5
        v = torch.rand((V, D), generator=gen) - 0.5
        return torch.cat([u, v], dim=1).to(device=device, dtype=dtype)
    if init != "reference":
        raise ValueError(f"unknown init {init!r}")
    table = torch.empty((V, 2 * D), dtype=dtype, device=device)
    rows = max(1, _BLOCK // max(D, 1))
    for r0 in range(0, V, rows):
        r1 = min(V, r0 + rows)
        n = (r1 - r0) * D
        table[r0:r1, D:] = lcg_uniform_torch(r0 * D, n, device).view(-1, D)
        table[r0:r1, :D] = lcg_uniform_torch(V * D + r0 * D, n,
                                             device).view(-1, D)
    return table
