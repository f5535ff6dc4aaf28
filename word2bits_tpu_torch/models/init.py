"""Parameter initialization.

The reference initializes BOTH tables U(-0.5, 0.5) from one sequential LCG
stream seeded at 1, filling v first, then u (reference
src/word2bits.cpp:343-361).  `init="reference"` reproduces that stream bit
for bit (utils/lcg.py); `init="uniform"` draws the same distribution from
a seeded torch.Generator.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from word2bits_tpu_torch.utils.lcg import lcg_uniform_block

_BLOCK = 1 << 24  # values per host block


def _lcg_matrix(start_draw: int, rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    out = np.empty(n, dtype=np.float32)
    for ofs in range(0, n, _BLOCK):
        m = min(_BLOCK, n - ofs)
        out[ofs:ofs + m] = lcg_uniform_block(start_draw + ofs, m)
    return out.reshape(rows, cols)


def init_params(vocab_size: int, size: int, init: str = "reference",
                seed: int = 1, dtype=torch.float32,
                device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (u, v), each [vocab_size, size] in `dtype` on `device`.
    The float32 draws round to `dtype` (round-to-nearest-even)."""
    if init == "reference":
        n = vocab_size * size
        v = _lcg_matrix(0, vocab_size, size)
        u = _lcg_matrix(n, vocab_size, size)
        return (torch.from_numpy(u).to(device=device, dtype=dtype),
                torch.from_numpy(v).to(device=device, dtype=dtype))
    if init == "uniform":
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand((vocab_size, size), generator=gen) - 0.5
        v = torch.rand((vocab_size, size), generator=gen) - 0.5
        return (u.to(device=device, dtype=dtype),
                v.to(device=device, dtype=dtype))
    raise ValueError(f"unknown init {init!r}")
