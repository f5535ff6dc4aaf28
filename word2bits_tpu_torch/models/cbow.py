"""CBOW hyperparameters and per-chunk LR-schedule scalars.

The port keeps only what the fused-table step needs from the JAX package's
models/cbow.py; the per-center reference step (`cbow_minibatch_update`)
is not ported yet.  Reference math (reference src/word2bits.cpp:363-516):
context average of quantized u rows, LUT-sigmoid gradients against the
quantized v rows, negatives equal to the center skipped, u updates NOT
divided by the context count, linear LR decay with a 1e-4*alpha0 floor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class CBOWHyper:
    """Static hyperparameters."""

    bitlevel: int = 1
    size: int = 100
    window: int = 5
    negative: int = 5
    reg: float = 0.0

    def __post_init__(self):
        if self.bitlevel == 3:
            raise ValueError("bitlevel 3 is a reference quantizer hole; rejected")


class ChunkScalars(NamedTuple):
    """Per-chunk scalars of the LR schedule (reference :379-393), as Python
    numbers; the chunk turns them into float32 device scalars."""

    base0: int            # padded-array offset of the chunk's first center
    alpha0: float         # starting_alpha
    wca_start: float      # word_count_actual at chunk start
    wca_per_step: float   # words consumed per step (B * train_words/centers)
    denom: float          # iter * train_words + 1
