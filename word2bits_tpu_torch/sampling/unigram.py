"""Unigram^0.75 negative sampling via Walker's alias method.

The reference draws from a 10^8-entry int table where word i occupies a
span proportional to count(i)^0.75 (reference src/word2bits.cpp:112-128,
draw at :456).  An alias table holds the same distribution exactly in two
V-length arrays; a draw is one uniform bucket, one uniform accept test and
one gather.  The table is built host-side (pure Python, bit-identical to
the JAX package's construction); draws run on the table's device from an
explicit torch.Generator.

Reference quirks kept at draw time (:455-458): a drawn 0 (`</s>`) is
remapped uniformly to [1, V-1]; a draw equal to the center is skipped by
the training step's mask, not resampled.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class AliasTable:
    """prob[i]: P(keep i | bucket i drawn); alias[i]: the overflow word."""

    prob: torch.Tensor   # float32 [V]
    alias: torch.Tensor  # int64 [V]

    def to(self, device) -> "AliasTable":
        return AliasTable(prob=self.prob.to(device),
                          alias=self.alias.to(device))


def build_alias_table(weights: np.ndarray) -> AliasTable:
    """O(V) Walker alias construction from unnormalized weights (CPU)."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] == 0:
        raise ValueError("weights must be a non-empty 1D array")
    total = w.sum()
    if total <= 0:
        raise ValueError("weights must have positive sum")
    V = w.shape[0]
    scaled = w * (V / total)  # mean 1

    prob = np.ones(V, dtype=np.float64)
    alias = np.arange(V, dtype=np.int64)
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        if scaled[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return AliasTable(prob=torch.from_numpy(prob.astype(np.float32)),
                      alias=torch.from_numpy(alias))


def draw_negatives(gen: torch.Generator, table: AliasTable, shape,
                   vocab_size: int) -> torch.Tensor:
    """int64 negative ids of `shape` from the unigram^0.75 distribution,
    drawn on the table's device, with the reference's remap-0 quirk."""
    dev = table.prob.device
    bucket = torch.randint(0, vocab_size, shape, generator=gen, device=dev)
    accept = torch.rand(shape, generator=gen, device=dev)
    target = torch.where(accept < table.prob[bucket], bucket,
                         table.alias[bucket])
    # reference :457 — drawn 0 becomes uniform over [1, V-1]
    remap = torch.randint(1, vocab_size, shape, generator=gen, device=dev)
    return torch.where(target == 0, remap, target)
