"""Unigram^0.75 negative sampling via Walker's alias method.

The reference draws from a 10^8-entry int table where word i occupies a
span proportional to count(i)^0.75 (reference src/word2bits.cpp:112-128,
draw at :456).  An alias table holds the same distribution exactly in two
V-length arrays; a draw is one uniform bucket, one uniform accept test and
one gather.  The table is built host-side (by the C++ library of native/
where it builds, else in pure Python; both bit-identical to the JAX
package's construction); draws run on the table's device from an explicit
torch.Generator.

Reference quirks kept at draw time (:455-458): a drawn 0 (`</s>`) is
remapped uniformly to [1, V-1]; a draw equal to the center is skipped by
the training step's mask, not resampled.

The stratified hot/cold sampler (an extension of the JAX package, no
reference analogue; `-neg-stratify`, `-neg-dense-hot`) splits the same
distribution at a hot-row boundary H (the vocabulary is count-sorted):
`build_stratified_tables` folds the drawn-0 mass into the strata up front
(0's mass spread uniformly over [1, V-1]), so its draws
(`draw_negatives_stratified`, `draw_cold`) never remap; the importance
weights of `lane_split` / `dense_split` keep the expected negative update
equal to the plain sampler's.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Optional

import numpy as np
import torch

from word2bits_tpu_torch import native


@dataclass
class AliasTable:
    """prob[i]: P(keep i | bucket i drawn); alias[i]: the overflow word."""

    prob: torch.Tensor   # float32 [V]
    alias: torch.Tensor  # int64 [V]

    def to(self, device) -> "AliasTable":
        return AliasTable(prob=self.prob.to(device),
                          alias=self.alias.to(device))


def build_alias_table(weights: np.ndarray,
                      use_native: Optional[bool] = None) -> AliasTable:
    """O(V) Walker alias construction from unnormalized weights (CPU):
    the native library's (`use_native` as in data/corpus.count_words),
    or the pure-Python loop, which gives the same bits."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] == 0:
        raise ValueError("weights must be a non-empty 1D array")
    total = w.sum()
    if total <= 0:
        raise ValueError("weights must have positive sum")
    V = w.shape[0]
    scaled = w * (V / total)  # mean 1

    lib = native.native_for(use_native)
    if lib is not None:
        out = lib.alias_build(np.array(scaled, np.float64, order="C"))
        if out is not None:
            return AliasTable(prob=torch.from_numpy(out[0].astype(np.float32)),
                              alias=torch.from_numpy(out[1]))
    if use_native:
        raise RuntimeError("native alias build requested but not available")

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


@dataclass
class StratifiedSampler:
    """Hot/cold split of the effective unigram^0.75 draw distribution."""

    hot: AliasTable      # over ids [0, H) (id 0 has zero mass)
    cold: AliasTable     # over ids [H, V) (stored 0-based; a draw adds H)
    p_hot: float         # mass of the hot stratum
    hot_rows: int
    hot_probs: np.ndarray  # [H] float64 draw probability of each hot id

    def lane_split(self, negative: int):
        """(kh, w_hot, w_cold): hot lanes per pool of K and the importance
        weights; a nonzero stratum always gets >= 1 lane, which needs
        K >= 2 when both strata carry mass."""
        K = int(negative)
        if K < 2 and 0.0 < self.p_hot < 1.0:
            raise ValueError(
                f"stratified sampling needs negative >= 2 to give each "
                f"nonzero stratum a lane, got negative={K}")
        kh = int(round(K * self.p_hot))
        if self.p_hot < 1.0:
            kh = min(kh, K - 1)
        if self.p_hot > 0.0:
            kh = max(kh, 1)
        w_hot = (self.p_hot * K / kh) if kh else 0.0
        w_cold = ((1.0 - self.p_hot) * K / (K - kh)) if K - kh else 0.0
        return kh, w_hot, w_cold

    def dense_split(self, negative: int):
        """(kc, w_cold, hot_w): kc sampled cold lanes per pool with
        importance weight w_cold = (1-p_hot)*K/kc, and the float32 [H]
        per-word weights hot_w = K * P(draw h) of the exact hot stratum."""
        K = int(negative)
        if self.p_hot >= 1.0:
            raise ValueError("dense_split needs a nonempty cold stratum "
                             "(hot_rows < vocab)")
        kc = max(1, int(round(K * (1.0 - self.p_hot))))
        w_cold = (1.0 - self.p_hot) * K / kc
        return kc, w_cold, (K * self.hot_probs).astype(np.float32)


def build_stratified_tables(weights: np.ndarray,
                            hot_rows: int) -> StratifiedSampler:
    """Split the effective draw distribution at hot_rows.  `weights` are
    the raw count^0.75 weights including index 0 (`</s>`), as given to
    build_alias_table; the remap-0 quirk is applied here analytically."""
    w = np.asarray(weights, dtype=np.float64).copy()
    V = w.shape[0]
    H = int(min(hot_rows, V))
    if H < 2:
        raise ValueError("stratified sampling needs hot_rows >= 2")
    if V > 1:
        w[1:] += w[0] / (V - 1)
    w[0] = 0.0
    total = w.sum()
    p_hot = float(w[:H].sum() / total)
    hot = build_alias_table(w[:H])
    cold = (build_alias_table(w[H:]) if H < V
            else AliasTable(prob=torch.ones((1,), dtype=torch.float32),
                            alias=torch.zeros((1,), dtype=torch.int64)))
    return StratifiedSampler(hot=hot, cold=cold, p_hot=p_hot, hot_rows=H,
                             hot_probs=w[:H] / total)


def alias_draw(gen: torch.Generator, table: AliasTable,
               shape) -> torch.Tensor:
    """int64 draws of `shape` from an alias table, 0-based, no remap."""
    dev = table.prob.device
    size = table.prob.shape[0]
    bucket = torch.randint(0, size, shape, generator=gen, device=dev)
    accept = torch.rand(shape, generator=gen, device=dev)
    return torch.where(accept < table.prob[bucket], bucket,
                       table.alias[bucket])


def draw_cold(gen: torch.Generator, cold: AliasTable, shape,
              hot_rows: int) -> torch.Tensor:
    """Cold-stratum draws (ids >= hot_rows) of `shape`: the sampled lanes
    of the dense-hot estimator."""
    return hot_rows + alias_draw(gen, cold, shape)


def draw_negatives_stratified(gen: torch.Generator, hot: AliasTable,
                              cold: AliasTable, tiles, pools: int,
                              negative: int, kh: int,
                              hot_rows: int) -> torch.Tensor:
    """[*tiles, pools*negative] ids (`tiles` an int or a shape): within
    each pool of `negative` lanes the first kh are hot draws (id <
    hot_rows), the rest cold (id >= hot_rows)."""
    lead = (tiles,) if isinstance(tiles, int) else tuple(tiles)
    P, K = pools, negative
    parts = []
    if kh:
        parts.append(alias_draw(gen, hot, lead + (P, kh)))
    if K - kh:
        parts.append(draw_cold(gen, cold, lead + (P, K - kh), hot_rows))
    return torch.cat(parts, dim=-1).reshape(lead + (P * K,))
