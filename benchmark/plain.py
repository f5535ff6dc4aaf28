"""The plain reference's parts that no model owns, for the model modules
(benchmark/reference.py and any other that a configuration's `reference`
key names) and the check: the quantizer, the sigmoids, the subsampling
and the negatives' draw distribution, the slab of kept words, the rows a
few steps touch and the gaps the check reads from them.

Imports torch and numpy only: nothing of the program under test, of JAX or
of the JAX package.  Frozen copies of the port's plain formulas, each
headed by its source (commit 26809b4dee3683ec1871bc5d1e1a6fa56c4992c9):

- `quantize`: word2bits_tpu_torch/ops/quantize.py `quantize` (reference
  src/word2bits.cpp:73-108);
- `sigmoid_lut`, `sigmoid_exact`: word2bits_tpu_torch/ops/sigmoid.py
  (reference src/word2bits.cpp:67-71, :473-475, :614-618);
- `keep_probs`: word2bits_tpu_torch/data/pipeline.py
  `subsample_keep_probs` (reference :394-407).

`Rows` holds the rows that a few steps touch, per leaf ((u, v) for CBOW
and skip-gram), in the configuration's storage dtype; a model's step
updates them in place.  The check's negatives are the reference's own
draws (`draw_negatives`, by inverting the cumulative draw distribution:
`negative_probs`, or the model module's own), not the program's sampler.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch


EXP_TABLE_SIZE = 1000
MAX_EXP = 6.0
LUT_SCALE = 83.0          # C integer division: 1000 / 6 / 2
MAX_SENTENCE_LENGTH = 1000
PAD = -1
EDGE_TOL = 1e-4          # a score this near +-6 may sit on either side


def quantize(x: torch.Tensor, bitlevel: int) -> torch.Tensor:
    """2^bitlevel levels: sign(x)/3 at bitlevel 1 (0 maps to +1/3)."""
    if bitlevel == 0:
        return x

    def const(c):
        return torch.tensor(c, dtype=x.dtype, device=x.device)

    sign = torch.where(x < 0, const(-1.0), const(1.0))
    mag = torch.abs(x)
    if bitlevel == 1:
        return sign * (const(1.0) / const(3.0))
    if bitlevel == 2:
        return sign * torch.where(mag <= 0.5, const(0.25), const(0.75))
    if bitlevel == 3:
        return x * const(0.0)
    seg = float(2 ** (bitlevel - 1))
    casted = torch.minimum(torch.floor(mag * seg + 0.5), const(seg))
    return sign * (casted / const(seg))


def sigmoid_lut(f: torch.Tensor) -> torch.Tensor:
    """The gradient path's table: sigma at the bin of f, +-6 saturated."""
    idx = torch.floor((f + MAX_EXP) * LUT_SCALE)
    x_bin = (idx / EXP_TABLE_SIZE * 2.0 - 1.0) * MAX_EXP
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(f > MAX_EXP, one,
                       torch.where(f < -MAX_EXP, 0 * one,
                                   torch.sigmoid(x_bin)))


def sigmoid_exact(f: torch.Tensor) -> torch.Tensor:
    """The loss path's sigmoid: 1 above +6, 1e-9 below -6."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    return torch.where(f > MAX_EXP, one,
                       torch.where(f < -MAX_EXP, 1e-9 * one,
                                   torch.sigmoid(f)))


def keep_probs(counts: np.ndarray, sample: float,
               train_words: int) -> np.ndarray:
    """Per-word keep probability (sqrt(c/(s*T)) + 1) * s*T / c, in
    float64; 1 where the count is 0 or sampling is off."""
    c = counts.astype(np.float64)
    if sample <= 0:
        return np.ones_like(c)
    st = sample * float(train_words)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(c / st) + 1.0) * st / c
    p[~np.isfinite(p)] = 1.0
    return p


def kept_stats(counts: np.ndarray, sample: float,
               train_words: int) -> Tuple[float, float]:
    """Mean and standard deviation of the words an epoch keeps (every
    word but `</s>`, each kept with its probability, capped at 1)."""
    p = np.minimum(keep_probs(counts, sample, train_words), 1.0)[1:]
    c = counts[1:].astype(np.float64)
    return float((c * p).sum()), math.sqrt(float((c * p * (1 - p)).sum()))


def negative_probs(counts: np.ndarray) -> np.ndarray:
    """The draw distribution of a negative: count^0.75, with the mass of
    `</s>` (id 0) spread evenly over ids 1..V-1 (reference :455-458)."""
    w = counts.astype(np.float64) ** 0.75
    p = w / w.sum()
    p0 = p[0]
    p[0] = 0.0
    p[1:] += p0 / (len(p) - 1)
    return p


def negative_cdf(counts: np.ndarray, device,
                 probs=negative_probs) -> torch.Tensor:
    """float64 [V] cumulative `probs(counts)` (a model's draw
    distribution, `negative_probs` by default), for `draw_negatives`."""
    return torch.from_numpy(np.cumsum(probs(counts))).to(device)


def draw_negatives(gen: torch.Generator, cdf: torch.Tensor,
                   shape) -> torch.Tensor:
    """int64 negative ids of `shape`, drawn by inverting `cdf` (from
    `negative_cdf`) at uniforms of `gen`: the check's own draws, apart
    from the program's sampler.  Id 0 has no mass and is never drawn."""
    u = torch.rand(shape, dtype=torch.float64, generator=gen,
                   device=cdf.device) * cdf[-1]
    ids = torch.searchsorted(cdf, u.reshape(-1), right=True)
    return ids.clamp(1, cdf.numel() - 1).reshape(shape)


def step_alpha(alpha0: float, word_count: float, denom: float) -> float:
    """The learning rate after `word_count` words: linear decay to a floor
    of 1e-4 * alpha0 (reference :391-392)."""
    return alpha0 * max(1.0 - word_count / denom, 1e-4)


def slab_arrays(encoded: torch.Tensor, keep: torch.Tensor,
                uniforms: torch.Tensor, window: int,
                n_centers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, sents) int64 of W pad slots, then the first n_centers + W
    kept words of `encoded` (id 0 = `</s>`, never kept as a word) and
    their sentence ids: a sentence breaks at each `</s>` and every 1000
    kept words within it.  keep: float32 [V] keep probabilities, uniforms
    float32 [len(encoded)]."""
    enc = encoded.long()
    is_sent = enc == 0
    kept = (uniforms <= keep[enc]) & ~is_sent
    raw = torch.cumsum(is_sent.long(), 0)[kept]
    words = enc[kept]
    need = n_centers + window
    if words.numel() < need:
        raise ValueError(f"the corpus keeps {words.numel()} words; the "
                         f"check needs {need}")
    words, raw = words[:need], raw[:need]
    first = torch.ones(need, dtype=torch.bool, device=enc.device)
    first[1:] = raw[1:] != raw[:-1]
    start = torch.cummax(torch.where(first, torch.arange(
        need, device=enc.device), 0), 0).values
    inside = torch.arange(need, device=enc.device) - start
    brk = first | (inside % MAX_SENTENCE_LENGTH == 0)
    sents = torch.cumsum(brk.long(), 0) - 1
    pad = torch.full((window,), PAD, dtype=torch.long, device=enc.device)
    return torch.cat([pad, words]), torch.cat([pad, sents])


FP8_MAX = 448.0


def store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the storage dtype; float8 e4m3 saturates at +-448
    (torch's cast gives NaN past it)."""
    if dtype == torch.float8_e4m3fn:
        x = x.float().clamp(-FP8_MAX, FP8_MAX)
    return x.to(dtype)


class Rows:
    """The rows that a few steps touch, per leaf, in `storage` dtype:
    `leaf_ids[i]` [R_i] sorted and `leaves[i]` [R_i, D_i], the rows of
    leaf i at those ids.  `Rows(ids, u, v, storage)` is the two-leaf form
    of CBOW and skip-gram, u and v over one id set, which `.ids`, `.u`,
    `.v` and `.index` read; `Rows.of` takes any number of leaves, each
    over its own ids (`find`)."""

    def __init__(self, ids: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 storage: torch.dtype):
        self._set([(ids, u), (ids, v)], storage)

    @classmethod
    def of(cls, pairs, storage: torch.dtype) -> "Rows":
        """Rows of the (ids, rows) pairs, one a leaf."""
        rows = cls.__new__(cls)
        rows._set(pairs, storage)
        return rows

    def _set(self, pairs, storage: torch.dtype) -> None:
        self.leaf_ids = [ids for ids, _ in pairs]
        self.leaves = [store(x, storage) for _, x in pairs]
        self.storage = storage
        self.loss_bounds = (0.0, 0.0)   # the last step's loss, either side

    def find(self, leaf: int, ids: torch.Tensor) -> torch.Tensor:
        """The rows of leaf `leaf` that hold global ids `ids`."""
        return torch.searchsorted(self.leaf_ids[leaf], ids)

    @property
    def ids(self) -> torch.Tensor:
        return self.leaf_ids[0]

    def index(self, ids: torch.Tensor) -> torch.Tensor:
        return self.find(0, ids)

    @property
    def u(self) -> torch.Tensor:
        return self.leaves[0]

    @u.setter
    def u(self, x: torch.Tensor) -> None:
        self.leaves[0] = x

    @property
    def v(self) -> torch.Tensor:
        return self.leaves[1]

    @v.setter
    def v(self, x: torch.Tensor) -> None:
        self.leaves[1] = x


def rows_gap(prog: "Rows", ref: "Rows", start: "Rows") -> float:
    """Element by element: per leaf, the norm of the program's rows less
    the reference's after a step, over the larger of the reference's
    change of that leaf and the median of the leaves' changes; the worst
    leaf.  With two leaves (u, v) the median is the mean of the two, as
    the gap read before leaves were counted."""
    diff = [float((p.float() - r.float()).norm())
            for p, r in zip(prog.leaves, ref.leaves)]
    moved = [float((r.float() - s.float()).norm())
             for r, s in zip(ref.leaves, start.leaves)]
    mid = float(np.median(moved))
    return max(d / max(m, mid, 1e-30) for d, m in zip(diff, moved))


def leaf_gaps(prog: List[float], ref: List[float]) -> Optional[float]:
    """The worst leaf's gap between two sets of leaf norms: |prog - ref|
    over the larger of the reference's leaf norm and its median leaf
    norm; leaves the reference moves by under a thousandth of the median
    leaf are left out.  None when every leaf is left out."""
    med = float(np.median(ref))
    worst = None
    for p, r in zip(prog, ref):
        if r < 1e-3 * med:
            continue
        gap = abs(p - r) / max(r, med)
        worst = gap if worst is None else max(worst, gap)
    return worst
