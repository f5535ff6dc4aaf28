"""The work a training step needs, from the cell's shapes, its own
unigram counts and its model module's bound state, never from the
program's arguments: the rows a step touches, its operations and its
bytes.  The negatives a step draws (one step of the model's
`negative_shape`) and their distribution (`negative_probs`, hooks.py),
its operations and its bytes are the model's (the cell's model module:
`negative_shape`, `step_flops`, `step_bytes`, which may read per-word
quantities from `state`, the module's `bind` of the run's words); the
rows expected from them and the kernels' byte counts are here.  Each
input byte counts as read once and each output byte as written once
(chip_smoke.py's rule, commit 26809b4dee3683ec1871bc5d1e1a6fa56c4992c9)."""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from types import ModuleType

import numpy as np

from benchmark import hooks, plain


def expected_distinct(*draws) -> float:
    """E[distinct ids] among independent draws: (probabilities [V], n)
    pairs, each n draws from its distribution."""
    log_miss = 0.0
    for p, n in draws:
        log_miss = log_miss + n * np.log1p(-np.minimum(p, 1.0 - 1e-16))
    return float((1.0 - np.exp(log_miss)).sum())


@dataclass
class StepShape:
    """A step of a cell: its flags, its corpus's counts and its model
    module, which counts the step's negatives, operations and bytes from
    them and from `state`, the module's `bind` of the run's words
    (hooks.py)."""

    B: int
    W: int
    D: int
    K: int
    n_negs: int     # negative ids drawn a step
    fused: bool     # one (V, 2D) table
    elt: int        # bytes of a table element
    counts: np.ndarray
    sample: float
    model: ModuleType
    tile: int = 0   # banded tile (kernel 1)
    state: object = None

    @classmethod
    def of(cls, cfg, counts, model: ModuleType,
           state=None) -> "StepShape":
        """The step of `cfg`; `state` None binds the module on the
        default words (hooks.bound)."""
        if state is None:
            state = hooks.bound(model, cfg, "cpu", len(counts))
        tile = 0
        if cfg.banded_tile:
            t = min(cfg.banded_tile, cfg.batch_size)
            while cfg.batch_size % t:
                t -= 1
            tile = t
        return cls(B=cfg.batch_size, W=cfg.window, D=cfg.size,
                   K=cfg.negative,
                   n_negs=int(np.prod(model.negative_shape(cfg, 1)[1:])),
                   fused=bool(cfg.fused_on),
                   elt=2 if cfg.dtype == "bfloat16" else 4,
                   counts=np.asarray(counts), sample=cfg.sample,
                   model=model, tile=tile, state=state)

    @property
    def n_slab(self) -> int:
        return self.B + 2 * self.W

    @cached_property
    def p_kept(self) -> np.ndarray:
        """Distribution of a word of the subsampled stream."""
        c = self.counts.astype(np.float64)
        keep = np.minimum(plain.keep_probs(self.counts, self.sample,
                                           int(c.sum())), 1.0)
        p = c * keep
        p[0] = 0.0
        return p / p.sum()

    @cached_property
    def p_neg(self) -> np.ndarray:
        """Distribution of a negative: the model's `negative_probs`."""
        return hooks.of(self.model, "negative_probs")(self.counts)

    @cached_property
    def rows_slab(self) -> float:
        """E[distinct u rows]: the slab's words."""
        return expected_distinct((self.p_kept, self.n_slab))

    @cached_property
    def rows_v(self) -> float:
        """E[distinct v rows]: the centers and the negatives."""
        return expected_distinct((self.p_kept, self.B),
                                 (self.p_neg, self.n_negs))

    @cached_property
    def rows_all(self) -> float:
        """E[distinct rows] of the slab and the negatives together."""
        return expected_distinct((self.p_kept, self.n_slab),
                                 (self.p_neg, self.n_negs))

    def step_flops(self) -> float:
        """The step's operations, as its model counts them."""
        return self.model.step_flops(self)

    def step_bytes(self) -> float:
        """The step's bytes, as its model counts them."""
        return self.model.step_bytes(self)


def span_bytes(N: int, C: int, U: float, elt: int) -> float:
    """Kernel 2 (chip_smoke.py's count): N float32 rows of C columns and
    the span plan (order N, sorted ids N, run starts N+1, run count 1)
    read once; each of the U touched table rows read and written once."""
    return N * C * 4 + (3 * N + 2) * 4 + 2 * U * C * elt


def grmw_bytes(N: int, C: int, U: float, elt: int) -> float:
    """Kernel 7 (chip_smoke.py's count): the rows and the group plan
    (order N, sorted ids N, run starts N+1, visit runs N+1, visit count
    1) read once; each touched row read and written once."""
    return N * C * 4 + (4 * N + 3) * 4 + 2 * U * C * elt


def context_bytes(B: int, D: int, W: int, tile: int, elt: int) -> float:
    """Kernel 1 (chip_smoke.py's count): the tile windows of the slab's u
    rows [B/tile, tile+2W, D], the centers' v rows [B, D], the banded
    masks [B/tile, tile, tile+2W] float32, the valid flags, alpha; out the
    context averages, the u-gradient seeds and the center v rows [B, D]
    float32, the active flags and the loss."""
    nt, F = B // tile, tile + 2 * W
    return (nt * F * D * elt + B * D * elt + nt * tile * F * 4 + B * 4 + 4
            + 3 * B * D * 4 + B * 4 + 4)
