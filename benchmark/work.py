"""The work a training step needs, from the cell's shapes and its own
unigram counts, never from the program's arguments: the rows a step
touches, its operations and its bytes.  Each input byte counts as read
once and each output byte as written once (chip_smoke.py's rule, commit
26809b4dee3683ec1871bc5d1e1a6fa56c4992c9)."""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from benchmark import reference as ref


def expected_distinct(*draws) -> float:
    """E[distinct ids] among independent draws: (probabilities [V], n)
    pairs, each n draws from its distribution."""
    log_miss = 0.0
    for p, n in draws:
        log_miss = log_miss + n * np.log1p(-np.minimum(p, 1.0 - 1e-16))
    return float((1.0 - np.exp(log_miss)).sum())


@dataclass
class StepShape:
    """A step of a cell: its flags and its corpus's counts."""

    B: int
    W: int
    D: int
    K: int
    G: int          # shared-negative tile; 0 = per-center negatives
    P: int          # pools per tile
    fused: bool     # one (V, 2D) table
    elt: int        # bytes of a table element
    counts: np.ndarray
    sample: float
    tile: int = 0   # banded tile (kernel 1)

    @classmethod
    def of(cls, cfg, counts) -> "StepShape":
        G = cfg.neg_sharing
        tile = 0
        if cfg.banded_tile:
            t = min(cfg.banded_tile, cfg.batch_size)
            while cfg.batch_size % t:
                t -= 1
            tile = t
        return cls(B=cfg.batch_size, W=cfg.window, D=cfg.size,
                   K=cfg.negative, G=G,
                   P=cfg.neg_pool if (G and cfg.neg_pool > 1) else 1,
                   fused=bool(cfg.fused_on),
                   elt=2 if cfg.dtype == "bfloat16" else 4,
                   counts=np.asarray(counts), sample=cfg.sample, tile=tile)

    @property
    def n_slab(self) -> int:
        return self.B + 2 * self.W

    @property
    def n_negs(self) -> int:
        """Negative ids drawn a step."""
        if self.G:
            return (self.B // self.G) * self.P * self.K
        return self.B * self.K

    @cached_property
    def p_kept(self) -> np.ndarray:
        """Distribution of a word of the subsampled stream."""
        c = self.counts.astype(np.float64)
        keep = np.minimum(ref.keep_probs(self.counts, self.sample,
                                         int(c.sum())), 1.0)
        p = c * keep
        p[0] = 0.0
        return p / p.sum()

    @cached_property
    def p_neg(self) -> np.ndarray:
        return ref.negative_probs(self.counts)

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
        """Context sums and u sums over 2W offsets, and per center and
        target (center + K negatives) a dot product, its u-gradient term
        and its v row, each 2D operations; the scatter adds."""
        B, W, D, K = self.B, self.W, self.D, self.K
        adds = (self.n_slab + self.n_negs) * (2 * D if self.fused else D)
        return 2.0 * (B * 2 * W * D) + 6.0 * B * (K + 1) * D + adds

    def step_bytes(self) -> float:
        """Each touched u row and v row read and written once."""
        D, e = self.D, self.elt
        return 2.0 * (self.rows_slab + self.rows_v) * D * e


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
