"""Synthetic Zipf corpus (offline stand-in for text8): space-separated
letter-only words drawn from `vocab` types, no newlines.  Same bytes as the
JAX package's generator for the same arguments."""

from __future__ import annotations

import numpy as np


def zipf_corpus(path: str, n_tokens: int = 17_000_000, vocab: int = 70_000,
                s: float = 1.05, seed: int = 0, chunk: int = 1 << 20) -> None:
    """Write a Zipf(s) corpus of n_tokens words drawn from `vocab` types."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-s)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    words = np.asarray([_word_for(i) for i in range(vocab)], dtype=object)
    with open(path, "wb") as f:
        remaining = n_tokens
        while remaining > 0:
            m = min(chunk, remaining)
            ids = np.searchsorted(cdf, rng.random(m))
            f.write(b" ".join(words[ids]) + b" ")
            remaining -= m


_ALPHA = "abcdefghijklmnopqrstuvwxyz"


def _word_for(i: int) -> bytes:
    out = []
    i += 1
    while i > 0:
        i, r = divmod(i - 1, 26)
        out.append(_ALPHA[r])
    return ("w" + "".join(reversed(out))).encode()
