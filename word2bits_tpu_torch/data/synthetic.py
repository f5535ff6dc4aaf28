"""Synthetic Zipf corpora, offline stand-ins for real ones.

`zipf_corpus` writes a text8-like file: space-separated letter-only words
drawn from `vocab` types, no newlines; the same bytes as the JAX package's
generator for the same arguments.  `zipf_vocab_corpus` builds, in memory,
a vocabulary of the full-Wikipedia configuration's shape (3.7M types,
every count at least min-count) and an encoded corpus holding each word
exactly its count, for sizes where a text file and the pure-Python
tokenizer would take longer than the training.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from word2bits_tpu_torch.data.vocab import SENTENCE_TOKEN, Vocab


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


def zipf_vocab_corpus(n_types: int, head: float = 700_000.0,
                      s: float = 1.05, min_count: int = 5,
                      sentence: int = 20, seed: int = 0
                      ) -> Tuple[Vocab, np.ndarray]:
    """(Vocab, int32 encoded corpus): `</s>` plus words w1..w{n_types-1},
    the word of rank r counted max(min_count, floor(head * r^-s)), and a
    corpus holding each word exactly its count, shuffled, with a sentence
    break (`</s>`, id 0) after every `sentence` words; `</s>` is counted
    once per break, as the reference counts newlines."""
    r = np.arange(1, n_types, dtype=np.float64)
    counts = np.maximum(min_count, np.floor(head * r ** -s)).astype(np.int64)
    rng = np.random.default_rng(seed)
    words = rng.permutation(np.repeat(np.arange(1, n_types, dtype=np.int32),
                                      counts))
    n = words.size
    encoded = np.zeros(n + n // sentence, dtype=np.int32)
    encoded[np.arange(n) + np.arange(n) // sentence] = words
    vocab = Vocab(words=[SENTENCE_TOKEN] + [f"w{i}" for i in range(1, n_types)],
                  counts=np.concatenate([[n // sentence], counts]))
    return vocab, encoded
