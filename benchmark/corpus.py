"""The benchmark's inputs: a vocabulary and an encoded corpus made in
memory from the seed.

Frozen copy of word2bits_tpu_torch/data/synthetic.py `zipf_vocab_corpus`
(commit 26809b4dee3683ec1871bc5d1e1a6fa56c4992c9): the word of rank r is
counted max(min_count, floor(head * r^-s)) and the corpus holds each word
exactly its count, shuffled, with a `</s>` (id 0) after every `sentence`
words.  Rewritten in two ways: the shuffle runs on the device from a
torch.Generator (one call), and `sentence = 0` gives one line with no
`</s>` at all, as text8 is (the pipeline cuts it every 1000 words).  The
counts are a function of the configuration alone, so every seed trains on
the same words in another order.  `zipf_corpus`'s i.i.d. draws would give
each seed another vocabulary size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SENTENCE_TOKEN = "</s>"


@dataclass
class Corpus:
    counts: np.ndarray        # int64 [V]; counts[0] is `</s>`'s
    encoded: np.ndarray       # int32 [n]; id 0 = `</s>`
    encoded_dev: torch.Tensor  # the same on the device it was made on

    @property
    def train_words(self) -> int:
        """Words of one epoch as the reference counts them: every word
        and every `</s>` (vocab.train_words)."""
        return int(self.counts.sum())

    @property
    def size(self) -> int:
        return len(self.counts)


def zipf_counts(n_types: int, head: float, s: float,
                min_count: int) -> np.ndarray:
    """int64 [n_types - 1] counts of the words of rank 1..n_types-1."""
    r = np.arange(1, n_types, dtype=np.float64)
    return np.maximum(min_count, np.floor(head * r ** -s)).astype(np.int64)


def make_corpus(spec: dict, seed: int, device) -> Corpus:
    """The corpus of a configuration's `corpus` entry: n_types, head, s,
    min_count, sentence (0: one line)."""
    n_types, sentence = int(spec["n_types"]), int(spec["sentence"])
    counts = zipf_counts(n_types, float(spec["head"]), float(spec["s"]),
                         int(spec["min_count"]))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    ids = torch.repeat_interleave(
        torch.arange(1, n_types, dtype=torch.int32, device=device),
        torch.from_numpy(counts).to(device))
    words = ids[torch.randperm(ids.numel(), generator=gen, device=device)]
    n = words.numel()
    if sentence:
        enc = torch.zeros(n + n // sentence, dtype=torch.int32,
                          device=device)
        pos = torch.arange(n, device=device)
        enc[pos + pos // sentence] = words
        n_sent = n // sentence
    else:
        enc, n_sent = words, 0
    all_counts = np.concatenate([[n_sent], counts]).astype(np.int64)
    return Corpus(counts=all_counts, encoded=enc.cpu().numpy(),
                  encoded_dev=enc)


def word_names(n_types: int):
    """The vocabulary's words: `</s>`, then w1 .. w{n_types-1}."""
    return [SENTENCE_TOKEN] + [f"w{i}" for i in range(1, n_types)]
