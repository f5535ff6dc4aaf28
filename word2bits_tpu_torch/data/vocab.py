"""Vocabulary: build / sort / prune / save / load.

Reference semantics (reference src/word2bits.cpp:215-341): `</s>` pinned at
index 0 and never pruned; newlines map to `</s>`; sort by descending count
(stable: ties keep first-occurrence order — a documented divergence from
the reference's qsort); words below min_count dropped; `train_words` is
the total count of the surviving words including `</s>`; the save format
is "word count\\n" lines, and load re-sorts and re-prunes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

SENTENCE_TOKEN = "</s>"
# reference: vocab_hash_size=30M, reduce when vocab_size > 0.7 * that
# (reference src/word2bits.cpp:35,292)
REDUCE_THRESHOLD = 21_000_000


@dataclass
class Vocab:
    """Sorted vocabulary. index 0 is always `</s>`."""

    words: List[str]
    counts: np.ndarray  # int64 [V]

    @property
    def size(self) -> int:
        return len(self.words)

    @property
    def train_words(self) -> int:
        return int(self.counts.sum())

    @staticmethod
    def from_counts(counts: Dict[str, int], min_count: int = 5) -> "Vocab":
        """Sort descending by count, prune < min_count (except `</s>`)."""
        sent_count = counts.get(SENTENCE_TOKEN, 0)
        items = [(w, c) for w, c in counts.items()
                 if w != SENTENCE_TOKEN and c >= min_count]
        items.sort(key=lambda wc: -wc[1])
        words = [SENTENCE_TOKEN] + [w for w, _ in items]
        cns = np.asarray([sent_count] + [c for _, c in items], dtype=np.int64)
        return Vocab(words=words, counts=cns)

    def save(self, path: str) -> None:
        """Reference SaveVocab format."""
        with open(path, "w", encoding="utf-8", errors="surrogateescape") as f:
            for w, c in zip(self.words, self.counts):
                f.write(f"{w} {int(c)}\n")

    @staticmethod
    def load(path: str, min_count: int = 5) -> "Vocab":
        """Reference ReadVocab: read 'word count' lines then re-sort/prune."""
        counts: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8", errors="surrogateescape") as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                counts[parts[0]] = int(parts[1])
        return Vocab.from_counts(counts, min_count=min_count)

    def unigram_weights(self, power: float = 0.75) -> np.ndarray:
        """count^power weights for negative sampling (reference :115)."""
        return np.power(self.counts.astype(np.float64), power)


def reduce_counts(counts: Dict[str, int], min_reduce: int) -> Dict[str, int]:
    """Reference ReduceVocab: keep words with count > min_reduce."""
    return {w: c for w, c in counts.items() if c > min_reduce}
