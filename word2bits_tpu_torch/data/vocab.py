"""Vocabulary: build / sort / prune / save / load.

Reference semantics (reference src/word2bits.cpp:215-341): `</s>` pinned at
index 0 and never pruned; newlines map to `</s>`; sort by descending count
(stable: ties keep first-occurrence order — a documented divergence from
the reference's qsort); words below min_count dropped; `train_words` is
the total count of the surviving words including `</s>`; the save format
is "word count\\n" lines, and load re-sorts and re-prunes.

`subword_rows` gives fastText's subword rows of every word (Bojanowski
et al. 2017, arXiv 1607.04606; fastText's Dictionary::initNgrams) for the
`-model fasttext` engine: G_w is the word's own row w, then one row
V + fnv1a(g) % bucket per n-gram g of minn..maxn bytes of `<word>`, in
fastText's order (by start, then by length), duplicates kept, the lone
`<` and `>` never an n-gram (at minn 1); `</s>` has its own row only.
The hash is fastText's 32-bit FNV-1a, each byte sign-extended as its
int8: h = (h ^ uint32(int8(byte))) * 16777619.
fastText counts n in UTF-8 characters; here n counts bytes, the same for
ASCII words.  Built vectorised on the training device (tens of millions
of n-grams at a Wikipedia vocabulary), as a CSR.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

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


FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
_U32 = 0xFFFFFFFF


def _fnv_step(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One byte of fastText's FNV-1a on int64 tensors: h < 2^32, b the
    bytes 0..255, sign-extended as int8 before the xor."""
    sx = torch.where(b >= 128, b + 0xFFFFFF00, b)
    return ((h ^ sx) * FNV_PRIME) & _U32


@dataclass
class Subwords:
    """Each word's subword rows G_w as a CSR on the training device: the
    rows of word w are ids[offsets[w]:offsets[w + 1]], its own row
    first.  `max_len` is the largest |G_w|, `rows` the input table's
    rows (V + buckets)."""

    offsets: torch.Tensor   # int64 [V + 1]
    ids: torch.Tensor       # int32 [offsets[-1]]
    max_len: int
    rows: int


def subword_rows(words: List[str], minn: int, maxn: int, bucket: int,
                 device="cpu") -> Subwords:
    """The Subwords of `words` (index 0 `</s>`) with n-grams of minn..maxn
    bytes (none at maxn 0) hashed into `bucket` rows after the V word
    rows.  One pass per n-gram length over the bytes of every `<word>`
    at once; one host sync for `max_len`."""
    V = len(words)
    raw = ("\n".join(words) + "\n").encode("utf-8", "surrogateescape")
    a = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    a = a.long()
    nl = a == 10
    if int(nl.sum()) != V:
        raise ValueError("a word holds a newline: words are whitespace-free")
    N = a.numel()
    # joined byte p of word i goes to p + i + 1 in the bracketed bytes,
    # its newline becoming '>'; word i's '<' sits at its start + i
    wi = torch.cumsum(nl.long(), 0) - nl.long()
    bb = torch.zeros(N + V + max(maxn, 1), dtype=torch.int64, device=device)
    bb[torch.arange(N, device=device) + wi + 1] = torch.where(
        nl, ord(">"), a)
    ends = torch.nonzero(nl)[:, 0]                  # '\n' of each word
    starts = torch.cat([ends.new_zeros(1), ends[:-1] + 1])
    ar = torch.arange(V, device=device)
    bb[starts + ar] = ord("<")
    Lb = N + V
    # per bracketed position: its word, that word's end (exclusive)
    word = torch.repeat_interleave(ar, ends - starts + 2)
    end = (ends + ar + 2)[word]
    q = torch.arange(Lb, device=device)
    eos = torch.tensor([w == SENTENCE_TOKEN for w in words],
                       device=device)
    room = torch.where(eos[word], 0, end - q)       # bytes left in <word>
    # fastText keeps no 1-gram of a bracket alone (minn 1): the '<' at a
    # word's start, the '>' at its end
    lone = ((q == (starts + ar)[word]) | (room == 1)) & (room > 0)
    lone &= minn == 1
    if maxn:
        count = ((torch.clamp(room, max=maxn) - minn + 1).clamp_min(0)
                 - lone.long())
    else:
        count = torch.zeros_like(room)
    per_word = torch.zeros(V, dtype=torch.int64, device=device)
    per_word.index_add_(0, word, count)
    lens = per_word + 1
    offsets = torch.zeros(V + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lens, 0)
    ids = torch.empty(int(offsets[-1]), dtype=torch.int32, device=device)
    ids[offsets[:-1]] = ar.int()
    if maxn:
        # the n-grams of position q take the slots after the previous
        # positions' and the words' own rows, shortest first
        base = torch.cumsum(count, 0) - count + word + 1
        h = torch.full((Lb,), FNV_OFFSET, dtype=torch.int64, device=device)
        for n in range(1, maxn + 1):
            h = _fnv_step(h, bb[n - 1:n - 1 + Lb])
            if n >= minn:
                at = (room >= n) & ~(lone & (n == 1))
                slot = base + (n - minn) - (lone & (n > 1)).long()
                ids[slot[at]] = (V + h[at] % bucket).int()
    return Subwords(offsets=offsets, ids=ids, max_len=int(lens.max()),
                    rows=V + (bucket if maxn else 0))
