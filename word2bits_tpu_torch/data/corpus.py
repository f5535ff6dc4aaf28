"""Corpus tokenization and encoding.

Tokenization matches the reference ReadWord (reference
src/word2bits.cpp:131-155): words split on space, tab and newline; '\\r' is
ignored; a newline emits `</s>` after the word it ends; a final word with
no separator before EOF is dropped; words of MAX_STRING-1 or more bytes
keep their first MAX_STRING-2 bytes.

Two implementations, as in the JAX package: the C++ streaming tokenizer
(native/, built at first use) and the pure-Python path below, which give
the same counts and ids.  `use_native`: None uses the C++ one when it
builds and falls back to Python otherwise, True raises where it cannot
run, False runs Python.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from word2bits_tpu_torch import native

from word2bits_tpu_torch.data.vocab import (
    REDUCE_THRESHOLD,
    SENTENCE_TOKEN,
    Vocab,
    reduce_counts,
)

MAX_STRING = 4096  # reference src/word2bits.cpp:29


def _truncate_word(w: bytes) -> bytes:
    """The reference keeps exactly the first MAX_STRING-2 bytes of a long
    word (its write index saturates and the NUL lands on the last slot)."""
    if len(w) < MAX_STRING - 1:
        return w
    return w[: MAX_STRING - 2]


def split_tokens(data: bytes) -> List[bytes]:
    """Token stream of raw corpus bytes, `</s>` as the bytes b'</s>'."""
    data = data.replace(b"\r", b"")
    out: List[bytes] = []
    segments = data.split(b"\n")
    last = len(segments) - 1
    for si, seg in enumerate(segments):
        words = seg.split()
        if si == last and words and not (seg.endswith(b" ")
                                         or seg.endswith(b"\t")):
            words = words[:-1]   # trailing word with no separator: dropped
        out.extend(_truncate_word(w) for w in words)
        if si != last:
            out.append(b"</s>")
    return out


def count_words(path: str,
                use_native: Optional[bool] = None) -> Dict[str, int]:
    """Single-pass word-frequency count (reference LearnVocabFromTrainFile,
    src/word2bits.cpp:265-301), with the emergency ReduceVocab pruning when
    distinct words exceed 21M (:292)."""
    lib = native.native_for(use_native)
    if lib is not None:
        counts = lib.count_words(path)
        if counts is not None:
            return counts
    if use_native:
        raise RuntimeError("native tokenizer requested but not available")
    with open(path, "rb") as f:
        data = f.read()
    counts: Counter = Counter(split_tokens(data))
    min_reduce = 1
    while len(counts) > REDUCE_THRESHOLD:
        counts = Counter(reduce_counts(counts, min_reduce))
        min_reduce += 1
    out = {k.decode("utf-8", errors="surrogateescape"): v
           for k, v in counts.items()}
    out.setdefault(SENTENCE_TOKEN, 0)  # pinned at index 0 even if unseen
    return out


def encode_corpus(path: str, vocab: Vocab,
                  use_native: Optional[bool] = None) -> np.ndarray:
    """int32 id array of the corpus: OOV words dropped (reference :398),
    newlines as id 0 (`</s>`)."""
    lib = native.native_for(use_native)
    if lib is not None:
        ids = lib.encode_corpus(path, vocab.words)
        if ids is not None:
            return ids
    if use_native:
        raise RuntimeError("native tokenizer requested but not available")
    index = {w.encode("utf-8", errors="surrogateescape"): i
             for i, w in enumerate(vocab.words)}
    with open(path, "rb") as f:
        data = f.read()
    get = index.get
    ids = [i for i in map(get, split_tokens(data)) if i is not None]
    return np.asarray(ids, dtype=np.int32)


def build_vocab(path: str, min_count: int = 5,
                use_native: Optional[bool] = None) -> Vocab:
    """Corpus scan -> sorted, pruned Vocab."""
    return Vocab.from_counts(count_words(path, use_native=use_native),
                             min_count=min_count)
