"""Epoch array construction: subsampling + sentence segmentation + padding
(numpy, host side).

Once per epoch the corpus becomes a flat kept-token array plus a parallel
sentence-id array, padded to a fixed capacity with a W-token halo on both
sides so that every step slices B+2W positions in bounds.

Reference semantics (reference src/word2bits.cpp:394-413): keep
probability (sqrt(cn/(s*T)) + 1) * (s*T)/cn, discarded when below a uniform
draw; `</s>` is never subsampled; sentences break at `</s>` and at 1000
kept words; context windows never cross a sentence boundary.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_SENTENCE_LENGTH = 1000  # reference src/word2bits.cpp:32
PAD_ID = np.int32(-1)


def subsample_keep_probs(counts: np.ndarray, sample: float,
                         train_words: int) -> np.ndarray:
    """Per-word keep probability (may exceed 1); sample<=0 disables."""
    counts = counts.astype(np.float64)
    if sample <= 0:
        return np.ones_like(counts)
    st = sample * float(train_words)
    with np.errstate(divide="ignore", invalid="ignore"):
        ran = (np.sqrt(counts / st) + 1.0) * st / counts
    ran[~np.isfinite(ran)] = 1.0  # count==0 rows (only `</s>` can be 0)
    return ran


@dataclass
class EpochArrays:
    """One epoch (or segment) of training data.

    tokens:   int32 [halo + capacity + halo] — kept ids, PAD_ID elsewhere
    sent_ids: int32 [same] — sentence index per token; -1 on padding
    n_tokens: number of valid centers
    halo:     PAD slots before the data (the window W)
    """

    tokens: np.ndarray
    sent_ids: np.ndarray
    n_tokens: int
    halo: int
    source_len: int = 0  # encoded tokens this segment was built from


def iter_epoch_segments(encoded: np.ndarray, counts: np.ndarray, sample: float,
                        train_words: int, window: int,
                        rng: np.random.Generator, segment_tokens: int,
                        capacity: int | None = None):
    """Yield EpochArrays for fixed-size segments of one epoch (hard cuts at
    segment_tokens; all segments share one capacity)."""
    n = len(encoded)
    segment_tokens = max(segment_tokens, 1)
    if capacity is None:
        capacity = ((min(n, segment_tokens) + 1023) // 1024) * 1024
    for start in range(0, n, segment_tokens):
        seg = encoded[start:start + segment_tokens]
        yield build_epoch_arrays(seg, counts, sample, train_words, window,
                                 rng, capacity=capacity)


def build_epoch_arrays(encoded: np.ndarray, counts: np.ndarray, sample: float,
                       train_words: int, window: int, rng: np.random.Generator,
                       capacity: int | None = None) -> EpochArrays:
    """One epoch's subsampled, sentence-segmented, halo-padded arrays."""
    encoded = np.asarray(encoded, dtype=np.int32)
    is_sent = encoded == 0

    keep_probs = subsample_keep_probs(counts, sample, train_words)
    u = rng.random(encoded.shape[0])
    keep = (u <= keep_probs[encoded]) | is_sent  # `</s>` never subsampled

    kept = encoded[keep]
    kept_is_sent = kept == 0

    # sentence index increments after each `</s>`; the `</s>` tokens
    # themselves are then dropped
    sent_base = np.cumsum(kept_is_sent, dtype=np.int64)
    sent_base = np.concatenate([[0], sent_base[:-1]])
    tokens = kept[~kept_is_sent]
    sent_of_tok = sent_base[~kept_is_sent]

    # split sentences longer than MAX_SENTENCE_LENGTH kept words
    if tokens.shape[0] > 0:
        change = np.concatenate([[True], sent_of_tok[1:] != sent_of_tok[:-1]])
        starts = np.flatnonzero(change)
        pos_in_sent = np.arange(tokens.shape[0], dtype=np.int64)
        pos_in_sent -= np.repeat(starts,
                                 np.diff(np.append(starts, tokens.shape[0])))
        sub = pos_in_sent // MAX_SENTENCE_LENGTH
        combo = (sent_of_tok * ((pos_in_sent.max() // MAX_SENTENCE_LENGTH) + 2)
                 + sub)
        # combo is nondecreasing, so consecutive-group ranking == unique
        sent_final = np.cumsum(
            np.concatenate([[0], (combo[1:] != combo[:-1]).astype(np.int32)]),
            dtype=np.int32)
    else:
        sent_final = np.zeros(0, dtype=np.int32)

    n = tokens.shape[0]
    halo = int(window)
    if capacity is None:
        capacity = ((len(encoded) + 1023) // 1024) * 1024
    total = halo + capacity + halo
    out_tokens = np.full(total, PAD_ID, dtype=np.int32)
    out_sents = np.full(total, -1, dtype=np.int32)
    out_tokens[halo:halo + n] = tokens
    out_sents[halo:halo + n] = sent_final
    return EpochArrays(tokens=out_tokens, sent_ids=out_sents,
                       n_tokens=n, halo=halo, source_len=len(encoded))
