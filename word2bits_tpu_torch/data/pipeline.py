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


def expected_kept_fraction(counts: np.ndarray, sample: float,
                           train_words: int) -> float:
    """E[kept tokens] / train_words under the subsampling distribution."""
    if train_words <= 0:
        return 1.0
    probs = np.minimum(subsample_keep_probs(counts, sample, train_words), 1.0)
    return float((probs * counts).sum() / max(train_words, 1))


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


def cold_positions(tokens: np.ndarray, batch_size: int, window: int,
                   n_rows: int, hot_rows: int, pad_mult: int = 256,
                   min_width: int = 0) -> np.ndarray:
    """Per-step compaction map of the slab scatter's cold rows (the
    hot/cold split of models/cbow_fused.py, `-hot-rows`), bit for bit the
    JAX package's.

    Global step t scatters the slab window tokens[t*B : t*B + B+2W]; ids <
    hot_rows go to the dense head accumulation, the rest scatter
    compacted.  Returns int32 [n_rows, C]: the positions within each
    step's window that hold an id >= hot_rows, then -1.  C is the largest
    cold count over the rows, at least `min_width`, rounded up to
    `pad_mult`; the training loop passes the previous width as min_width
    so the width stays stable across segments."""
    B, W = int(batch_size), int(window)
    span = B + 2 * W
    ids = np.maximum(np.asarray(tokens, np.int32), 0)
    need = n_rows * B + 2 * W
    if len(ids) < need:  # right margin for the final (padding-only) steps
        ids = np.concatenate([ids, np.zeros(need - len(ids), np.int32)])
    windows = np.lib.stride_tricks.sliding_window_view(ids, span)[::B][:n_rows]
    cold = windows >= hot_rows                       # [n_rows, span] (a view)
    counts = cold.sum(axis=1)
    C = max(int(counts.max(initial=0)), min_width, 1)
    C = ((C + pad_mult - 1) // pad_mult) * pad_mult
    out = np.full((n_rows, C), -1, np.int32)
    # a stable argsort per row puts the cold positions first, in order
    w = min(C, span)  # C may exceed span when min_width demands it
    for lo in range(0, n_rows, 1024):
        hi = min(lo + 1024, n_rows)
        order = np.argsort(~cold[lo:hi], axis=1, kind="stable")[:, :w]
        ok = np.take_along_axis(cold[lo:hi], order, axis=1)
        out[lo:hi, :w] = np.where(ok, order, -1).astype(np.int32)
    return out


def build_epoch_arrays(encoded: np.ndarray, counts: np.ndarray, sample: float,
                       train_words: int, window: int, rng: np.random.Generator,
                       capacity: int | None = None,
                       uniforms: np.ndarray | None = None) -> EpochArrays:
    """One epoch's subsampled, sentence-segmented, halo-padded arrays.
    `uniforms` injects the subsampling draws (one per token, as the JAX
    package's argument: the device build of data/device_pipeline.py is
    held bit-equal to this one on the same float32 draws)."""
    encoded = np.asarray(encoded, dtype=np.int32)
    is_sent = encoded == 0

    keep_probs = subsample_keep_probs(counts, sample, train_words)
    u = rng.random(encoded.shape[0]) if uniforms is None else uniforms
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
