"""The device epoch: subsample, compact and segment one epoch on the card.

The counterpart of the JAX package's data/device_pipeline.py.  The host
build (data/pipeline.build_epoch_arrays) rebuilds each epoch's kept-token
and sentence-id arrays in numpy and uploads them; here the encoded corpus
is uploaded once and each epoch is built from it by a few torch ops on its
device:

  1. keep mask: `uniforms <= keep_probs[encoded]` in float32 (reference
     src/word2bits.cpp:401-407); `</s>` is never subsampled;
  2. compaction: exclusive cumulative sums give each kept word its
     destination, and one indexed store writes it there; a destination
     past the capacity goes to a spare slot that is cut off (the JAX
     `.at[idx].set(mode="drop")`);
  3. sentence ids: a raw id counts the kept `</s>` before a token; the
     compacted stream is re-segmented every MAX_SENTENCE_LENGTH = 1000 kept
     words (reference :32, :408-411) from the running maximum of the
     sentence starts.

Given the same float32 uniforms the arrays are bit-equal to the host
build's and to the JAX package's `build_with_uniforms`
(tests/test_torch_device_epoch.py).  The cumulative sums run in int32, as
in the JAX package (`torch.cumsum` of int32 or bool returns int64 unless
told otherwise).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.data.pipeline import MAX_SENTENCE_LENGTH, PAD_ID

EpochTensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def _build(capacity: int, halo: int, encoded: torch.Tensor,
           keep_probs: torch.Tensor, uniforms: torch.Tensor) -> EpochTensors:
    """(tokens int32 [halo + capacity + halo], sents int32 [same], n_tokens
    int32 []) from encoded int [n] (id 0 = `</s>`), keep_probs float32 [V]
    and uniforms float32 [n], all on one device."""
    dev = encoded.device
    total = halo + capacity + halo
    enc = encoded.long()
    is_sent = enc == 0
    keep = (uniforms <= keep_probs[enc]) | is_sent
    final = keep & ~is_sent

    # sentence id of each raw token: the kept `</s>` strictly before it
    sent_raw = _exclusive_cumsum((keep & is_sent).to(torch.int32))
    finals = final.to(torch.int32)
    dest = _exclusive_cumsum(finals)          # position among kept words
    n_tokens = finals.sum(dtype=torch.int32)

    # compaction: kept words to halo + dest; everything else (and a kept
    # word past the capacity) to the spare slot `total`, cut off below
    pos = halo + dest
    idx = torch.where(final & (pos < total), pos, total).long()
    tokens = torch.full((total + 1,), int(PAD_ID), dtype=torch.int32,
                        device=dev)
    sraw = torch.full((total + 1,), -1, dtype=torch.int32, device=dev)
    tokens[idx] = enc.to(torch.int32)
    sraw[idx] = sent_raw
    tokens, sraw = tokens[:total], sraw[:total]

    # re-segment: a sentence starts where the raw id changes, or every
    # MAX_SENTENCE_LENGTH kept words within one raw sentence
    valid = sraw >= 0
    prev = torch.cat([torch.full((1,), -2, dtype=torch.int32, device=dev),
                      sraw[:-1]])
    is_new = valid & (sraw != prev)
    pos_idx = torch.arange(total, dtype=torch.int32, device=dev)
    start_idx = torch.cummax(torch.where(is_new, pos_idx, -1), 0).values
    in_sent = pos_idx - start_idx
    boundary = is_new | (valid & (in_sent > 0)
                         & (in_sent % MAX_SENTENCE_LENGTH == 0))
    sent_final = torch.cumsum(boundary.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    sents = torch.where(valid, sent_final, -1).to(torch.int32)
    return tokens, sents, n_tokens


def make_device_epoch_builder(capacity: int, halo: int) -> Callable:
    """build(encoded, keep_probs, gen) -> (tokens, sents, n_tokens): one
    epoch (or segment) built on encoded's device, the per-token uniforms
    drawn from `gen` (a torch.Generator on that device; the host build
    draws from numpy's: the same distribution, other draws).

    encoded:    int [n] on the device (id 0 = `</s>`), uploaded once;
    keep_probs: float [V] from pipeline.subsample_keep_probs."""

    def build(encoded: torch.Tensor, keep_probs: torch.Tensor,
              gen: torch.Generator) -> EpochTensors:
        uniforms = torch.rand(encoded.shape, generator=gen,
                              dtype=torch.float32, device=encoded.device)
        return _build(capacity, halo, encoded,
                      keep_probs.to(torch.float32), uniforms)

    return build


def build_with_uniforms(capacity: int, halo: int, encoded, keep_probs,
                        uniforms, device=None) -> EpochTensors:
    """The builder with injected uniforms (numpy arrays or tensors), on
    `device` (default cuda), so that its arrays can be held bit for bit
    against the host build and the JAX package's."""
    from word2bits_tpu_torch.train import resolve_device

    dev = resolve_device(device)

    def put(a, dtype):
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return t.to(device=dev, dtype=dtype)

    return _build(capacity, halo, put(encoded, torch.int32),
                  put(keep_probs, torch.float32), put(uniforms, torch.float32))
