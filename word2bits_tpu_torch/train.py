"""Training orchestration: the reference TrainModel
(reference src/word2bits.cpp:518-577) on one CUDA device (or the CPU).

Per run: vocab build (or cached read), reference LCG init, alias table;
per epoch a host-built subsampled epoch array (fresh randomness each epoch),
then chunks of S synchronous steps on the fused (V, 2D) table, with the
JAX package's words-consumed accounting for the LR schedule and words/sec.

The table is stored unpadded: the JAX package pads rows and columns only
for its TPU DMA tiles.  The loss accumulates on the device and is fetched
once per epoch (and for progress lines at -debug > 1).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.data.corpus import build_vocab, encode_corpus
from word2bits_tpu_torch.data.pipeline import iter_epoch_segments
from word2bits_tpu_torch.data.vocab import Vocab
from word2bits_tpu_torch.io.vectors import output_vectors, write_vectors
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_fused import (
    deinterleave, interleave, make_fused_train_chunk, params_to_numpy)
from word2bits_tpu_torch.models.init import init_params
from word2bits_tpu_torch.sampling.unigram import AliasTable, build_alias_table

@dataclass
class TrainResult:
    vocab: Vocab
    u: np.ndarray            # float32 [V, D]
    v: np.ndarray            # float32 [V, D]
    epoch_losses: List[float]
    words_per_sec: float     # words consumed per wall-second of the loop
    steps: int               # steps executed


def _log(cfg: Word2BitsConfig, msg: str, end="\n"):
    if cfg.debug > 0:
        print(msg, end=end, flush=True)


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for another device; no silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(or set W2B_FORCE_CPU=1 at the CLI) to run on "
                           "the CPU")
    return dev


def prepare(cfg: Word2BitsConfig) -> Tuple[Vocab, np.ndarray]:
    """Vocab (built or cached) + encoded corpus ids."""
    if cfg.train_file is None:
        raise ValueError("train_file is required")
    if cfg.read_vocab_file:
        vocab = Vocab.load(cfg.read_vocab_file, min_count=cfg.min_count)
    else:
        vocab = build_vocab(cfg.train_file, min_count=cfg.min_count)
    if cfg.save_vocab_file:
        vocab.save(cfg.save_vocab_file)
    _log(cfg, f"Vocab size: {vocab.size}")
    _log(cfg, f"Words in train file: {vocab.train_words}")
    return vocab, encode_corpus(cfg.train_file, vocab)


def segment_capacity(cfg: Word2BitsConfig, n_tokens: int) -> Tuple[int, int]:
    """(seg_tokens, capacity): epoch arrays are padded to a fixed capacity;
    corpora beyond cfg.segment_tokens stream in fixed-size segments."""
    B, S = cfg.batch_size, cfg.steps_per_chunk
    seg_tokens = min(n_tokens, cfg.segment_tokens) or 1
    capacity = ((seg_tokens + S * B + 8 + 1023) // 1024) * 1024
    return seg_tokens, capacity


@dataclass
class Engine:
    """The chunk callable and its state: the fused table and the alias
    table, both on the training device."""

    chunk_fn: Callable
    table: torch.Tensor
    alias: AliasTable


def build_engine(cfg: Word2BitsConfig, vocab: Vocab, u: torch.Tensor,
                 v: torch.Tensor, hyper: CBOWHyper, device) -> Engine:
    """The fused-table engine (the JAX package's train.build_engine fused
    branch): interleaved table, shared negatives, banded sums, `add` or
    `span` scatter, optional context kernel."""
    if not (cfg.fused_tables and cfg.neg_sharing):
        raise ValueError("-fused-tables 0 / -neg-sharing 0 (the split-table "
                         "slab engine) is not implemented by "
                         "word2bits_tpu_torch yet; pass -fused-tables 1 "
                         "-neg-sharing G")
    if not cfg.banded_tile:
        raise ValueError("-banded-tile 0 (the shifted-sum windowed path) is "
                         "not implemented by word2bits_tpu_torch yet; pass "
                         "-banded-tile N")
    chunk_fn = make_fused_train_chunk(
        hyper, vocab.size, cfg.batch_size, cfg.steps_per_chunk,
        neg_sharing=cfg.neg_sharing, neg_pool=cfg.neg_pool,
        banded=cfg.banded_tile, scatter_impl=cfg.scatter_impl,
        context_pallas=cfg.context_pallas)
    table = interleave(u, v).to(device)
    alias = build_alias_table(vocab.unigram_weights()).to(device)
    return Engine(chunk_fn=chunk_fn, table=table, alias=alias)


def train(cfg: Word2BitsConfig,
          vocab: Optional[Vocab] = None,
          encoded: Optional[np.ndarray] = None,
          max_steps: Optional[int] = None,
          device=None) -> TrainResult:
    """Full training run on `device` (default cuda)."""
    dev = resolve_device(device)
    # float32 products stay float32: no TF32 on the port's path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if vocab is None or encoded is None:
        vocab, encoded = prepare(cfg)

    V, D = vocab.size, cfg.size
    B, S, W = cfg.batch_size, cfg.steps_per_chunk, cfg.window
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=D, window=W,
                      negative=cfg.negative, reg=cfg.reg)
    u, v = init_params(V, D, init=cfg.init, seed=cfg.seed,
                       dtype=getattr(torch, cfg.dtype))
    engine = build_engine(cfg, vocab, u, v, hyper, dev)
    del u, v
    table, chunk_fn = engine.table, engine.chunk_fn
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    train_words = vocab.train_words
    denom = float(cfg.iter) * train_words + 1.0
    seg_tokens, capacity = segment_capacity(cfg, len(encoded))
    total_len = max(len(encoded), 1)

    epoch_losses: List[float] = []
    total_steps = 0
    words_done = 0.0
    t_train0 = time.perf_counter()
    t_print = 0.0
    stop = False
    for epoch in range(cfg.iter):
        _log(cfg, f"Starting epoch: {epoch}")
        epoch_rng = np.random.default_rng([cfg.seed, epoch])
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        for ea in iter_epoch_segments(encoded, vocab.counts, cfg.sample,
                                      train_words, W, epoch_rng, seg_tokens,
                                      capacity=capacity):
            tokens = torch.from_numpy(ea.tokens).to(dev, torch.int64)
            sents = torch.from_numpy(ea.sent_ids).to(dev, torch.int64)
            n_centers = max(ea.n_tokens, 1)
            # this segment accounts for its share of the epoch's words
            seg_words = train_words * ea.source_len / total_len
            wca_per_step = B * seg_words / n_centers
            n_steps = math.ceil(ea.n_tokens / B)
            for ci in range(max(1, math.ceil(n_steps / S))):
                # only the steps that hold centers run: a trailing
                # all-padding step updates nothing
                chunk_steps = min(S, n_steps - ci * S)
                scalars = ChunkScalars(
                    base0=W + ci * S * B, alpha0=cfg.effective_alpha,
                    wca_start=words_done, wca_per_step=wca_per_step,
                    denom=denom)
                table, loss = chunk_fn(table, tokens, sents, engine.alias,
                                       scalars, gen,
                                       n_steps=max(chunk_steps, 1))
                words_done += chunk_steps * wca_per_step
                loss_acc = loss_acc + loss
                total_steps += max(chunk_steps, 1)
                if cfg.debug > 1 and time.perf_counter() - t_print > 0.5:
                    t_print = time.perf_counter()
                    a0 = cfg.effective_alpha
                    alpha_now = max(a0 * (1 - words_done / denom), a0 * 1e-4)
                    wps = words_done / max(t_print - t_train0, 1e-9)
                    print(f"\rAlpha: {alpha_now:.6f}  "
                          f"Progress: {min(words_done / denom * 100, 100.0):.2f}%  "
                          f"Cost: {float(loss_acc):.2f} "
                          f"Words/sec: {wps / 1000:.2f}k  ",
                          end="", flush=True)
                if max_steps is not None and total_steps >= max_steps:
                    stop = True
                    break
            if stop:
                break
        if not stop:
            # exact end-of-epoch word count (reference: all threads done)
            words_done = (epoch + 1) * float(train_words)
        if cfg.debug > 1:
            print()
        epoch_loss = float(loss_acc)   # host fetch = device sync
        _log(cfg, f"Epoch Loss: {epoch_loss:.6f}")
        epoch_losses.append(epoch_loss)
        if cfg.save_every_epoch and cfg.output_file and cfg.classes == 0:
            _write_output(f"{cfg.output_file}_epoch{epoch}", vocab, table,
                          cfg)
        if stop:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_train0
    wps = words_done / max(wall, 1e-9)
    _log(cfg, f"Trained {total_steps} steps in {wall:.6f} s: "
              f"{wps:.1f} words/sec, "
              f"{wall / max(total_steps, 1) * 1e6:.1f} us/step")

    if cfg.output_file:
        if cfg.classes == 0:
            _write_output(cfg.output_file, vocab, table, cfg)
        else:
            # reference quirk: -classes != 0 creates an empty output file
            _log(cfg, "WARNING: -classes is parsed but unimplemented in the "
                      "reference; writing an empty file for parity")
            open(cfg.output_file, "wb").close()

    uu, vv = deinterleave(params_to_numpy(table))
    return TrainResult(vocab=vocab, u=uu, v=vv, epoch_losses=epoch_losses,
                       words_per_sec=wps, steps=total_steps)


def _write_output(path: str, vocab: Vocab, table: torch.Tensor,
                  cfg: Word2BitsConfig):
    u, v = deinterleave(params_to_numpy(table))
    write_vectors(path, vocab.words, output_vectors(u, v, cfg.bitlevel),
                  binary=cfg.binary)
