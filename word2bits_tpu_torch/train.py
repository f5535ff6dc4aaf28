"""Training orchestration: the reference TrainModel
(reference src/word2bits.cpp:518-577) on one CUDA device (or the CPU).

Per run: vocab build (or cached read), reference LCG init, alias table;
per epoch a subsampled epoch array (fresh randomness each epoch), then
chunks of S synchronous steps, with the JAX package's words-consumed
accounting for the LR schedule and words/sec.  Three engines, chosen as
the JAX package's train.build_engine chooses them: the fused (V, 2D) table
(`-fused-tables 1 -neg-sharing G` on CBOW, models/cbow_fused.py), skip-gram
on split tables (`-model skipgram`, models/skipgram.py) and the split
(u, v) slab engine (every other CBOW configuration, the reference default
among them: per-center negatives, models/cbow_slab.py); and the port's
fourth and fifth, fastText's subword skip-gram (`-model fasttext`,
models/subword.py) and its CBOW with position weights (`-model
fasttext-cbow`, models/subword_cbow.py, a third table d [2W, D] of
position weights) on split tables whose u has the n-gram buckets' rows
after the words', each word's subword rows built once a call
(data/vocab.subword_rows) and the negatives drawn from count^0.5.

The epoch is built where the JAX package builds it (`device_epoch_on`):
under the auto -device-epoch on the training device from the encoded
corpus uploaded once (data/device_pipeline.py, its draws from a generator
seeded by (seed, epoch[, segment]), so a resumed run subsamples as the
first run did), else on the host (data/pipeline.py, numpy draws seeded
the same way).  With `-hot-rows` on the fused engine a host-built segment
also gets its cold-position map (data/pipeline.cold_positions); the
device epoch has none, as in the JAX package (-neg-dense-hot under the
auto -device-epoch keeps the plain slab scatter).

The tables are stored unpadded (the JAX package pads rows and columns only
for its TPU DMA tiles), allocated once on the training device and filled
there in row blocks (models/init.py), and exported in row blocks
(`write_output`, each block quantized by kernel 4): at the 3.7M x 800d
capacity configuration the host never holds a copy of them.  With
-checkpoint-dir the tables are saved after every epoch (or, with
-checkpoint-every-epoch 0, after the last) as the JAX package's state.npz,
streamed in the same row blocks, and -resume 1 reads them back the same
way into tables allocated once (`save_checkpoint`, `load_checkpoint`).
The loss accumulates on the device and is fetched once per epoch (and for
progress lines at -debug > 1).  `on_epoch_end(epoch, u, v, loss)` gets
each epoch's tables as host arrays (`on_epoch_end(epoch, u, v, d, loss)`
with -model fasttext-cbow); `-profile-dir` traces one steady chunk
with torch.profiler into a Chrome trace there.  While a torch profiler
records, the loop's phases, chunks and steps record their spans
(utils/trace.py); TrainResult.seconds comes from the same sites.

With `-mesh-shape` the run is one rank of a (data, vocab) mesh
(parallel/): `train` joins the process group (torchrun's, or a one-rank
group it starts for a mesh of one shard, parallel/trainer.mesh_session),
the tables are this rank's rows (initialized or read from the checkpoint
for those rows alone), the engine is parallel/trainer.ShardedTrainer, rank
0 builds each epoch's arrays and broadcasts them, and only rank 0 logs and
writes the vector, checkpoint and per-epoch files, from the tables
`ShardedTrainer.params` gathers to it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
import zipfile
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from word2bits_tpu_torch.config import SUBWORD_MODELS, Word2BitsConfig
from word2bits_tpu_torch.data.corpus import build_vocab, encode_corpus
from word2bits_tpu_torch.data.device_pipeline import \
    make_device_epoch_builder
from word2bits_tpu_torch.data.pipeline import (cold_positions,
                                               iter_epoch_segments,
                                               subsample_keep_probs)
from word2bits_tpu_torch.data.vocab import Subwords, Vocab, subword_rows
from word2bits_tpu_torch.io.packed import PackedWriter, pack_codes
from word2bits_tpu_torch.io.vectors import VectorWriter
from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas
from word2bits_tpu_torch.kernels.subword_mean import subword_mean
from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
from word2bits_tpu_torch.models.cbow_fused import (deinterleave,
                                                   make_fused_train_chunk)
from word2bits_tpu_torch.models.cbow_slab import make_slab_train_chunk
from word2bits_tpu_torch.models.init import (init_fused_table, init_params,
                                             init_position_weights)
from word2bits_tpu_torch.models.skipgram import make_skipgram_train_chunk
from word2bits_tpu_torch.models.subword import make_subword_train_chunk
from word2bits_tpu_torch.models.subword_cbow import \
    make_subword_cbow_train_chunk
from word2bits_tpu_torch.models.step_graph import StepCounts
from word2bits_tpu_torch.sampling.unigram import (AliasTable,
                                                  build_alias_table,
                                                  build_stratified_tables)
from word2bits_tpu_torch.utils import trace
from word2bits_tpu_torch.utils.trace import phase, span

# rows per export, checkpoint and `cli convert` block: about 16M values
_EXPORT_VALUES = 1 << 24
CHECKPOINT_FILE = "state.npz"


Tables = Tuple[torch.Tensor, ...]   # (fused (V, 2D) table,), (u, v) or
#                                     fasttext-cbow's (u, v, d)


@dataclass
class TrainResult:
    vocab: Vocab
    tables: Tables           # the trained tables, on their device (on a
    #                          mesh: rank 0's the whole gathered (u, v),
    #                          the other ranks' their own rows)
    epoch_losses: List[float]
    words_per_sec: float     # words consumed per wall-second of the loop
    steps: int               # steps executed
    # per chunk: (steps, words consumed, seconds on the device's clock —
    # CUDA events — or the host's on the CPU)
    chunks: List[Tuple[int, float, float]] = field(default_factory=list)
    chunk_losses: List[float] = field(default_factory=list)  # per chunk
    # host seconds of the phases: init (or load, when resumed), alias,
    # epoch_build (its wait for the device excluded: epoch_build_wait),
    # upload, cold_map, checkpoint (the saves), export, issue (inside the
    # chunk calls) and capture (the CUDA graph captures inside them)
    seconds: Dict[str, float] = field(default_factory=dict)
    start_epoch: int = 0     # the first epoch run (after a resume: > 0)
    words_done: float = 0.0  # the LR schedule's words at the end
    # of the `steps`: those replayed from a CUDA graph and those run
    # eagerly (models/step_graph.py)
    steps_replayed: int = 0
    steps_eager: int = 0


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
    """The chunk callable and its state: the tables and the alias table
    (the (hot, cold) pair with -neg-stratify, the cold stratum's with
    -neg-dense-hot), all on the training device.  chunk_fn(*tables, tokens,
    sents, alias, scalars, gen, n_steps=...[, cold_pos=...]) returns
    (*tables, loss); `cold_split` says that it takes each segment's
    cold-position map (cold_map); `counts` are the fused chunk's step
    counts (models/step_graph.StepCounts), None for the other engines,
    whose steps all run eagerly; `subwords` the subword model's rows of
    each word (data/vocab.Subwords), None for the other models."""

    chunk_fn: Callable
    tables: Tables
    alias: AliasTable | Tuple[AliasTable, AliasTable]
    cold_split: bool = False
    sharded: Optional[object] = None   # the mesh's ShardedTrainer
    counts: Optional[StepCounts] = None
    subwords: Optional[Subwords] = None


def init_tables(cfg: Word2BitsConfig, vocab_size: int, device,
                comm=None) -> Tables:
    """The engine's tables, filled on `device`: (the fused (V, 2D) table,)
    with -fused-tables 1 on CBOW, else (u, v), u with the n-gram buckets'
    rows after the words' with -model fasttext, and (u, v, d), d the
    position weights, with -model fasttext-cbow; on a mesh (`comm`, a
    parallel.mesh.Collectives) this shard's rows of (u, v)."""
    if comm is not None:
        from word2bits_tpu_torch.parallel.trainer import init_local_tables
        return init_local_tables(cfg, vocab_size, comm)
    kw = dict(init=cfg.init, seed=cfg.seed, dtype=getattr(torch, cfg.dtype),
              device=device)
    if cfg.fused_on:
        return (init_fused_table(vocab_size, cfg.size, **kw),)
    tables = init_params(vocab_size, cfg.size, buckets=cfg.subword_buckets,
                         **kw)
    if cfg.model == "fasttext-cbow":
        tables += (init_position_weights(cfg.window, cfg.size, device),)
    return tables


def build_engine(cfg: Word2BitsConfig, vocab: Vocab, tables: Tables,
                 hyper: CBOWHyper, comm=None) -> Engine:
    """The JAX package's train.build_engine: with -mesh-shape the sharded
    trainer on this rank's rows (`comm`: its parallel.mesh.Collectives;
    parallel/trainer.py); else, on one device, the fused-table engine with
    -fused-tables 1 on CBOW (shared negatives; the `add`, `span`, `grmw` or
    RMW scatter, the block dedup, the hot/cold split; optional context and
    score kernels), skip-gram with -model skipgram (per-center, shared or,
    with -neg-per-pair 1, per-pair negatives, dense-hot, the block
    dedup), the subword skip-gram with -model fasttext (per-pair
    negatives from count^0.5, each word's subword rows built here) and its
    CBOW with position weights with -model fasttext-cbow (per-center
    negatives from count^0.5, the same rows), else
    the split-table slab
    engine (per-center or shared negatives; the `add` or `span` scatter or
    the block dedup; optional context and score kernels)."""
    B, S, V = cfg.batch_size, cfg.steps_per_chunk, vocab.size
    dev = tables[0].device
    strat_lanes = dense_hot = subwords = None
    if cfg.model in SUBWORD_MODELS:
        # fastText's negatives table: count^0.5 (Dictionary::getCounts)
        alias = build_alias_table(vocab.unigram_weights(0.5)).to(dev)
        subwords = subword_rows(vocab.words, cfg.minn, cfg.maxn, cfg.bucket,
                                dev)
        if subwords.rows != tables[0].shape[0]:
            raise ValueError(f"the input table holds {tables[0].shape[0]} "
                             f"rows, the vocabulary and buckets "
                             f"{subwords.rows}")
    elif cfg.neg_stratify:
        st = build_stratified_tables(vocab.unigram_weights(), cfg.hot_rows)
        strat_lanes = st.lane_split(cfg.negative)
        alias = (st.hot.to(dev), st.cold.to(dev))
    elif cfg.neg_dense_hot:
        if cfg.hot_rows >= V:
            raise ValueError("-neg-dense-hot needs -hot-rows < vocab size")
        st = build_stratified_tables(vocab.unigram_weights(), cfg.hot_rows)
        dense_hot = st.dense_split(cfg.negative)
        alias = st.cold.to(dev)
    else:
        alias = build_alias_table(vocab.unigram_weights()).to(dev)
    if cfg.mesh_shape:
        from word2bits_tpu_torch.parallel.trainer import ShardedTrainer
        if comm is None:
            raise ValueError("-mesh-shape needs the rank's collectives "
                             "(parallel/trainer.mesh_session)")
        sharded = ShardedTrainer(cfg, V, comm, *tables, dense_hot=dense_hot)

        def sharded_chunk(u, v, tokens, sents, atab, scalars, gen=None,
                          n_steps=None, shrinks=None, negs=None):
            loss = sharded.run_chunk(tokens, sents, atab, scalars, gen,
                                     n_steps, shrinks, negs)
            return sharded.u, sharded.v, loss

        return Engine(chunk_fn=sharded_chunk, tables=tuple(tables),
                      alias=alias, sharded=sharded)
    if cfg.fused_on:
        chunk_fn = make_fused_train_chunk(
            hyper, V, B, S, neg_sharing=cfg.neg_sharing,
            neg_pool=cfg.neg_pool, banded=cfg.banded_tile,
            scatter_impl=cfg.scatter_impl,
            context_pallas=cfg.context_pallas, span_chunk=cfg.span_chunk,
            use_pallas=cfg.use_pallas, dedup_block=cfg.dedup_block,
            hot_rows=cfg.hot_rows, strat_lanes=strat_lanes,
            dense_hot=dense_hot, hot_pallas=cfg.hot_pallas,
            rmw_scatter=cfg.rmw_scatter)
    elif cfg.model == "fasttext":
        chunk_fn = make_subword_train_chunk(hyper, V, B, S, subwords)
    elif cfg.model == "fasttext-cbow":
        chunk_fn = make_subword_cbow_train_chunk(hyper, V, B, S, subwords)
    elif cfg.model == "skipgram":
        chunk_fn = make_skipgram_train_chunk(
            hyper, V, B, S, neg_sharing=cfg.neg_sharing,
            dedup_block=cfg.dedup_block, neg_pool=cfg.neg_pool,
            hot_rows=cfg.hot_rows, dense_hot=dense_hot,
            neg_per_pair=cfg.neg_per_pair)
    else:
        chunk_fn = make_slab_train_chunk(
            hyper, V, B, S, neg_sharing=cfg.neg_sharing,
            use_pallas=cfg.use_pallas, dedup_block=cfg.dedup_block,
            neg_pool=cfg.neg_pool, banded=cfg.banded_tile,
            scatter_impl=cfg.scatter_impl,
            context_pallas=cfg.context_pallas)
    return Engine(chunk_fn=chunk_fn, tables=tuple(tables), alias=alias,
                  cold_split=bool(cfg.fused_on and cfg.hot_rows
                                  and not cfg.device_epoch_on),
                  counts=getattr(chunk_fn, "counts", None),
                  subwords=subwords)


def cold_map(cfg: Word2BitsConfig, tokens: np.ndarray, capacity: int,
             min_width: int = 0) -> np.ndarray:
    """A segment's cold-position map for the hot/cold split (int32
    [capacity // B + S + 2, C]), as the JAX package's segment loop builds
    it; pass the previous segment's width as min_width."""
    B, S = cfg.batch_size, cfg.steps_per_chunk
    return cold_positions(tokens, B, cfg.window, capacity // B + S + 2,
                          cfg.hot_rows, min_width=min_width)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _ChunkClock:
    """Per-chunk time: CUDA events on the card (no sync inside the loop),
    the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: List[Tuple[int, float, object, object]] = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self):
        return self._now()

    def stop(self, start, steps: int, words: float) -> None:
        self.marks.append((steps, words, start, self._now()))

    def chunks(self) -> List[Tuple[int, float, float]]:
        """Call after the device is synchronized."""
        if self.cuda:
            return [(n, w, a.elapsed_time(b) / 1e3)
                    for n, w, a, b in self.marks]
        return [(n, w, b - a) for n, w, a, b in self.marks]


_EPOCH_STREAM = 0x65706F63   # keeps the epoch draws apart from resume_seed's


def epoch_seed(seed: int, epoch: int, segment: Optional[int] = None) -> int:
    """The seed of the device epoch's generator: (seed, epoch) for a corpus
    of one segment, (seed, epoch, segment) for several."""
    # segment + 1: numpy's SeedSequence treats a trailing 0 as absent
    key = [_EPOCH_STREAM, seed, epoch] + ([] if segment is None
                                          else [segment + 1])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


class DeviceCorpus:
    """The encoded corpus on the training device as [nseg, seg_len] int32
    (the tail segment padded with `</s>`, which is never subsampled and
    keeps no token), with the float32 keep probabilities and the builder
    of each epoch's arrays (data/device_pipeline.py)."""

    def __init__(self, cfg: Word2BitsConfig, vocab: Vocab,
                 encoded: np.ndarray, seg_tokens: int, capacity: int, dev):
        self.seg_len = int(max(min(len(encoded), seg_tokens), 1))
        self.nseg = max(1, -(-len(encoded) // self.seg_len))
        self.pad = self.nseg * self.seg_len - len(encoded)
        enc = np.asarray(encoded, np.int32)
        if self.pad:
            enc = np.concatenate([enc, np.zeros(self.pad, np.int32)])
        self.encoded = torch.from_numpy(enc.reshape(self.nseg, self.seg_len)
                                        ).to(dev)
        self.keep_probs = torch.from_numpy(subsample_keep_probs(
            vocab.counts, cfg.sample, vocab.train_words).astype(np.float32)
        ).to(dev)
        self.build = make_device_epoch_builder(capacity, cfg.window)
        self.seed, self.dev = cfg.seed, dev

    def segments(self, epoch: int, seconds: Optional[Dict] = None):
        """Yield (tokens int64, sents int64, n_tokens, source_len): one
        scalar fetched per segment, which waits for the device's queue
        (the phase epoch_build.wait, timed into `seconds`)."""
        gen = torch.Generator(device=self.dev)
        seconds = {} if seconds is None else seconds
        for si in range(self.nseg):
            gen.manual_seed(epoch_seed(self.seed, epoch,
                                       None if self.nseg == 1 else si))
            t, s, n = self.build(self.encoded[si], self.keep_probs, gen)
            src = self.seg_len - (self.pad if si == self.nseg - 1 else 0)
            tokens, sents = t.long(), s.long()
            with phase("epoch_build.wait", seconds):
                n = int(n)
            yield tokens, sents, n, src


class _Profile:
    """-profile-dir: a torch.profiler trace (CPU and, on the card, CUDA
    activities) of one steady chunk, the run's second chunk call (its
    first, where the run makes only one), from a synchronized device,
    written as a Chrome trace into the directory with the program's spans
    (utils/trace.py) as host-thread events of category "w2b"; a warning
    where the profiler is unavailable."""

    def __init__(self, cfg: Word2BitsConfig, dev: torch.device):
        self.cfg, self.dev, self.prof = cfg, dev, None
        self.calls = 0 if cfg.profile_dir else 2   # chunk calls profiled
        self.held = None      # (profile, spans) of the last chunk profiled

    def start(self) -> None:
        """Before a chunk call: profile the run's first two."""
        if self.calls >= 2:
            return
        _sync(self.dev)
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        except Exception as e:
            self.calls = 2
            _log(self.cfg, f"WARNING: profiler unavailable ({e})")
            return
        self.prof = prof
        trace.clear()

    def stop(self) -> None:
        """After a chunk call: hold the first's trace, write the second's."""
        if self.prof is None:
            return
        _sync(self.dev)
        prof, self.prof = self.prof, None
        self.calls += 1
        try:
            prof.__exit__(None, None, None)
        except Exception as e:
            self.calls = 2
            _log(self.cfg, f"WARNING: profiler unavailable ({e})")
            return
        self.held = (prof, trace.spans())
        if self.calls == 2:
            self.finish()

    def finish(self) -> None:
        """Write the held trace (at the run's end: its only chunk's)."""
        if self.held is None:
            return
        (prof, spans), self.held = self.held, None
        try:
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            path = os.path.join(self.cfg.profile_dir,
                                f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            # the trace's "ts" are us after baseTimeNanoseconds, on the
            # clock the spans are stamped with
            base = doc.get("baseTimeNanoseconds", 0)
            pid, tid = os.getpid(), threading.get_native_id()
            doc["traceEvents"].extend(
                {"ph": "X", "cat": "w2b", "name": name, "pid": pid,
                 "tid": tid, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3}
                for name, a, b, _ in spans)
            with open(path, "w") as f:
                json.dump(doc, f)
            _log(self.cfg, f"Wrote profiler trace to {path}")
        except Exception as e:
            _log(self.cfg, f"WARNING: profiler unavailable ({e})")


def train(cfg: Word2BitsConfig,
          vocab: Optional[Vocab] = None,
          encoded: Optional[np.ndarray] = None,
          max_steps: Optional[int] = None,
          device=None,
          on_epoch_end: Optional[Callable] = None) -> TrainResult:
    """Full training run on `device` (default cuda).  on_epoch_end(epoch,
    u, v, epoch_loss) is called after each epoch with the tables as host
    numpy arrays, trimmed as the export is (float32 for bf16 tables); on a
    mesh, on rank 0 only.  With -mesh-shape this process is one rank of
    the mesh, on cuda:LOCAL_RANK (or the CPU, for device 'cpu')."""
    dev = resolve_device(device)
    if trace.recording():
        trace.clear()
    if not cfg.mesh_shape:
        return _train(cfg, vocab, encoded, max_steps, dev, on_epoch_end)
    from word2bits_tpu_torch.parallel.trainer import mesh_session
    with mesh_session(cfg, dev.type) as comm:
        return _train(cfg, vocab, encoded, max_steps, comm.device,
                      on_epoch_end, comm)


def _train(cfg: Word2BitsConfig, vocab: Optional[Vocab],
           encoded: Optional[np.ndarray], max_steps: Optional[int],
           dev: torch.device, on_epoch_end: Optional[Callable],
           comm=None) -> TrainResult:
    """train() on `dev`; `comm` is the rank's mesh collectives, or None."""
    root = comm is None or comm.rank == 0
    if not root:
        cfg = dataclasses.replace(cfg, debug=0)   # rank 0 logs
    # float32 products stay float32: no TF32 on the port's path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if vocab is None or encoded is None:
        vocab, encoded = prepare(cfg)

    V, D = vocab.size, cfg.size
    B, S, W = cfg.batch_size, cfg.steps_per_chunk, cfg.window
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=D, window=W,
                      negative=cfg.negative, reg=cfg.reg)
    seconds: Dict[str, float] = {"epoch_build": 0.0, "epoch_build_wait": 0.0,
                                 "upload": 0.0, "cold_map": 0.0,
                                 "checkpoint": 0.0, "issue": 0.0,
                                 "capture": 0.0}
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    ckpt_path = (os.path.join(cfg.checkpoint_dir, CHECKPOINT_FILE)
                 if cfg.checkpoint_dir else None)
    start_epoch, words_done = 0, 0.0
    ranges = None
    if comm is not None:
        from word2bits_tpu_torch.parallel.trainer import local_ranges
        ranges = local_ranges(cfg, V, comm)
        _log(cfg, f"Mesh: data={comm.nd} x vocab={comm.nv}, rank "
                  f"{comm.rank} of {comm.nd * comm.nv}, backend "
                  f"{torch.distributed.get_backend()}, device {dev}, rows "
                  f"{ranges}")
    if ckpt_path and cfg.resume and os.path.exists(ckpt_path):
        with phase("load", seconds):
            ck = load_checkpoint(ckpt_path, cfg, dev, ranges)
            if ck.vocab_rows != V:
                raise ValueError(f"{ckpt_path} holds {ck.vocab_rows} "
                                 f"rows, the vocabulary {V}")
            tables = ck.tables
            start_epoch, words_done = ck.epoch + 1, ck.words_done
            if ck.generator is not None and ck.generator_device == dev.type:
                gen.set_state(ck.generator)
            else:
                gen.manual_seed(resume_seed(cfg.seed, start_epoch))
                _log(cfg, f"WARNING: {ckpt_path} holds no {dev.type} "
                          "generator state (a JAX key cannot be continued); "
                          f"the generator is seeded from (seed {cfg.seed}, "
                          f"epoch {start_epoch})")
            _sync(dev)
        _log(cfg, f"Resumed from {ckpt_path} at epoch {start_epoch} "
                  f"(loaded in {seconds['load']:.2f} s)")
    else:
        with phase("init", seconds):
            tables = init_tables(cfg, V, dev, comm)
            _sync(dev)
        shape = " x ".join(str(n) for n in tables[0].shape)
        names = ("table" if len(tables) == 1
                 else "tables " + ", ".join("uvd"[:len(tables)]))
        _log(cfg, f"Init: {shape} {cfg.dtype} {names} "
                  f"({sum(t.numel() for t in tables[:2])} draws) in "
                  f"{seconds['init']:.2f} s")
    with phase("alias", seconds):
        engine = build_engine(cfg, vocab, tables, hyper, comm)
    _log(cfg, f"Alias table: {seconds['alias']:.2f} s")
    chunk_fn = engine.chunk_fn
    clock = _ChunkClock(dev)

    train_words = vocab.train_words
    denom = float(cfg.iter) * train_words + 1.0
    seg_tokens, capacity = segment_capacity(cfg, len(encoded))
    total_len = max(len(encoded), 1)
    device_corpus = None
    if cfg.device_epoch_on and root:
        with phase("upload", seconds):
            device_corpus = DeviceCorpus(cfg, vocab, encoded, seg_tokens,
                                         capacity, dev)
            _sync(dev)
    _log(cfg, "Epochs built on the "
              f"{'device' if device_corpus else 'host'}")

    def segments(epoch: int):
        """(tokens, sents, n_tokens, source_len, host tokens or None); on
        a mesh rank 0's, broadcast to every rank."""
        if comm is not None:
            from word2bits_tpu_torch.parallel.trainer import \
                replicate_segments
            yield from replicate_segments(
                built_segments(epoch) if root else None, dev)
            return
        yield from built_segments(epoch)

    def built_segments(epoch: int):
        if device_corpus is not None:
            for t, s_, n, src in device_corpus.segments(epoch, seconds):
                yield t, s_, n, src, None
            return
        for ea in iter_epoch_segments(encoded, vocab.counts, cfg.sample,
                                      train_words, W,
                                      np.random.default_rng([cfg.seed,
                                                             epoch]),
                                      seg_tokens, capacity=capacity):
            with phase("upload", seconds):
                tokens = torch.from_numpy(ea.tokens).to(dev, torch.int64)
                sents = torch.from_numpy(ea.sent_ids).to(dev, torch.int64)
                _sync(dev)
            yield tokens, sents, ea.n_tokens, ea.source_len, ea.tokens

    epoch_losses: List[float] = []
    chunk_losses: List[torch.Tensor] = []   # fetched once, after the loop
    final = None       # a mesh's gathered tables after the last epoch
    gathered = False   # (None off rank 0)
    cold_width = 0     # grows monotonically: a stable map width
    total_steps = 0
    words_at_start = words_done  # a resumed run reports its own rate
    profile = _Profile(cfg, dev)
    t_train0 = time.perf_counter()
    t_print = 0.0
    stop = False
    for epoch in range(start_epoch, cfg.iter):
        with span("epoch"):
            _log(cfg, f"Starting epoch: {epoch}")
            loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
            segs = segments(epoch)
            while True:
                # a host segment's upload and the device build's wait for
                # the queue are phases of their own
                with phase("epoch_build", seconds):
                    seg = next(segs, None)
                if seg is None:
                    break
                tokens, sents, seg_n_tokens, source_len, host_tokens = seg
                cold = {}
                if engine.cold_split:
                    with phase("cold_map", seconds):
                        cp = cold_map(cfg, host_tokens, capacity, cold_width)
                        cold_width = cp.shape[1]
                        cold["cold_pos"] = torch.from_numpy(cp).to(
                            dev, torch.int64)
                n_centers = max(seg_n_tokens, 1)
                # this segment accounts for its share of the epoch's words
                seg_words = train_words * source_len / total_len
                wca_per_step = B * seg_words / n_centers
                n_steps = math.ceil(seg_n_tokens / B)
                for ci in range(max(1, math.ceil(n_steps / S))):
                    # only the steps that hold centers run: a trailing
                    # all-padding step updates nothing
                    chunk_steps = min(S, n_steps - ci * S)
                    scalars = ChunkScalars(
                        base0=W + ci * S * B, alpha0=cfg.effective_alpha,
                        wca_start=words_done, wca_per_step=wca_per_step,
                        denom=denom)
                    profile.start()
                    with phase("chunk", seconds, "issue"):
                        start = clock.start()
                        *tables, loss = chunk_fn(
                            *tables, tokens, sents, engine.alias, scalars,
                            gen, n_steps=max(chunk_steps, 1), **cold)
                        clock.stop(start, max(chunk_steps, 1),
                                   chunk_steps * wca_per_step)
                    profile.stop()
                    words_done += chunk_steps * wca_per_step
                    loss_acc = loss_acc + loss
                    chunk_losses.append(loss)
                    total_steps += max(chunk_steps, 1)
                    if cfg.debug > 1 and time.perf_counter() - t_print > 0.5:
                        t_print = time.perf_counter()
                        a0 = cfg.effective_alpha
                        alpha_now = max(a0 * (1 - words_done / denom),
                                        a0 * 1e-4)
                        wps = (words_done - words_at_start) / max(
                            t_print - t_train0 - seconds["checkpoint"], 1e-9)
                        with span("fetch"):
                            cost = float(loss_acc)
                        progress = min(words_done / denom * 100, 100.0)
                        print(f"\rAlpha: {alpha_now:.6f}  "
                              f"Progress: {progress:.2f}%  "
                              f"Cost: {cost:.2f} "
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
            with span("fetch"):
                epoch_loss = float(loss_acc)   # host fetch = device sync
        _log(cfg, f"Epoch Loss: {epoch_loss:.6f}")
        epoch_losses.append(epoch_loss)
        last = stop or epoch == cfg.iter - 1
        save_epoch = bool(cfg.save_every_epoch and cfg.output_file
                          and cfg.classes == 0)
        # -checkpoint-every-epoch 0: only after the last epoch (a run cut
        # by max_steps counts its epoch as done, as in the JAX package)
        want_ckpt = bool(ckpt_path) and (cfg.checkpoint_every_epoch or last)
        full = tables
        if engine.sharded is not None and (save_epoch or want_ckpt or last
                                           or on_epoch_end is not None):
            with span("fetch"):
                full = engine.sharded.params()  # every rank; None off rank 0
            if last:
                final, gathered = full, True
        if save_epoch and root:
            with span("export"):
                write_output(f"{cfg.output_file}_epoch{epoch}", vocab, full,
                             cfg, engine.subwords)
        if want_ckpt and root:
            ck0 = seconds["checkpoint"]
            with phase("checkpoint", seconds):
                os.makedirs(cfg.checkpoint_dir, exist_ok=True)
                save_checkpoint(ckpt_path, full, epoch, gen, words_done)
            _log(cfg, f"Checkpoint: epoch {epoch} to {ckpt_path} in "
                      f"{seconds['checkpoint'] - ck0:.2f} s")
        if on_epoch_end is not None and root:
            with span("fetch"):
                host = [_host_half(h) for h in
                        table_halves(full) + tuple(full[2:])]
            on_epoch_end(epoch, *host, epoch_loss)
        if stop:
            break
    profile.finish()
    _sync(dev)
    # the words/sec of this run's own epochs, checkpoint writes excluded
    wall = time.perf_counter() - t_train0 - seconds["checkpoint"]
    counts = engine.counts or StepCounts(eager=total_steps)
    seconds["capture"] = counts.seconds["capture"]
    wps = (words_done - words_at_start) / max(wall, 1e-9)
    per_step = 1e6 / max(total_steps, 1)
    _log(cfg, f"Epoch arrays ({'device' if device_corpus else 'host'}): "
              f"{seconds['epoch_build']:.2f} s (and "
              f"{seconds['epoch_build_wait']:.2f} s waiting for the device), "
              f"upload {seconds['upload']:.2f} s, cold maps "
              f"{seconds['cold_map']:.2f} s")
    _log(cfg, f"Trained {total_steps} steps in {wall:.6f} s: "
              f"{wps:.1f} words/sec, {wall * per_step:.1f} us/step; "
              f"the host inside chunk calls "
              f"{seconds['issue'] * per_step:.1f} us/step, building epochs "
              f"{seconds['epoch_build'] * per_step:.1f} us/step, waiting "
              f"{seconds['epoch_build_wait'] * per_step:.1f} us/step; "
              f"{counts.replayed} steps replayed from a CUDA graph, "
              f"{counts.eager} eager, captures {seconds['capture']:.3f} s")

    if engine.sharded is not None:
        if not gathered:
            with span("fetch"):
                final = engine.sharded.params()
        if root:
            tables = final
    if cfg.output_file and root:
        with phase("export", seconds):
            if cfg.classes == 0:
                write_output(cfg.output_file, vocab, tables, cfg,
                             engine.subwords)
            else:
                # reference quirk: -classes != 0 creates an empty output file
                _log(cfg, "WARNING: -classes is parsed but unimplemented in "
                          "the reference; writing an empty file for parity")
                open(cfg.output_file, "wb").close()
        _log(cfg, f"Export: {seconds['export']:.2f} s")

    with span("fetch"):
        chunks = clock.chunks()
        losses = (torch.stack(chunk_losses).tolist() if chunk_losses
                  else [])
    return TrainResult(vocab=vocab, tables=tuple(tables),
                       epoch_losses=epoch_losses,
                       words_per_sec=wps, steps=total_steps,
                       chunks=chunks, chunk_losses=losses,
                       seconds=seconds,
                       start_epoch=start_epoch, words_done=words_done,
                       steps_replayed=counts.replayed,
                       steps_eager=counts.eager)


def _host_half(half: torch.Tensor) -> np.ndarray:
    """A (V, D) table half as a host numpy array (float32 for bf16)."""
    if half.dtype == torch.bfloat16:
        half = half.to(torch.float32)
    return half.contiguous().cpu().numpy()


def table_halves(tables: Tables) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) of any engine's tables: the 1-tuple of a fused (V, 2D)
    table gives its two column halves, as views; fasttext-cbow's position
    weights (the third table) are not among them."""
    if len(tables) == 1:
        return deinterleave(tables[0])
    return tables[0], tables[1]


def write_output(path: str, vocab: Vocab, tables: Tables,
                 cfg: Word2BitsConfig,
                 subwords: Optional[Subwords] = None) -> None:
    """The vectors file quantize(u + v) (reference :548-552) and, with
    -packed 1 at bitlevel 1 or 2, `<path>.pack` (as the JAX package's
    train._write_output), built in row blocks on the tables' device: each
    block is summed in float32, quantized there by kernel 4
    (kernels/quantize_pallas.py) and packed, and only the block comes to
    the host.  `tables`: the fused (V, 2D) table or the
    engine's tables.  Byte-identical to the JAX package's
    train._write_output (output_vectors + write_vectors + write_packed).
    With -model fasttext or fasttext-cbow (`subwords`, built here if not
    given) a word's vector is instead the mean of its quantized subword
    rows (fastText's getWordVector: the gather-mean kernel,
    kernels/subword_mean.py), float32; the position weights are not
    written."""
    u, v = table_halves(tables)
    V, D = v.shape
    if cfg.model in SUBWORD_MODELS:
        sub = subwords or subword_rows(vocab.words, cfg.minn, cfg.maxn,
                                       cfg.bucket, u.device)
        rows = max(1, _EXPORT_VALUES // max(D, 1))
        with VectorWriter(path, V, D, binary=cfg.binary) as vw:
            for r0 in range(0, V, rows):
                r1 = min(V, r0 + rows)
                words = torch.arange(r0, r1, device=u.device)
                vw.write_rows(vocab.words[r0:r1], subword_mean(
                    u, words, sub, cfg.bitlevel).cpu().numpy())
        return
    bl = cfg.bitlevel
    packed = cfg.packed and bl in (1, 2)
    rows = max(1, _EXPORT_VALUES // max(D, 1))
    with VectorWriter(path, V, D, binary=cfg.binary) as vw, \
            (PackedWriter(path + ".pack", vocab.words, D, bl) if packed
             else nullcontext()) as pw:
        for r0 in range(0, V, rows):
            r1 = min(V, r0 + rows)
            q = quantize_pallas(u[r0:r1].to(torch.float32)
                                + v[r0:r1].to(torch.float32), bl)
            vw.write_rows(vocab.words[r0:r1], q.cpu().numpy())
            if packed:
                pw.write_payload(pack_codes(q, bl).cpu().numpy())


# ---------------------------------------------------------------------------
# Checkpoint / resume: the JAX package's state.npz (train.save_checkpoint,
# _ckpt_encode), streamed in row blocks
# ---------------------------------------------------------------------------

class Checkpoint(NamedTuple):
    tables: Tables                     # in the engine's layout, on device
    vocab_rows: int                    # the checkpoint's V
    epoch: int                         # the last epoch done
    words_done: float
    generator: Optional[torch.Tensor]  # torch.Generator state, or None
    generator_device: Optional[str]    # its device type ("cuda", "cpu")


def resume_seed(seed: int, epoch: int) -> int:
    """The generator's seed where a checkpoint holds no state to continue
    (a JAX checkpoint's key, or another device type's generator)."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0])


def _ckpt_dtype(t: torch.Tensor) -> Tuple[np.dtype, str]:
    """The JAX _ckpt_encode: bfloat16 stored as its uint16 bits with a
    dtype tag, everything else as float32."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    return np.dtype(np.float32), "float32"


def _ckpt_block(blk: torch.Tensor) -> np.ndarray:
    if blk.dtype == torch.bfloat16:
        return blk.contiguous().cpu().view(torch.int16).numpy().view(
            np.uint16)
    return blk.to(torch.float32).contiguous().cpu().numpy()


def _write_small(zf: zipfile.ZipFile, name: str, value) -> None:
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asarray(value))


def save_checkpoint(path: str, tables: Tables, epoch: int,
                    gen: torch.Generator, words_done: float) -> None:
    """Write `path` as np.savez writes the JAX package's state.npz (an
    uncompressed zip of .npy members): `u` and `v` as (V, D) halves
    (bfloat16 as uint16 bits, with `u_dtype`/`v_dtype` tags; else
    float32), fasttext-cbow's position weights `d` (the third table,
    float32), `epoch`, `words_done`, and in place of the JAX `key` the
    generator's state (`torch_generator`, uint8, and its device type
    `torch_generator_device`).  The halves stream from the device in row
    blocks: the host holds one block, never a table.  Written to a
    temporary name and renamed, so an interrupted save leaves the last
    checkpoint whole."""
    u, v = table_halves(tables)
    rows = max(1, _EXPORT_VALUES // max(u.shape[1], 1))
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, half in [("u", u), ("v", v)] + [("d", t)
                                                   for t in tables[2:]]:
            dt, tag = _ckpt_dtype(half)
            V = half.shape[0]     # u holds the subword model's buckets too
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": np.lib.format.dtype_to_descr(dt),
                    "fortran_order": False, "shape": tuple(half.shape)})
                for r0 in range(0, V, rows):
                    f.write(_ckpt_block(half[r0:r0 + rows]).tobytes())
            _write_small(zf, name + "_dtype", tag)
        _write_small(zf, "epoch", np.int64(epoch))
        _write_small(zf, "words_done", np.float64(words_done))
        _write_small(zf, "torch_generator", gen.get_state().numpy())
        _write_small(zf, "torch_generator_device", gen.device.type)
    os.replace(tmp, path)


def _read_member_header(f) -> Tuple[Tuple[int, ...], np.dtype]:
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dt = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dt = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported .npy version {version}")
    if fortran:
        raise ValueError("Fortran-ordered checkpoint arrays are not read")
    return shape, dt


def _read_small(zf: zipfile.ZipFile, name: str):
    with zf.open(name + ".npy") as f:
        return np.lib.format.read_array(f)


def _read_half(zf: zipfile.ZipFile, name: str, dest: torch.Tensor,
               ranges=None) -> None:
    """Stream member `name` ((V, D), its tag applied) into dest in row
    blocks, through one host buffer: all of it, or with `ranges` the rows
    [r0, r1) of each range one after another (rows at or past V left as
    they are: a mesh shard's padding)."""
    tag = (str(_read_small(zf, name + "_dtype"))
           if name + "_dtype.npy" in zf.namelist() else "float32")
    with zf.open(name + ".npy") as f:
        shape, dt = _read_member_header(f)
        V, D = shape
        if ranges is None:
            ranges = [(0, V)]
            if tuple(shape) != tuple(dest.shape):
                raise ValueError(f"checkpoint {name} is {tuple(shape)}, the "
                                 f"table half {tuple(dest.shape)}")
        elif D != dest.shape[1]:
            raise ValueError(f"checkpoint {name} is {tuple(shape)}, the "
                             f"table rows {tuple(dest.shape)}")
        data0 = f.tell()
        rows = max(1, _EXPORT_VALUES // max(D, 1))
        buf = np.empty((min(rows, V), D), dt)
        o = 0
        for g0, g1 in ranges:
            if g0 < V:
                f.seek(data0 + g0 * D * dt.itemsize)
            for r0 in range(g0, min(g1, V), rows):
                n = min(rows, min(g1, V) - r0)
                blk = buf[:n]
                if f.readinto(memoryview(blk.reshape(-1).view(np.uint8))) \
                        != blk.nbytes:
                    raise ValueError(f"checkpoint {name} ends early")
                if tag == "bfloat16":
                    t = torch.from_numpy(blk.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(blk)
                dest[o + r0 - g0:o + r0 - g0 + n].copy_(t)
            o += g1 - g0


def load_checkpoint(path: str, cfg: Word2BitsConfig, device,
                    ranges=None) -> Checkpoint:
    """Read a state.npz of either package into tables allocated once on
    `device` in the config's layout and dtype (a fused checkpoint resumes
    on split tables and the other way round, as in the JAX package),
    streaming each half in row blocks: no initialization runs first, and
    the host holds one block.  `ranges` ((r0, r1) global row ranges, a
    mesh shard's: parallel/trainer.local_ranges): split tables of those
    rows alone, rows past the vocabulary zero.  With -model fasttext-cbow
    the position weights `d` are read too (float32).  A JAX checkpoint
    carries a JAX key, which cannot be continued: `generator` is None
    then."""
    dtype = getattr(torch, cfg.dtype)
    with zipfile.ZipFile(path) as zf:
        with zf.open("u.npy") as f:
            (V, D), _ = _read_member_header(f)
        extra = cfg.subword_buckets      # u's bucket rows after the words
        V -= extra
        if D != cfg.size:
            raise ValueError(f"{path} holds size {D}, the config {cfg.size}")
        if ranges is not None:
            n = sum(r1 - r0 for r0, r1 in ranges)
            tables: Tables = tuple(
                torch.zeros((n, D), dtype=dtype, device=device)
                for _ in range(2))
        elif cfg.fused_on:
            table = torch.empty((V, 2 * D), dtype=dtype, device=device)
            tables = (table,)
        else:
            tables = (torch.empty((V + extra, D), dtype=dtype,
                                  device=device),
                      torch.empty((V, D), dtype=dtype, device=device))
        u, v = table_halves(tables)
        _read_half(zf, "u", u, ranges)
        _read_half(zf, "v", v, ranges)
        names = zf.namelist()
        if cfg.model == "fasttext-cbow":
            if "d.npy" not in names:
                raise ValueError(f"{path} holds no position weights d: not "
                                 "a -model fasttext-cbow checkpoint")
            d = torch.empty((2 * cfg.window, D), dtype=torch.float32,
                            device=device)
            _read_half(zf, "d", d)
            tables = tables + (d,)
        generator = gen_device = None
        if "torch_generator.npy" in names:
            generator = torch.from_numpy(_read_small(zf, "torch_generator"))
            gen_device = str(_read_small(zf, "torch_generator_device"))
        return Checkpoint(tables=tables, vocab_rows=V,
                          epoch=int(_read_small(zf, "epoch")),
                          words_done=float(_read_small(zf, "words_done")),
                          generator=generator, generator_device=gen_device)
