"""Where a training step's time goes on the card.

    python3 -m word2bits_tpu_torch.tools.profile_step
        [--config shipped|flagship|rmw|quickstart|skipgram|exact|pallas|hot|
                  split|mesh|mesh-rmw]
        [--tokens N] [--steps S]

`--config shipped` (the default) is the shipped throughput configuration
(size 200, span scatter, fused tables); `quickstart` the README Quick
start's flags (the reference-default split-table engine: per-center
negatives, B = 256, shifted sums, `add` scatter); `skipgram` those flags
with `-model skipgram`; `exact` the per-center
mode at the JAX package's exact-mode throughput flags (B = 4096, banded
256, span scatter, context kernel); `pallas` the shipped flags with
`-scatter-impl add -use-pallas 1` (the score kernel); `hot` the shipped
flags with `-scatter-impl add -hot-rows 2048 -hot-pallas 1` (the hot/cold
split through kernel 6; each segment's cold map is built as train.train
builds it); `split` the shipped flags on split tables without the context
kernel (the slab engine), and `mesh` the same on the mesh trainer
(parallel/) as a mesh of one shard on a one-rank NCCL group, kernel 2 on
the shard's local ids.  These nine run on a synthetic text8-like corpus
(written inside the checkout, removed afterwards).  `--config flagship` is the
full-Wikipedia capacity configuration of docs/large_vocab.md:19-25
(3,699,941 types, size 800, B = 16384, grmw scatter) on the in-memory
synthetic vocabulary of that shape (data/synthetic.zipf_vocab_corpus);
`rmw` the same with `-rmw-scatter 1 -steps-per-chunk 1` in place of
`-scatter-impl grmw -loop-mode fori -steps-per-chunk 32`
(docs/large_vocab.md:34, kernel 8), and `mesh-rmw` that on the mesh
trainer (vocab = 1, without the context kernel, which is single-chip).  Builds the port's kernels,
warms the engine's chunk up for one full chunk, then times `--steps` steps
with the host clock and profiles the same number of steps with
torch.profiler.  Prints the step time, the
device's busy and idle share of the profiled window (kernel time summed
over the window's wall time; the port runs on one stream), and device time
by kernel name.  Needs a CUDA card; numbers are the card's named on the
first line.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SHIPPED = ["-bitlevel", "1", "-size", "200", "-window", "8",
           "-negative", "24", "-min-count", "5", "-sample", "1e-3",
           "-alpha", "0.1", "-batch-size", "8192", "-steps-per-chunk", "256",
           "-fused-tables", "1", "-neg-sharing", "64", "-neg-pool", "2",
           "-dtype", "bfloat16", "-banded-tile", "256", "-scatter-impl",
           "span", "-context-pallas", "1"]
# docs/large_vocab.md:19-25 (the output flags aside)
FLAGSHIP = ["-size", "800", "-window", "8", "-negative", "24", "-iter", "5",
            "-min-count", "5", "-bitlevel", "1", "-dtype", "bfloat16",
            "-fused-tables", "1", "-neg-sharing", "64",
            "-batch-size", "16384", "-steps-per-chunk", "32",
            "-loop-mode", "fori", "-scatter-impl", "grmw",
            "-banded-tile", "256", "-context-pallas", "1"]
# docs/large_vocab.md:34-35: the earlier capacity path, kernel 8
RMW = [f for f in FLAGSHIP if f not in ("-loop-mode", "fori",
                                        "-scatter-impl", "grmw")]
RMW[RMW.index("-steps-per-chunk") + 1] = "1"
RMW += ["-rmw-scatter", "1"]

def _without(flags, names):
    return [f for i in range(0, len(flags), 2) if flags[i] not in names
            for f in flags[i:i + 2]]


SPLIT = _without(SHIPPED, ("-fused-tables", "-context-pallas"))
CAPACITY = {"flagship": FLAGSHIP, "rmw": RMW,
            "mesh-rmw": _without(RMW, ("-context-pallas",))
            + ["-mesh-shape", "vocab=1"]}
FLAGSHIP_TYPES = 3_699_941
QUICKSTART = ["-size", "200", "-window", "8", "-negative", "24",
              "-min-count", "5", "-bitlevel", "1"]
CONFIGS = {
    "shipped": SHIPPED,
    "quickstart": QUICKSTART,
    "skipgram": QUICKSTART + ["-model", "skipgram"],
    # tools/step_bench.py:200-218 of the JAX package
    "exact": QUICKSTART + ["-batch-size", "4096", "-steps-per-chunk", "128",
                           "-banded-tile", "256", "-scatter-impl", "span",
                           "-context-pallas", "1"],
    "pallas": [("add" if f == "span" else f) for f in SHIPPED]
    + ["-use-pallas", "1"],
    "hot": [("add" if f == "span" else f) for f in SHIPPED]
    + ["-hot-rows", "2048", "-hot-pallas", "1"],
    "split": SPLIT,
    "mesh": SPLIT + ["-mesh-shape", "data=1,vocab=1"],
}


def _prepare(config: str, tokens: int):
    """(cfg, vocab, encoded) of the named configuration."""
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.synthetic import (zipf_corpus,
                                                    zipf_vocab_corpus)
    from word2bits_tpu_torch.train import prepare
    if config in CAPACITY:
        vocab, encoded = zipf_vocab_corpus(FLAGSHIP_TYPES, seed=0)
        return (config_from_argv(CAPACITY[config] + ["-debug", "0"]), vocab,
                encoded)
    work = os.path.join(REPO, ".smoke_work", "profile")
    os.makedirs(work, exist_ok=True)
    try:
        corpus = os.path.join(work, "corpus.txt")
        zipf_corpus(corpus, n_tokens=tokens, vocab=70_000, seed=0)
        cfg = config_from_argv(["-train", corpus, "-debug", "0"]
                               + CONFIGS[config])
        vocab, encoded = prepare(cfg)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return cfg, vocab, encoded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS) + tuple(CAPACITY),
                    default="shipped")
    ap.add_argument("--tokens", type=int, default=17_000_000,
                    help="corpus tokens of the synthetic text8-like corpus")
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from word2bits_tpu_torch.kernels._build import build_all

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all()
    cfg, vocab, encoded = _prepare(args.config, args.tokens)
    if not cfg.mesh_shape:
        return _profile(args, cfg, vocab, encoded, torch.device("cuda", 0))
    from word2bits_tpu_torch.parallel.trainer import mesh_session
    with mesh_session(cfg, "cuda") as comm:
        return _profile(args, cfg, vocab, encoded, comm.device, comm)


def _profile(args, cfg, vocab, encoded, dev, comm=None) -> int:
    from word2bits_tpu_torch.data.pipeline import build_epoch_arrays
    from word2bits_tpu_torch.models.cbow import CBOWHyper, ChunkScalars
    from word2bits_tpu_torch.train import (build_engine, cold_map,
                                           init_tables, segment_capacity)
    B, S, W = cfg.batch_size, cfg.steps_per_chunk, cfg.window
    hyper = CBOWHyper(bitlevel=cfg.bitlevel, size=cfg.size, window=W,
                      negative=cfg.negative, reg=cfg.reg)
    eng = build_engine(cfg, vocab, init_tables(cfg, vocab.size, dev, comm),
                       hyper, comm)
    _, capacity = segment_capacity(cfg, len(encoded))
    ea = build_epoch_arrays(encoded, vocab.counts, cfg.sample,
                            vocab.train_words, W, np.random.default_rng(0),
                            capacity=capacity)
    tokens = torch.from_numpy(ea.tokens).to(dev, torch.int64)
    sents = torch.from_numpy(ea.sent_ids).to(dev, torch.int64)
    cold = {}
    if eng.cold_split:
        cold["cold_pos"] = torch.from_numpy(
            cold_map(cfg, ea.tokens, capacity)).to(dev, torch.int64)
    n_steps = math.ceil(ea.n_tokens / B)
    if n_steps < S + 2 * args.steps:
        raise SystemExit(f"corpus gives {n_steps} steps; need "
                         f"{S + 2 * args.steps} (raise --tokens)")
    gen = torch.Generator(device=dev).manual_seed(1)

    def run(first_step: int, steps: int):
        sc = ChunkScalars(base0=W + first_step * B,
                          alpha0=cfg.effective_alpha, wca_start=0.0,
                          wca_per_step=float(B),
                          denom=float(vocab.train_words) + 1.0)
        return eng.chunk_fn(*eng.tables, tokens, sents, eng.alias, sc, gen,
                            n_steps=steps, **cold)

    print(f"--config {args.config}: V={vocab.size}, B={B}, {n_steps} steps in "
          f"the epoch; warm-up chunk of {S} steps")
    run(0, S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(S, args.steps)
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / args.steps * 1e6
    print(f"host clock: {step_us:.1f} us/step over {args.steps} steps "
          f"(chunk of {args.steps} steps: its scatter plan included)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(S + args.steps, args.steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    busy_us = sum(t for t, _ in by_name.values())
    print(f"profiled window: {wall_us:.1f} us wall for {args.steps} steps; "
          f"device busy {busy_us:.1f} us "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 * (1 - busy_us / wall_us):.1f}% idle); "
          f"{sum(n for _, n in by_name.values())} kernel launches")
    if not by_name:
        print("the profiler recorded no device activity: device shares "
              "not measured")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {t / args.steps:9.2f} us/step {100 * t / max(busy_us, 1e-9):5.1f}%"
              f"  x{n / args.steps:4.1f}/step  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
