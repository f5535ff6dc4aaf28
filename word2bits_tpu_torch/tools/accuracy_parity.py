"""Run-level accuracy hold: the port's trained runs against the JAX
package's analogy accuracy on the structured-analogy corpus.

    python word2bits_tpu_torch/tools/accuracy_parity.py \\
        [--rows per-center-b0,skipgram-b1 | all] [--seeds 1,2,3] [--fast] \\
        [--device cuda|cpu] [--out rows.jsonl]
    python word2bits_tpu_torch/tools/accuracy_parity.py --table rows.jsonl...

Modelled on the JAX package's tools/accuracy_parity.py, which stays as it
is: the same hyperparameters (HYPER, 5 epochs), 64-step chunks and batch
rule (B = 256, the config's auto batch, for per-center and bitlevel >= 4
rows; 512 for the others), the same corpus (120,000 sentences and 1,000
questions from data/structured.py under .bench_cache/; --fast: 30,000
sentences, 500 questions, 3 epochs).  Each run trains through the port's
train.train on --device (default cuda) and is scored by the port's
evaluator.  It prints one line per run and, per row, the port's mean ± sd
beside the JAX package's ("ours" in ACCEPTANCE.md: the JAX package on its
CPU backend, 5 seeds) with the pass rule: a row passes when its mean lies
within the JAX row's mean ± 2 sd.  --out appends each run as a JSON line;
--table prints the rows of such files (runs split over several
processes or calls).  It never writes ACCEPTANCE.md.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CACHE = os.path.join(REPO, ".bench_cache")
HYPER = dict(size=100, window=5, negative=10, iters=5, min_count=5,
             sample=1e-3, alpha=0.05)

# name -> (bitlevel, mode label, config fields, JAX mean, JAX sd, source)
ROWS = {
    "per-center-b0": (0, "per-center", dict(), 95.5, 0.3,
                      "ACCEPTANCE.md:23"),
    "per-center-b1": (1, "per-center", dict(), 41.5, 4.3,
                      "ACCEPTANCE.md:22"),
    "per-center-b2": (2, "per-center", dict(), 50.9, 2.7,
                      "ACCEPTANCE.md:24"),
    "per-center-b8": (8, "per-center", dict(), 57.8, 1.5,
                      "ACCEPTANCE.md:21"),
    "shared-16-b1": (1, "shared-16", dict(neg_sharing=16), 39.9, 1.9,
                     "ACCEPTANCE.md:8"),
    "shared-16-densehot-b1": (1, "shared-16-densehot", dict(
        neg_sharing=16, fused_tables=True, hot_rows=256,
        neg_dense_hot=True), 42.1, 2.1, "ACCEPTANCE.md:15"),
    "skipgram-b1": (1, "skipgram", dict(model="skipgram"), 75.4, 3.5,
                    "ACCEPTANCE.md:10"),
}


def ensure_corpus(fast: bool = False):
    """(corpus, questions) under .bench_cache/, written as the JAX
    package's script writes them (the same files, byte for byte)."""
    os.makedirs(CACHE, exist_ok=True)
    tag = "fast" if fast else "full"
    corpus = os.path.join(CACHE, f"structured_{tag}.txt")
    questions = os.path.join(CACHE, f"structured_{tag}_questions.txt")
    if not (os.path.exists(corpus) and os.path.exists(questions)):
        from word2bits_tpu_torch.data.structured import structured_corpus
        tmp = f".{os.getpid()}.tmp"
        structured_corpus(corpus + tmp, questions + tmp,
                          n_sentences=30_000 if fast else 120_000,
                          n_questions=500 if fast else 1000)
        os.replace(corpus + tmp, corpus)
        os.replace(questions + tmp, questions)
    return corpus, questions


def batch_size(bitlevel: int, mode: str) -> int:
    """The JAX script's rule: the auto batch (0 -> 256) for per-center and
    bitlevel >= 4 rows, 512 for the throughput-shaped modes."""
    return 0 if (mode == "per-center" or bitlevel >= 4) else 512


def run_port(corpus: str, out: str, bitlevel: int, mode: str, fields: dict,
             seed: int, iters: int, device) -> float:
    """Train one run through the port's train.train; returns seconds."""
    from word2bits_tpu_torch.config import Word2BitsConfig
    from word2bits_tpu_torch.train import train
    cfg = Word2BitsConfig(
        train_file=corpus, output_file=out, binary=True, bitlevel=bitlevel,
        size=HYPER["size"], window=HYPER["window"],
        negative=HYPER["negative"], iter=iters,
        min_count=HYPER["min_count"], sample=HYPER["sample"],
        alpha=HYPER["alpha"], batch_size=batch_size(bitlevel, mode),
        steps_per_chunk=64, debug=0, seed=seed, **fields)
    t0 = time.perf_counter()
    train(cfg, device=device)
    return time.perf_counter() - t0


def evaluate(vec_path: str, questions: str, device) -> tuple:
    """(accuracy %, coverage %) of the port's evaluator at bitlevel 0."""
    from word2bits_tpu_torch.eval.analogy import (evaluate_analogies,
                                                  load_questions)
    from word2bits_tpu_torch.io.vectors import read_vectors
    words, vectors = read_vectors(vec_path)
    res = evaluate_analogies(words, vectors, load_questions(questions),
                             bitlevel=0, device=device)
    return res.total_accuracy, res.coverage


def stats(xs) -> tuple:
    m = statistics.mean(xs)
    return m, (statistics.stdev(xs) if len(xs) > 1 else 0.0)


def verdict(name: str, accs) -> dict:
    """The row's line: the port's mean ± sd beside the JAX row's, and
    pass when the mean lies within the JAX mean ± 2 sd."""
    bitlevel, mode, _, jm, js, src = ROWS[name]
    m, s = stats(accs)
    ok = jm - 2 * js <= m <= jm + 2 * js
    return dict(row=name, bitlevel=bitlevel, mode=mode, seeds=len(accs),
                port_mean=m, port_sd=s, jax_mean=jm, jax_sd=js, jax=src,
                result="pass" if ok else "miss")


def _table(paths) -> int:
    by_row = {}
    for p in paths:
        with open(p) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    by_row.setdefault(r["row"], {})[r["seed"]] = r["acc"]
    for name in ROWS:
        if name in by_row:
            accs = [by_row[name][k] for k in sorted(by_row[name])]
            v = verdict(name, accs)
            print(f"parity {name}: port {v['port_mean']:.1f}±"
                  f"{v['port_sd']:.1f} ({v['seeds']} seeds "
                  f"{sorted(by_row[name])}) | JAX {v['jax_mean']}±"
                  f"{v['jax_sd']} ({v['jax']}) | {v['result']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="all",
                    help="comma-separated row names, or all: "
                    + ", ".join(ROWS))
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", nargs="*", default=None)
    args = ap.parse_args(argv)
    if args.table is not None:
        return _table(args.table)
    names = list(ROWS) if args.rows == "all" else args.rows.split(",")
    for n in names:
        if n not in ROWS:
            raise SystemExit(f"unknown row {n!r} (rows: {', '.join(ROWS)})")
    seeds = [int(s) for s in args.seeds.split(",")]
    import torch
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        print(f"card: {card[0] if card else torch.cuda.get_device_name(0)}",
              flush=True)
    corpus, questions = ensure_corpus(args.fast)
    iters = 3 if args.fast else HYPER["iters"]
    work = os.path.join(CACHE, f"parity_vectors_{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        for name in names:
            bitlevel, mode, fields, *_ = ROWS[name]
            accs = []
            for seed in seeds:
                out = os.path.join(work, f"{name}_{seed}.bin")
                sec = run_port(corpus, out, bitlevel, mode, fields, seed,
                               iters, args.device)
                acc, cov = evaluate(out, questions, args.device)
                os.unlink(out)
                accs.append(acc)
                rec = dict(row=name, seed=seed, acc=acc, coverage=cov,
                           seconds=sec, fast=args.fast, device=args.device)
                print("parity run " + json.dumps(rec), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
            if args.fast:   # the JAX rows are the full corpus's
                m, s = stats(accs)
                print(f"parity {name} (--fast): port {m:.1f}±{s:.1f} "
                      f"({len(seeds)} seeds)", flush=True)
                continue
            v = verdict(name, accs)
            print(f"parity {name}: port {v['port_mean']:.1f}±"
                  f"{v['port_sd']:.1f} ({len(seeds)} seeds) | JAX "
                  f"{v['jax_mean']}±{v['jax_sd']} ({v['jax']}) | "
                  f"{v['result']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
