"""µs per step of the paths whose update goes through the plain scatter-add,
on the card, for two checkouts compared in one call.

    python3 word2bits_tpu_torch/tools/route_steps.py [--root DIR]
        [--corpus PATH] [--out JSONL]

imports `word2bits_tpu_torch` from DIR (default: the checkout holding this
file), writes (once, then reuses) a 17M-token Zipf(1.05) corpus over 70,000
types at PATH (chip_smoke.py's [train] corpus), prepares it, and trains
through `train.train` at the flags of chip_smoke.py's paths:

  quickstart  the README Quick start (split tables, per-center, B = 256,
              `add`, float32), 1,024 steps;
  pallas      the shipped flags with -scatter-impl add -use-pallas 1
              (fused bf16, B = 8192), 768 steps;
  hot         those with -hot-rows 2048 -hot-pallas 1 in place of
              -use-pallas 1 (the hot/cold split), 768 steps;
  skipgram    the Quick start's flags with -model skipgram, 1,024 steps.

Each prints its µs/step and words/sec on the card's clock over the chunks
after the first (chip_smoke.py's `_steady`), with the card's name and power
limit; --out appends one JSON line per path.  Run it for the parent and the
change in turns (parent, change, change, parent) in one call: e.g.
`git archive HEAD~1 | tar -x -C .chiprun_tmp/parent` and `--root
.chiprun_tmp/parent`.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

D, W, K = 200, 8, 24
QUICKSTART = ["-size", str(D), "-window", str(W), "-negative", str(K),
              "-min-count", "5", "-bitlevel", "1", "-binary", "1"]
SHIPPED_ADD = QUICKSTART[:-4] + [
    "-bitlevel", "1", "-sample", "1e-3", "-alpha", "0.1",
    "-batch-size", "8192", "-steps-per-chunk", "256", "-fused-tables", "1",
    "-neg-sharing", "64", "-neg-pool", "2", "-dtype", "bfloat16",
    "-banded-tile", "256", "-scatter-impl", "add", "-context-pallas", "1",
    "-iter", "1", "-seed", "1"]
PATHS = (("quickstart", QUICKSTART, 1024),
         ("pallas", SHIPPED_ADD + ["-use-pallas", "1"], 768),
         ("hot", SHIPPED_ADD + ["-hot-rows", "2048", "-hot-pallas", "1"], 768),
         ("skipgram", QUICKSTART + ["-model", "skipgram"], 1024))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--corpus", default=".smoke_work/route_steps_corpus.txt")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("route_steps: no CUDA device is available", file=sys.stderr)
        return 1
    import word2bits_tpu_torch
    from word2bits_tpu_torch import train as T
    from word2bits_tpu_torch.config import config_from_argv
    from word2bits_tpu_torch.data.synthetic import zipf_corpus
    pkg = os.path.dirname(os.path.abspath(word2bits_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"route_steps: imported {pkg}, not {root}'s")
    dev = torch.device("cuda", 0)
    card = card_line()
    if not os.path.exists(args.corpus):
        os.makedirs(os.path.dirname(os.path.abspath(args.corpus)),
                    exist_ok=True)
        zipf_corpus(args.corpus, n_tokens=17_000_000, vocab=70_000, seed=0)
    cfg = config_from_argv(["-train", args.corpus] + QUICKSTART)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        vocab, encoded = T.prepare(cfg)
    print(f"[route_steps] {pkg}: {vocab.size} words, {encoded.size} tokens "
          f"in {time.perf_counter() - t0:.1f} s; {card}", flush=True)
    for name, flags, steps in PATHS:
        cfg = config_from_argv(flags)
        with contextlib.redirect_stdout(io.StringIO()):
            res = T.train(cfg, vocab=vocab, encoded=encoded,
                          max_steps=steps, device=dev)
        chunks = res.chunks[1:] or res.chunks
        n = sum(c[0] for c in chunks)
        sec = sum(c[2] for c in chunks)
        row = dict(path=name, root=root, steps=res.steps,
                   us_per_step=sec / n * 1e6,
                   words_per_sec=sum(c[1] for c in chunks) / sec,
                   loss=res.epoch_losses[-1], card=card)
        print(f"[route_steps] {name}: {res.steps} steps of "
              f"B={cfg.batch_size}, {row['us_per_step']:.1f} us/step, "
              f"{row['words_per_sec']:.1f} words/sec (card clock, chunks "
              f"after the first), loss {row['loss']:.4f}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
