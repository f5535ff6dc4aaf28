"""Complete a flagship run from its final checkpoint: the export and the
evaluation, without retraining.

    python -m word2bits_tpu_torch.tools.flagship_complete [--tokens N]
        [--vocab N] [--size D] [--run-dir DIR] [--transcript PATH]
        [--device cuda|cpu] [--skip-eval] [--train-json JSON]
        [--resume-json JSON]

Modelled on the JAX package's tools/flagship_complete.py, which stays as
it is: it replays the tail of flagship_run.py (the binary and `.pack`
export of the checkpointed table through kernel 4, then the analogy
evaluation over every row) from the run directory's ckpt/state.npz and
vocab.txt (or, without the latter, the vocabulary rebuilt from the
corpus), and writes a transcript that carries over the training legs'
figures given as JSON with --train-json and --resume-json.  The sizes name
the run's files and must be the run's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch

from word2bits_tpu_torch import train as T
from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.data.corpus import build_vocab
from word2bits_tpu_torch.data.vocab import Vocab
from word2bits_tpu_torch.tools import flagship_run as FR
from word2bits_tpu_torch.tools.flagship_transcript import \
    write_transcript


def run(argv=None) -> dict:
    """The export and evaluation; returns the transcript (also written to
    --transcript)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=60_000_000)
    ap.add_argument("--vocab", type=int, default=3_700_000)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--run-dir", default=FR.RUN)
    ap.add_argument("--transcript", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--train-json", default=None)
    ap.add_argument("--resume-json", default=None)
    args = ap.parse_args(argv)
    dev = T.resolve_device(args.device)
    run_args = FR.parse_args(["--tokens", str(args.tokens), "--vocab",
                              str(args.vocab), "--size", str(args.size),
                              "--run-dir", args.run_dir])
    files = FR.run_files(run_args)
    cfg = Word2BitsConfig(**FR.flagship_fields(run_args))

    transcript = {"config": dict(tokens=args.tokens, vocab=args.vocab,
                                 size=args.size, bitlevel=cfg.bitlevel)}
    transcript["device"] = FR.device_record(dev)
    for key, blob in (("train", args.train_json),
                      ("resume", args.resume_json)):
        if blob:
            transcript[key] = json.loads(blob)

    t0 = time.perf_counter()
    if os.path.exists(files["vocab"]):
        vocab = Vocab.load(files["vocab"], min_count=cfg.min_count)
    else:
        vocab = build_vocab(files["corpus"], min_count=cfg.min_count)
        vocab.save(files["vocab"])
    print(f"vocab: {vocab.size} words in {time.perf_counter() - t0:.1f} s",
          flush=True)

    ckpt = os.path.join(files["ckpt"], T.CHECKPOINT_FILE)
    t0 = time.perf_counter()
    ck = T.load_checkpoint(ckpt, cfg, dev)
    if ck.vocab_rows != vocab.size:
        raise ValueError(f"{ckpt} holds {ck.vocab_rows} rows, the "
                         f"vocabulary {vocab.size}")
    load_s = time.perf_counter() - t0
    print(f"checkpoint of epoch {ck.epoch} loaded in {load_s:.1f} s",
          flush=True)
    before = FR.launch_counts()
    t0 = time.perf_counter()
    T.write_output(files["out"], vocab, ck.tables, cfg)
    export_s = time.perf_counter() - t0
    after = FR.launch_counts()
    del ck
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sizes = {os.path.basename(p): os.path.getsize(p)
             for p in (files["out"], files["out"] + ".pack")
             if os.path.exists(p)}
    transcript["artifacts"] = dict(
        sizes, checkpoint_load_s=round(load_s, 3),
        export_s=round(export_s, 3),
        launches={k: after[k] - before[k] for k in after})
    print(json.dumps(transcript["artifacts"]), flush=True)

    if not args.skip_eval:
        transcript["eval"] = FR.evaluate(files["out"], files["questions"],
                                         dev)
        print(json.dumps(transcript["eval"]), flush=True)
    transcript["peak_host_rss_bytes"] = FR.peak_rss()

    md = write_transcript(
        transcript, args.transcript or os.path.join(
            args.run_dir, "transcript_complete.md"),
        args.tokens, vocab.size, args.size,
        "word2bits_tpu_torch/tools/flagship_run.py + "
        "word2bits_tpu_torch/tools/flagship_complete.py",
        provenance=("The training legs ran through flagship_run.py; the "
                    "export and the evaluation were replayed from its "
                    "final checkpoint by flagship_complete.py, nothing "
                    "retrained.  The train and resume figures are carried "
                    "over as given."))
    print(f"wrote {md}", flush=True)
    return transcript


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
