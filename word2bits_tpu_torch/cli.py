"""Command-line entry points mirroring the reference `word2bits` trainer
and `compute-accuracy` evaluator (same flag spellings and defaults,
reference src/word2bits.cpp:591-621 and src/compute-accuracy.c:73-79):

    python -m word2bits_tpu_torch.cli train -train text8 -output vec.bin \\
        -size 200 -window 8 -negative 24 -iter 5 -min-count 5 -bitlevel 1 \\
        -binary 1
    python -m word2bits_tpu_torch.cli accuracy vec.bin 0 30000 \\
        -questions questions-words.txt

Both run on the CUDA device; W2B_FORCE_CPU=1 runs them on the CPU instead.
`accuracy` reads binary or text vector files and `.pack` files.  The other
subcommands of the JAX package (convert, nearest, tune) are not ported.
"""

from __future__ import annotations

import os
import sys

from word2bits_tpu_torch.config import config_from_argv


def _device() -> str:
    """W2B_FORCE_CPU=1 selects the CPU; otherwise cuda (or an error)."""
    return "cpu" if os.environ.get("W2B_FORCE_CPU") else "cuda"


def train_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = config_from_argv(argv)
    if cfg.train_file is None:
        print("word2bits_tpu_torch trainer\n"
              "Required: -train <file>. Optional flags (reference-compatible):\n"
              "  -output -bitlevel -size -window -negative -alpha -sample\n"
              "  -min-count -iter -reg -binary -debug -save-every-epoch\n"
              "  -save-vocab -read-vocab -classes -threads\n"
              "Engine: [-fused-tables 0|1 -neg-sharing G -neg-pool P "
              "-banded-tile N -scatter-impl add|span|grmw -context-pallas 0|1 "
              "-use-pallas 0|1 -dtype float32|bfloat16 -batch-size "
              "-steps-per-chunk -loop-mode scan|fori|unroll -packed 0|1 "
              "-seed]\n"
              "Update routes: [-rmw-scatter 0|1 -dedup-block M -hot-rows H "
              "-hot-pallas 0|1 -neg-stratify 0|1 -neg-dense-hot 0|1 "
              "-device-epoch 0]\n"
              "Subcommands: train (default) | accuracy FILE [bitlevel "
              "threshold] [-questions FILE]")
        return 0
    from word2bits_tpu_torch.train import prepare, train

    print(f"Starting training using file {cfg.train_file}")
    if not cfg.output_file:
        # reference: vocab build (and optional -save-vocab) only
        prepare(cfg)
        return 0
    train(cfg, device=_device())
    return 0


def accuracy_main(argv=None) -> int:
    """accuracy <FILE> <bitlevel> <threshold> [-questions FILE]: the
    reference evaluator's transcript (questions on stdin without
    -questions)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("Usage: compute-accuracy <FILE> <bitlevel> <threshold> "
              "[-questions FILE]\nwhere FILE contains word projections "
              "(questions on stdin unless -questions is given)")
        return 0
    questions_path = None
    if "-questions" in argv:
        i = argv.index("-questions")
        questions_path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    path = argv[0]
    bitlevel = int(argv[1]) if len(argv) > 1 else 0
    threshold = int(argv[2]) if len(argv) > 2 else 0

    from word2bits_tpu_torch.eval.analogy import (
        evaluate_analogies, format_report, load_questions, parse_questions)
    from word2bits_tpu_torch.io.packed import MAGIC, read_packed
    from word2bits_tpu_torch.io.vectors import read_vectors

    with open(path, "rb") as f:
        is_packed = f.read(len(MAGIC)) == MAGIC
    if is_packed:
        words, vectors, _ = read_packed(path, max_words=threshold)
    else:
        words, vectors = read_vectors(path, max_words=threshold)
    print("Starting eval...", flush=True)
    questions = (load_questions(questions_path) if questions_path
                 else parse_questions(sys.stdin))
    result = evaluate_analogies(words, vectors, questions, bitlevel=bitlevel,
                                threshold=threshold, device=_device())
    print(format_report(result))
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "train":
        return train_main(args[1:])
    if args and args[0] in ("accuracy", "compute-accuracy"):
        return accuracy_main(args[1:])
    if args and args[0] in ("convert", "nearest", "tune"):
        raise SystemExit(f"the {args[0]!r} subcommand is not implemented by "
                         "word2bits_tpu_torch yet")
    return train_main(args)


if __name__ == "__main__":
    sys.exit(main())
