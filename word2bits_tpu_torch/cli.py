"""Command-line entry point mirroring the reference `word2bits` trainer
(same flag spellings and defaults, reference src/word2bits.cpp:591-621):

    python -m word2bits_tpu_torch.cli train -train text8 -output vec.bin \\
        -size 200 -window 8 -negative 24 -iter 5 -min-count 5 -bitlevel 1 \\
        -binary 1 -fused-tables 1 -neg-sharing 64 -banded-tile 256

It trains on the CUDA device; W2B_FORCE_CPU=1 trains on the CPU instead.
Only the `train` subcommand is ported so far (accuracy, convert, nearest
and tune are not).
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
              "Engine: -fused-tables 1 -neg-sharing G -banded-tile N "
              "[-neg-pool P -scatter-impl add|span -context-pallas 0|1 "
              "-dtype float32|bfloat16 -batch-size -steps-per-chunk -seed]")
        return 0
    from word2bits_tpu_torch.train import prepare, train

    print(f"Starting training using file {cfg.train_file}")
    if not cfg.output_file:
        # reference: vocab build (and optional -save-vocab) only
        prepare(cfg)
        return 0
    train(cfg, device=_device())
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "train":
        return train_main(args[1:])
    if args and args[0] in ("accuracy", "compute-accuracy", "convert",
                            "nearest", "tune"):
        raise SystemExit(f"the {args[0]!r} subcommand is not implemented by "
                         "word2bits_tpu_torch yet")
    return train_main(args)


if __name__ == "__main__":
    sys.exit(main())
