"""Command-line entry points mirroring the reference `word2bits` trainer
and `compute-accuracy` evaluator (same flag spellings and defaults,
reference src/word2bits.cpp:591-621 and src/compute-accuracy.c:73-79):

    python -m word2bits_tpu_torch.cli train -train text8 -output vec.bin \\
        -size 200 -window 8 -negative 24 -iter 5 -min-count 5 -bitlevel 1 \\
        -binary 1
    python -m word2bits_tpu_torch.cli accuracy vec.bin 0 30000 \\
        -questions questions-words.txt

    python -m word2bits_tpu_torch.cli convert vec.bin vec.pack \\
        -bitlevel 1 -packed 1
    python -m word2bits_tpu_torch.cli nearest vec.bin king queen -topk 5
    python -m word2bits_tpu_torch.cli tune -train text8 -size 200 \
        -tune-seconds 4 -json 1

The JAX package's extensions `convert` (re-quantize, re-format, bit-pack
a vector file), `nearest` (cosine neighbours) and `tune` (measure the
step variants on the user's corpus, tune.py) have the same usage,
messages and output.  All five run on the CUDA device; W2B_FORCE_CPU=1
runs them on the CPU instead.  They read binary, text or gzip'd text
vector files and `.pack` files.
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
              "-device-epoch 0|1]\n"
              "Model: [-model cbow|skipgram|fasttext|fasttext-cbow "
              "(-cbow 1|0) -neg-per-pair 0|1 (skip-gram: K negatives for "
              "each context pair); fasttext (subword skip-gram, K negatives "
              "a pair) and fasttext-cbow (subword CBOW with position "
              "weights, K negatives a center): -minn 3 -maxn 6 -bucket "
              "2000000]\n"
              "Checkpoints: [-checkpoint-dir DIR -resume 0|1 "
              "-checkpoint-every-epoch 0|1] Trace: [-profile-dir DIR]\n"
              "Subcommands: train (default) | accuracy FILE [bitlevel "
              "threshold] [-questions FILE] | convert IN OUT | nearest FILE "
              "[words...] | tune -train FILE [flags...] [-tune-seconds S] "
              "[-tune-max-variants N] [-json 1]")
        return 0
    from word2bits_tpu_torch.train import prepare, train

    if os.environ.get("RANK", "0") == "0":      # a mesh's rank 0 speaks
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


def convert_main(argv=None) -> int:
    """Post-training vector-file converter (the JAX package's extension).

    Usage: convert IN OUT [-bitlevel B] [-binary 0|1] [-packed 1]
                          [-threshold N]

    Reads text, binary, gzip'd text or `.pack` files, optionally
    re-quantizes the rows at -bitlevel (as the reference evaluator does at
    load, reference src/compute-accuracy.c:106), and writes text (-binary
    0, default), binary (-binary 1) or bit-packed (-packed 1, 1- and 2-bit
    grids only) vectors; -threshold keeps the first N rows.  Byte-identical
    to the JAX package's `convert`.  The rows go to the device in blocks of
    about 16M values: re-quantized there by kernel 4
    (kernels/quantize_pallas.py), packed there, and written block by block;
    a `.pack` source is read in the same blocks, other sources whole.
    """
    argv = sys.argv[1:] if argv is None else argv
    pos, flags = [], {}
    i = 0
    while i < len(argv):
        if argv[i].startswith("-") and not argv[i][1:].isdigit():
            if i + 1 >= len(argv):
                print(f"missing value for {argv[i]}", file=sys.stderr)
                return 1
            flags[argv[i]] = argv[i + 1]
            i += 2
        else:
            pos.append(argv[i])
            i += 1
    if len(pos) != 2:
        print("Usage: convert IN OUT [-bitlevel B] [-binary 0|1] "
              "[-packed 1] [-threshold N]")
        return 0 if not pos else 1
    src, dst = pos
    bitlevel = int(flags.get("-bitlevel", 0))
    binary = bool(int(flags.get("-binary", 0)))
    packed = bool(int(flags.get("-packed", 0)))
    threshold = int(flags.get("-threshold", 0))

    import torch

    from word2bits_tpu_torch import train
    from word2bits_tpu_torch.io.packed import (MAGIC, PackedWriter,
                                               pack_codes, read_packed,
                                               read_packed_header)
    from word2bits_tpu_torch.io.vectors import VectorWriter, read_vectors
    from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas

    dev = train.resolve_device(_device())
    with open(src, "rb") as f:
        is_packed = f.read(len(MAGIC)) == MAGIC
    if is_packed:
        header = read_packed_header(src)
        words, size, src_bitlevel = header.words, header.size, header.bitlevel

        def block(r0, r1):
            return read_packed(src, max_words=r1 - r0, first_row=r0,
                               header=header)[1]
    else:
        words, vectors = read_vectors(src, max_words=threshold)
        size, src_bitlevel = vectors.shape[1], 0

        def block(r0, r1):
            return vectors[r0:r1]
    if threshold:
        words = words[:threshold]
    out_bitlevel = bitlevel or src_bitlevel
    if packed and out_bitlevel not in (1, 2):
        print(f"-packed needs vectors on a 1- or 2-bit grid; pass "
              f"-bitlevel 1|2 (got bitlevel {out_bitlevel})",
              file=sys.stderr)
        return 1
    rows = max(1, train._EXPORT_VALUES // max(size, 1))
    with (PackedWriter(dst, words, size, out_bitlevel) if packed
          else VectorWriter(dst, len(words), size, binary=binary)) as w:
        for r0 in range(0, len(words), rows):
            r1 = min(len(words), r0 + rows)
            x = torch.from_numpy(block(r0, r1)).to(dev)
            if bitlevel:
                x = quantize_pallas(x, bitlevel)
            if packed:
                w.write_payload(pack_codes(x, out_bitlevel).cpu().numpy())
            else:
                w.write_rows(words[r0:r1], x.cpu().numpy())
    print(f"{len(words)} x {size} -> {dst} ({os.path.getsize(dst)} bytes)")
    return 0


def nearest_main(argv=None) -> int:
    """Nearest-neighbour queries (the JAX package's extension, after
    word2vec's `distance` tool).

    Usage: nearest FILE [words...] [-topk N] [-bitlevel B]

    Prints the top-N cosine neighbours of each query word (looked up in
    upper case, as the evaluator does); with no words, reads queries from
    stdin (one per line, EXIT quits).  -bitlevel re-quantizes the rows at
    load, by kernel 4 (kernels/quantize_pallas.py); the rows are normalized
    and scored on the device, in float32 (no TF32).  The transcript is the
    JAX package's, apart from the order of neighbours whose similarities
    tie within float32 rounding.
    """
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: nearest FILE [words...] [-topk N] [-bitlevel B]")
        return 0
    topk, bitlevel = 10, 0
    if "-topk" in argv:
        i = argv.index("-topk")
        topk = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if "-bitlevel" in argv:
        i = argv.index("-bitlevel")
        bitlevel = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    path, queries = argv[0], argv[1:]

    import torch

    from word2bits_tpu_torch.io.packed import MAGIC, read_packed
    from word2bits_tpu_torch.io.vectors import read_vectors
    from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas
    from word2bits_tpu_torch.train import resolve_device

    dev = resolve_device(_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(path, "rb") as f:
        is_packed = f.read(len(MAGIC)) == MAGIC
    if is_packed:
        words, vectors, _ = read_packed(path)
    else:
        words, vectors = read_vectors(path)
    x = torch.from_numpy(vectors).to(dev)
    if bitlevel:
        x = quantize_pallas(x, bitlevel)
    m = x / torch.linalg.vector_norm(x, dim=1).clamp_min(1e-12)[:, None]
    # evaluator-style uppercase lookup (reference src/compute-accuracy.c:104)
    index = {}
    for i, w in enumerate(words):
        index.setdefault(w.upper(), i)
    k = min(topk, len(words))

    def show(q: str) -> None:
        i = index.get(q.upper())
        if i is None:
            print(f"{q}: not in vocabulary")
            return
        sims = m @ m[i]
        sims[i] = -float("inf")
        vals, top = torch.topk(sims, k)
        print(f"{q}:")
        for j, s in zip(top.tolist(), vals.tolist()):
            print(f"  {words[j]:<24s} {s:.6f}")

    if queries:
        for q in queries:
            show(q)
        return 0
    for line in sys.stdin:
        q = line.strip()
        if not q or q == "EXIT":
            break
        show(q)
    return 0


def tune_main(argv=None) -> int:
    """Throughput auto-tuner (the JAX package's extension; tune.py).

    Usage: tune -train FILE [reference/extension flags...]
                [-tune-seconds S] [-tune-max-variants N] [-json 1]

    Measures the quality-safe step variants (fused/pooled negatives,
    hot/cold scatter split, dense-hot negatives, banded windowed sums,
    the span scatter and the context kernel, bf16) on YOUR corpus and
    device for a few seconds each and prints the flags worth adding to
    the train command.
    """
    argv = list(sys.argv[1:] if argv is None else argv)

    def take(flag, parse, default):
        if flag not in argv:
            return default
        i = argv.index(flag)
        if i + 1 >= len(argv):
            sys.exit(f"Argument missing for {flag}")
        try:
            val = parse(argv[i + 1])
        except ValueError:
            sys.exit(f"Bad value for {flag}: {argv[i + 1]!r}")
        del argv[i:i + 2]
        return val

    seconds = take("-tune-seconds", float, 4.0)
    as_json = bool(take("-json", int, 0))
    max_variants = take("-tune-max-variants", int, 0) or None
    cfg = config_from_argv(argv)
    if cfg.train_file is None:
        print("Usage: tune -train FILE [flags...] [-tune-seconds S] "
              "[-tune-max-variants N] [-json 1]")
        return 0
    from word2bits_tpu_torch.tune import run_tune
    return run_tune(cfg, seconds=seconds, as_json=as_json,
                    max_variants=max_variants, device=_device())


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "train":
        return train_main(args[1:])
    if args and args[0] in ("accuracy", "compute-accuracy"):
        return accuracy_main(args[1:])
    if args and args[0] == "convert":
        return convert_main(args[1:])
    if args and args[0] in ("nearest", "distance"):
        return nearest_main(args[1:])
    if args and args[0] == "tune":
        return tune_main(args[1:])
    return train_main(args)


if __name__ == "__main__":
    sys.exit(main())
