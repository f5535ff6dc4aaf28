"""The flagship end-to-end run on the port: 3.7M words x 800 dimensions,
1-bit, on one CUDA card.

    python -m word2bits_tpu_torch.tools.flagship_run [--tokens 60000000]
        [--vocab 3700000] [--size 800] [--batch 16384] [--segment 16777216]
        [--epochs 2] [--rmw] [--host-epoch] [--threshold 50000]
        [--skip-eval] [--skip-crosscheck] [--run-dir DIR]
        [--transcript PATH] [--device cuda|cpu]

Modelled on the JAX package's tools/flagship_run.py, which stays as it is:
the reference's headline artifact (reference README.md:39, the
full-Wikipedia 3.7M-word 1-bit 800d vectors) made end to end.  The
stages:

  1. the corpus (`make_corpus`, byte-equal to the JAX tool's): the
     structured-analogy core of data/structured.py, whose analogy accuracy
     is measurable by construction, and a Zipf tail that names every one
     of the `--vocab` words at least once; built once and kept in the run
     directory;
  2. the parse and the vocabulary at -min-count 1 (the native tokenizer);
  3. leg 1: the reference LCG init of the bf16 fused table, `--epochs`
     epochs streamed in segments of `--segment` tokens (4 at the defaults)
     at the JAX tool's flags (window 5, negative 10, -alpha 0.05, -sample
     1e-4, -neg-sharing 64, -seed 1; the grmw scatter in 32-step chunks
     with the context kernel, or with --rmw the RMW scatter in one-step
     chunks), then a checkpoint;
  4. leg 2: the checkpoint resumed for one more epoch, then the binary and
     `.pack` export (kernel 4 once per row block);
  5. the analogy evaluation of the vector file over every row (the port's
     io/vectors.read_vectors and eval/analogy.evaluate_analogies, bitlevel
     0), the vectors first checked to read back as +-1/3;
  6. the JAX tool's cross-check against the reference's compute-accuracy
     at the top `--threshold` rows waits until the reference's source is
     in this repository: the tool says so and the transcript records
     `"crosscheck": {"skipped": ...}` with the threshold.

The transcript (markdown and a JSON block, flagship_transcript.py) goes to
`--transcript` (default: transcript.md in the run directory): the JAX
tool's keys (config, train, resume, artifacts, eval, crosscheck) and, in
their own fields, each stage's seconds, the training loop's words/sec on
the device's clock (CUDA events on the card; set-up excluded), the peak
device memory of each leg and of the evaluation against the table, the
host's peak RSS, and each leg's launches of the kernels on this path.
The run directory (default .bench_cache/flagship_torch/) needs about 25 GB
at the defaults: the 11.8 GB checkpoint, the 11.9 GB vector file, the
0.4 GB `.pack` and the 0.5 GB corpus.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np
import torch

from word2bits_tpu_torch import train as T
from word2bits_tpu_torch.config import Word2BitsConfig
from word2bits_tpu_torch.data.structured import structured_corpus
from word2bits_tpu_torch.eval.analogy import (evaluate_analogies,
                                              load_questions)
from word2bits_tpu_torch.io.vectors import read_vectors
from word2bits_tpu_torch.kernels.band_usum import band_usum
from word2bits_tpu_torch.kernels.context_pallas import fused_context_pallas
from word2bits_tpu_torch.kernels.group_rmw import scatter_add_grmw_planned
from word2bits_tpu_torch.kernels.quantize_pallas import quantize_pallas
from word2bits_tpu_torch.kernels.scatter_pallas import scatter_add_rmw
from word2bits_tpu_torch.kernels.span_scatter import launch_parts
from word2bits_tpu_torch.tools.flagship_transcript import (card_name,
                                                          write_transcript)

RUN = os.path.join(REPO, ".bench_cache", "flagship_torch")
NO_CROSSCHECK = ("the reference's compute-accuracy.c is not in this "
                 "repository")


def make_corpus(path, questions, n_tokens, n_vocab, seed=0):
    """Structured core + zipf tail to n_vocab distinct words (chunked IO)."""
    t0 = time.perf_counter()
    core = path + ".core"
    if not os.path.exists(core):
        # analogy-structured core scaled to ~27% of the corpus (~16M tokens
        # of signal at the 60M-token flagship scale — the text8 regime)
        n_core = min(1_200_000, max(1_000, n_tokens // 50))
        structured_corpus(core, questions, n_sentences=n_core, seed=seed)
    core_tokens = sum(len(l.split()) for l in open(core))
    n_tail_vocab = n_vocab - 600       # leave room for the core's ~541 types
    n_fill = max(n_tokens - core_tokens - n_tail_vocab, 0)
    rng = np.random.default_rng(seed + 1)
    with open(path, "w") as out:
        core_lines = open(core).readlines()
        ci = 0
        # enumerate every tail word once (min_count=1 keeps all of them),
        # zipf filler interleaved in blocks with core sentences
        enum = np.arange(n_tail_vocab, dtype=np.int64)
        rng.shuffle(enum)
        written = 0
        block = 200_000
        while written < n_tail_vocab or n_fill > 0 or ci < len(core_lines):
            if ci < len(core_lines):
                take = core_lines[ci:ci + 2000]
                out.writelines(take)
                ci += len(take)
            if written < n_tail_vocab:
                ids = enum[written:written + block]
                written += len(ids)
            elif n_fill > 0:
                take_n = min(block, n_fill)
                ids = np.minimum(rng.zipf(1.3, size=take_n) - 1,
                                 n_tail_vocab - 1)
                n_fill -= take_n
            else:
                ids = None
            if ids is not None and len(ids):
                words = np.char.add("t", ids.astype(str))
                for lo in range(0, len(words), 12):
                    out.write(" ".join(words[lo:lo + 12]) + "\n")
    print(f"corpus: {path} built in {time.perf_counter() - t0:.0f}s",
          flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=60_000_000)
    ap.add_argument("--vocab", type=int, default=3_700_000)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16384)
    # 2^24: 4 segments an epoch at 60M tokens
    ap.add_argument("--segment", type=int, default=1 << 24)
    ap.add_argument("--epochs", type=int, default=2,
                    help="leg 1's epochs; leg 2 resumes for one more")
    ap.add_argument("--threshold", type=int, default=50_000,
                    help="the cross-check's rows (recorded only: the "
                         "cross-check waits for the reference's source)")
    ap.add_argument("--rmw", action="store_true")
    ap.add_argument("--host-epoch", action="store_true")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--skip-crosscheck", action="store_true")
    ap.add_argument("--run-dir", default=RUN)
    ap.add_argument("--transcript", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run_files(args) -> dict:
    """The run directory's files."""
    d = args.run_dir
    tag = f"{args.tokens}_{args.vocab}"
    return dict(corpus=os.path.join(d, f"corpus_{tag}.txt"),
                questions=os.path.join(d, f"questions_{tag}.txt"),
                vocab=os.path.join(d, "vocab.txt"),
                out=os.path.join(d, "vectors.bin"),
                ckpt=os.path.join(d, "ckpt"))


def speed_flags(args) -> dict:
    """The JAX tool's update route: the sorted group-RMW scatter in
    32-step chunks with banded sums and the context kernel, or with --rmw
    the RMW scatter (kernel 8) in one-step chunks."""
    if args.rmw:
        return dict(rmw_scatter=True, steps_per_chunk=1)
    return dict(scatter_impl="grmw", loop_mode="fori", steps_per_chunk=32,
                banded_tile=256, context_pallas=True)


def flagship_fields(args) -> dict:
    """The Word2BitsConfig fields of both legs (the JAX tool's)."""
    f = run_files(args)
    return dict(
        train_file=f["corpus"], output_file=f["out"], binary=True,
        packed=True, bitlevel=1, size=args.size, window=5, negative=10,
        min_count=1, sample=1e-4, alpha=0.05, batch_size=args.batch,
        neg_sharing=64, fused_tables=True, dtype="bfloat16",
        **speed_flags(args), segment_tokens=args.segment,
        checkpoint_dir=f["ckpt"], save_vocab_file=f["vocab"], debug=2,
        seed=1,
        # one checkpoint a leg, after its last epoch: each is a 11.8 GB
        # write at the flagship size
        checkpoint_every_epoch=False,
        device_epoch=(False if args.host_epoch else None))


def launch_counts() -> dict:
    """The launch counters of the kernels this path can run (`row_parts`:
    kernel 7's launches that read the step's rows from their three parts,
    span_scatter.launch_parts)."""
    return {"fused_context_pallas": fused_context_pallas.launches,
            "band_usum": band_usum.launches,
            "scatter_add_grmw": scatter_add_grmw_planned.launches,
            "row_parts": launch_parts.launches,
            "scatter_add_rmw": scatter_add_rmw.launches,
            "quantize_pallas": quantize_pallas.launches}


def peak_rss() -> int:
    """This process's peak resident set so far, in bytes."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class DevicePeak:
    """Peak device memory of a block, in bytes (None off the card)."""

    def __init__(self, dev):
        self.dev, self.bytes = dev, None

    def __enter__(self) -> "DevicePeak":
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        return self

    def __exit__(self, *_) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.bytes = int(torch.cuda.max_memory_allocated(self.dev))


def run_leg(cfg, vocab, encoded, dev, table_bytes: int) -> tuple:
    """One train.train leg; returns (its TrainResult, its record)."""
    before = launch_counts()
    t0 = time.perf_counter()
    with DevicePeak(dev) as peak:
        res = T.train(cfg, vocab=vocab, encoded=encoded, device=dev)
    wall = time.perf_counter() - t0
    after = launch_counts()
    loop_s = sum(c[2] for c in res.chunks)
    rec = dict(
        wall_s=round(wall, 1), words_per_sec=round(res.words_per_sec),
        # the chunks alone, on the device's clock (CUDA events on the
        # card, the host's on the CPU): set-up, epoch builds, checkpoint
        # and export excluded
        loop_words_per_sec=round(sum(c[1] for c in res.chunks)
                                 / max(loop_s, 1e-9)),
        loop_s=round(loop_s, 3),
        loop_clock="cuda events" if dev.type == "cuda" else "host",
        epoch_losses=[round(x, 1) for x in res.epoch_losses],
        # the loss a step of the leg's first and last chunk: a resumed
        # leg starts where the leg before it ended, not at the init's
        first_chunk_loss_per_step=round(res.chunk_losses[0]
                                        / res.chunks[0][0], 3),
        last_chunk_loss_per_step=round(res.chunk_losses[-1]
                                       / res.chunks[-1][0], 3),
        start_epoch=res.start_epoch, steps=res.steps,
        seconds={k: round(v, 3) for k, v in res.seconds.items()},
        peak_device_bytes=peak.bytes,
        peak_device_x_table=(None if peak.bytes is None
                             else round(peak.bytes / table_bytes, 4)),
        peak_host_rss_bytes=peak_rss(),
        launches={k: after[k] - before[k] for k in after})
    if not all(math.isfinite(x) for x in res.epoch_losses):
        raise RuntimeError(f"epoch loss not finite: {res.epoch_losses}")
    return res, rec


def check_pm_third(vectors: np.ndarray, rows: int = 1 << 16) -> None:
    """Raise unless every value of a bitlevel-1 vector file is +-1/3."""
    third = np.float32(1.0) / np.float32(3.0)
    for r0 in range(0, vectors.shape[0], rows):
        if not np.all(np.abs(vectors[r0:r0 + rows]) == third):
            raise RuntimeError(f"vector rows {r0}.. are not all +-1/3")


def evaluate(out: str, questions: str, dev) -> dict:
    """Read the vector file back and score its analogies over every row."""
    t0 = time.perf_counter()
    words, vectors = read_vectors(out)
    read_s = time.perf_counter() - t0
    check_pm_third(vectors)
    t1 = time.perf_counter()
    with DevicePeak(dev) as peak:
        res = evaluate_analogies(words, vectors, load_questions(questions),
                                 bitlevel=0, device=dev)
    eval_s = time.perf_counter() - t1
    return dict(rows=len(words), wall_s=round(time.perf_counter() - t0, 1),
                read_s=round(read_s, 3), eval_s=round(eval_s, 3),
                values_pm_one_third=True,
                total_accuracy=round(res.total_accuracy, 2),
                coverage=round(res.coverage, 2),
                seen_questions=res.seen_questions,
                total_questions=res.total_questions,
                peak_device_bytes=peak.bytes,
                peak_host_rss_bytes=peak_rss())


def device_record(dev) -> dict:
    return dict(type=dev.type, card=card_name(str(dev)),
                torch=torch.__version__, cuda=torch.version.cuda)


def run(argv=None) -> dict:
    """The whole run; returns the transcript (also written to
    --transcript)."""
    args = parse_args(argv)
    dev = T.resolve_device(args.device)
    os.makedirs(args.run_dir, exist_ok=True)
    files = run_files(args)
    common = flagship_fields(args)
    transcript = {"config": dict(
        tokens=args.tokens, vocab=args.vocab, size=args.size,
        batch=args.batch, segment_tokens=args.segment,
        epochs=[args.epochs, args.epochs + 1], speed_flags=speed_flags(args),
        device_epoch="host" if args.host_epoch else "auto")}
    transcript["device"] = device_record(dev)
    print(f"device: {transcript['device']['card']}", flush=True)

    stages = transcript["corpus"] = {}
    t0 = time.perf_counter()
    if os.path.exists(files["corpus"]):
        stages["build_s"] = None     # built by an earlier run
    else:
        make_corpus(files["corpus"], files["questions"], args.tokens,
                    args.vocab)
        stages["build_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    base = Word2BitsConfig(**common)
    vocab, encoded = T.prepare(base)
    stages.update(parse_vocab_s=round(time.perf_counter() - t0, 3),
                  bytes=os.path.getsize(files["corpus"]),
                  encoded_tokens=int(len(encoded)), vocab_size=vocab.size,
                  peak_host_rss_bytes=peak_rss())
    seg_tokens, _ = T.segment_capacity(base, len(encoded))
    transcript["config"]["segments_per_epoch"] = -(-len(encoded)
                                                   // seg_tokens)
    table_bytes = vocab.size * 2 * args.size * 2     # bf16 (V, 2D)
    transcript["config"]["table_bytes"] = table_bytes

    # leg 1 trains and checkpoints without the export (leg 2 writes it)
    cfg = Word2BitsConfig(iter=args.epochs, **dict(common, output_file=None))
    res, rec = run_leg(cfg, vocab, encoded, dev, table_bytes)
    transcript["train"] = dict(epochs=args.epochs, vocab_size=vocab.size,
                               **rec)
    print(json.dumps(transcript["train"]), flush=True)
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # leg 2: the checkpoint resumed for one more epoch, then the export
    cfg = Word2BitsConfig(iter=args.epochs + 1, resume=True, **common)
    res, rec = run_leg(cfg, vocab, encoded, dev, table_bytes)
    if res.start_epoch != args.epochs or len(res.epoch_losses) != 1:
        raise RuntimeError(f"the resumed leg started at epoch "
                           f"{res.start_epoch} and trained "
                           f"{len(res.epoch_losses)} epochs")
    transcript["resume"] = dict(extra_epochs=1, **rec)
    print(json.dumps(transcript["resume"]), flush=True)
    del res, encoded
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    transcript["artifacts"] = {
        os.path.basename(p): os.path.getsize(p)
        for p in (files["out"], files["out"] + ".pack",
                  os.path.join(files["ckpt"], T.CHECKPOINT_FILE))
        if os.path.exists(p)}

    questions = files["questions"]
    if not args.skip_eval:
        transcript["eval"] = evaluate(files["out"], questions, dev)
        print(json.dumps(transcript["eval"]), flush=True)
        why = "--skip-crosscheck" if args.skip_crosscheck else NO_CROSSCHECK
        transcript["crosscheck"] = dict(skipped=why, threshold=args.threshold)
        print(f"crosscheck skipped: {why}", flush=True)
    transcript["peak_host_rss_bytes"] = peak_rss()

    md = write_transcript(
        transcript, args.transcript or os.path.join(args.run_dir,
                                                    "transcript.md"),
        args.tokens, args.vocab, args.size,
        "word2bits_tpu_torch/tools/flagship_run.py")
    print(f"wrote {md}", flush=True)
    return transcript


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
